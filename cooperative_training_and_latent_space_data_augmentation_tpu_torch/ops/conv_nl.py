"""The large-channel SAME 3x3 convolution (kernel K5) and its gradients (K5
on flipped weights for dx, kernel K5dw for dw), the 64..256-channel convs
of the encoders' last two stages and the decoders' first under
``conv_nl=True``.

Counterpart of ``cooperative_training_and_latent_space_data_augmentation_tpu/
ops/pallas_conv.py``'s NL-sublanes section: ``conv3x3_nl`` (K5),
``_conv3x3_nl_dw`` (K5dw), the custom VJP ``conv3x3_nl_ad`` around them and
the channel rule ``_eligible_channels_nl``.  The TPU kernel is channels-last
because channels fill the TPU's 128 lanes: it runs (M, 9*C_in) @ (9*C_in,
C_out) over M = chunk*H*W flattened pixels, with the tap matrix built from
rolled, edge-masked copies of (M, C_in).  The port keeps NCHW: every function
here takes the (N, C, H*W) view of the activation, as K1 does, and the CUDA
kernel reads that layout straight into its shared-memory tiles, so there is
no transpose around the call.  The chunking of the batch (a VMEM budget) has
no counterpart either; it does not change the function.  The
``custom_partitioning`` wrappers have none (multi-device runs are data
parallel).

Each kernel has a wrapper that on a CUDA tensor launches the kernel (or
raises) and adds one to its ``launches`` count, and on a CPU tensor runs the
same function written in plain PyTorch (the CPU tests' path and the
reference the kernel is held against on the card):

* :func:`conv3x3_nl` (K5, ``csrc/conv3x3_nl.cu``), plain
  :func:`conv3x3_nl_plain`;
* :func:`conv3x3_nl_dx`: K5 on dy with the flipped wall, counted apart
  from the forward; the kernel reads the flipped wall out of the unflipped
  one (``flip = 1``), the plain version takes :func:`..conv_chw.flip_wall`;
* :func:`conv3x3_nl_dw` (K5dw, ``csrc/conv3x3_nl.cu``), plain
  :func:`conv3x3_nl_dw_plain`.

Weights are in K1's wall form (C_out, 9*C_in), tap-major
(``conv_chw.weights_to_wall``); K5dw returns the transposed wall (9*C_in,
C_out) in float32, as K2 does.
"""

from __future__ import annotations

import ctypes

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels

NL_MIN_CH = 64   # both sides at least this many channels
NL_LANE = 128    # at least one side this many
NL_MAX_CH = 256  # the JAX package's default PALLAS_CONV_NL_MAX_CH


def eligible_channels_nl(c_in: int, c_out: int) -> bool:
    """The JAX package's ``_eligible_channels_nl`` at its default cutoff:
    min(C) >= 64, max(C) >= 128 and max(C) <= 256."""
    return min(c_in, c_out) >= NL_MIN_CH and NL_LANE <= max(c_in, c_out) <= NL_MAX_CH


def tap_matrix(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The TPU kernel's tap matrix P (M, 9*C_in) in float32 from x (N, C_in,
    H*W), M = N*H*W batch-major: column ``t*C_in + i`` holds channel i
    rolled by the tap's flat offset ``(ki-1)*W + (kj-1)`` and zeroed where
    the tap leaves the image (``_build_p_nl``'s masks on the image-local
    pixel index; they also kill every read a roll drags in from a
    neighbouring image)."""
    n, c, L = x.shape
    flat = x.float().permute(0, 2, 1).reshape(n * L, c)
    p = torch.arange(n * L, device=x.device) % L
    col = p % W
    parts = []
    for t in range(9):
        ki, kj = divmod(t, 3)
        shifted = torch.roll(flat, -((ki - 1) * W + (kj - 1)), 0)
        valid = torch.ones_like(p, dtype=torch.bool)
        if ki == 0:
            valid &= p >= W
        elif ki == 2:
            valid &= p < (H - 1) * W
        if kj == 0:
            valid &= col != 0
        elif kj == 2:
            valid &= col != W - 1
        parts.append(torch.where(valid[:, None], shifted, 0.0))
    return torch.cat(parts, dim=1)


def conv3x3_nl_plain(x: torch.Tensor, w_all: torch.Tensor, H: int,
                     W: int) -> torch.Tensor:
    """K5's function in plain PyTorch: the tap matrix P (M, 9*C_in), one f32
    product with the wall, a cast back to the input dtype, returned as
    (N, C_out, H*W)."""
    n, _, L = x.shape
    out = torch.matmul(tap_matrix(x, H, W), w_all.float().t())  # (M, C_out)
    return out.reshape(n, L, -1).permute(0, 2, 1).contiguous().to(x.dtype)


def conv3x3_nl_dw_plain(x: torch.Tensor, dy: torch.Tensor, H: int,
                        W: int) -> torch.Tensor:
    """K5dw's function in plain PyTorch: P^T @ dY in float32 over all M
    rows (the TPU kernel sums P_chunk^T @ dY_chunk over its chunk grid) ->
    (9*C_in, C_out), row ``t*C_in + i``, column ``o``."""
    n, c_out, L = dy.shape
    dyf = dy.float().permute(0, 2, 1).reshape(n * L, c_out)
    return torch.matmul(tap_matrix(x, H, W).t(), dyf)


def _check(name: str, H: int, W: int, *tensors: torch.Tensor):
    """``kernels.check_operands``; H, W >= 1."""
    kernels.check_operands(name, *tensors)
    if H < 1 or W < 1:
        raise ValueError(f"{name}: needs H, W >= 1, got {H}x{W}")


def _check_map(name: str, t: torch.Tensor, H: int, W: int, what: str):
    if t.dim() != 3 or t.shape[2] != H * W or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name}: {what} {tuple(t.shape)} is not (N, C, {H}*{W})")


def _check_conv(name: str, x: torch.Tensor, w_all: torch.Tensor, H: int, W: int,
                flip: bool = False) -> int:
    """x (N, C_in, H*W) and w_all (C_out, 9*C_in), or with ``flip`` the
    forward's wall (C_in, 9*C_out) of the conv whose input gradient this
    is, with channels that pass the NL rule.  Returns C_out."""
    _check(name, H, W, x, w_all)
    _check_map(name, x, H, W, "x")
    c_in = x.shape[1]
    if flip:
        ok = w_all.dim() == 2 and w_all.shape[0] == c_in and w_all.shape[1] % 9 == 0
        c_out = w_all.shape[1] // 9 if ok else 0
        want = f"({c_in}, 9*C_out)"
    else:
        ok = w_all.dim() == 2 and w_all.shape[1] == 9 * c_in
        c_out = w_all.shape[0] if ok else 0
        want = f"(C_out, {9 * c_in})"
    if not ok:
        raise ValueError(f"{name}: w_all {tuple(w_all.shape)} is not {want}")
    if not eligible_channels_nl(c_in, c_out):
        raise ValueError(f"{name}: {c_in} -> {c_out} channels fail the NL rule "
                         f"(min >= {NL_MIN_CH}, {NL_LANE} <= max <= {NL_MAX_CH})")
    return c_out


_SIGNATURES = {  # C function -> argtypes; pointers and the stream as c_void_p
    "conv3x3_nl": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "conv3x3_nl_dw": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "conv3x3_nl_dw_workspace": [ctypes.c_int] * 5,
}


def _fn(name: str):
    return kernels.function("conv3x3_nl", name, _SIGNATURES[name])


def _launch(name: str, what: str, ref: torch.Tensor, *args) -> None:
    kernels.launch("conv3x3_nl", name, _SIGNATURES[name], what, ref, *args,
                   int(ref.dtype == torch.bfloat16))


def _launch_k5(x: torch.Tensor, w_all: torch.Tensor, c_out: int, H: int, W: int,
               flip: bool) -> torch.Tensor:
    n, c_in, L = x.shape
    out = torch.empty((n, c_out, L), dtype=x.dtype, device=x.device)
    _launch("conv3x3_nl", f"x {tuple(x.shape)}, C_out {c_out}, flip {int(flip)}", x,
            x.data_ptr(), w_all.data_ptr(), out.data_ptr(), n, c_in, c_out, H, W, int(flip))
    return out


def conv3x3_nl(x: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """SAME stride-1 3x3 conv with large channels: x (N, C_in, H*W), w_all
    (C_out, 9*C_in) in x's dtype (float32 or bfloat16), channels that pass
    :func:`eligible_channels_nl` -> (N, C_out, H*W) in x's dtype,
    accumulated in float32.

    On a CUDA tensor this launches K5 and adds one to
    ``conv3x3_nl.launches``; on a CPU tensor it runs the plain version."""
    c_out = _check_conv("conv3x3_nl", x, w_all, H, W)
    if x.device.type == "cpu":
        return conv3x3_nl_plain(x, w_all, H, W)
    out = _launch_k5(x, w_all, c_out, H, W, flip=False)
    conv3x3_nl.launches += 1
    return out


conv3x3_nl.launches = 0


def conv3x3_nl_dx(dy: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Input gradient of :func:`conv3x3_nl`: dy (N, C_out, H*W), w_all
    (C_out, 9*C_in) -> dx (N, C_in, H*W) in dy's dtype: K5 on the flipped,
    transposed wall (the JAX package's ``_nl_fwd_dispatch(dy,
    _flip_w(w))``), whose C_out -> C_in passes the NL rule too.

    On a CUDA tensor this launches K5 with ``flip = 1``, which reads the
    flipped wall's element (i, t*C_out + o) from ``w_all[o, (8-t)*C_in + i]``
    (no flipped copy is made), and adds one to ``conv3x3_nl_dx.launches``
    (not to the forward's count); on a CPU tensor it runs
    :func:`conv3x3_nl_plain` on :func:`..conv_chw.flip_wall`."""
    c_in = _check_conv("conv3x3_nl_dx", dy, w_all, H, W, flip=True)
    if dy.device.type == "cpu":
        from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
            flip_wall,
        )

        return conv3x3_nl_plain(dy, flip_wall(w_all).contiguous(), H, W)
    out = _launch_k5(dy, w_all, c_in, H, W, flip=True)
    conv3x3_nl_dx.launches += 1
    return out


conv3x3_nl_dx.launches = 0


def conv3x3_nl_dw(x: torch.Tensor, dy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Weight gradient of :func:`conv3x3_nl`: x (N, C_in, H*W), dy (N, C_out,
    H*W), both float32 or both bfloat16 -> (9*C_in, C_out) float32, summed
    over all N*H*W pixels in a fixed order (no float atomics), so two runs
    on the same inputs agree bit for bit.

    On a CUDA tensor this launches K5dw and adds one to
    ``conv3x3_nl_dw.launches``; on a CPU tensor it runs the plain
    version."""
    _check("conv3x3_nl_dw", H, W, x, dy)
    _check_map("conv3x3_nl_dw", x, H, W, "x")
    _check_map("conv3x3_nl_dw", dy, H, W, "dy")
    if dy.shape[0] != x.shape[0] or not eligible_channels_nl(x.shape[1], dy.shape[1]):
        raise ValueError(f"conv3x3_nl_dw: x {tuple(x.shape)} and dy {tuple(dy.shape)} need "
                         f"one batch and channels that pass the NL rule")
    if x.device.type == "cpu":
        return conv3x3_nl_dw_plain(x, dy, H, W)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_nl_dw: no kernel for device {x.device}")
    n, c_in, _ = x.shape
    c_out = dy.shape[1]
    work = torch.empty(_fn("conv3x3_nl_dw_workspace")(n, c_in, c_out, H, W),
                       dtype=torch.float32, device=x.device)
    out = torch.empty((9 * c_in, c_out), dtype=torch.float32, device=x.device)
    _launch("conv3x3_nl_dw", f"x {tuple(x.shape)}, dy {tuple(dy.shape)}", x, x.data_ptr(),
            dy.data_ptr(), work.data_ptr(), out.data_ptr(), n, c_in, c_out, H, W)
    conv3x3_nl_dw.launches += 1
    return out


conv3x3_nl_dw.launches = 0


class _ConvK5(torch.autograd.Function):
    """K5 with its gradients, the JAX package's ``conv3x3_nl_ad``
    (``_nl_ad_bwd``): dx is K5 on the flipped wall (only where x needs a
    gradient), in dy's dtype, rounded once from f32; dw is K5dw, rounded
    to the weight's compute dtype (``dw.astype(w.dtype)``)."""

    @staticmethod
    def forward(ctx, x, w_all, H, W):
        ctx.save_for_backward(x, w_all)
        ctx.hw = (H, W)
        return conv3x3_nl(x, w_all, H, W)

    @staticmethod
    def backward(ctx, dy):
        x, w_all = ctx.saved_tensors
        H, W = ctx.hw
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_nl_dx(dy, w_all, H, W)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_nl_dw(x, dy, H, W).t().to(w_all.dtype)
        return dx, dw, None, None


def conv3x3_nl_ad(x: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Differentiable :func:`conv3x3_nl`: the gradient of w_all comes back
    in the wall layout (C_out, 9*C_in); autograd maps it through
    ``weights_to_wall`` to the OIHW weight."""
    return _ConvK5.apply(x, w_all, H, W)
