"""The stride-2 pad-1 3x3 convolution (kernel K4) and its gradients
(kernels K4dx and K4dw), the downsample of the encoders under
``conv_s2=True``.

Counterpart of ``cooperative_training_and_latent_space_data_augmentation_tpu/
ops/pallas_conv.py``'s stride-2 section: ``conv3x3s2_phase`` (K4),
``_conv3x3s2_phase_dx`` (K4dx), ``_conv3x3s2_phase_dw`` (K4dw) and the
custom VJP ``conv3x3s2_phase_ad`` around them.  The JAX package splits the
(N, C, H*W) input into its four parity phases first (``chw_phase_split``),
a relayout that replaced an NHWC transpose on the TPU.  In NCHW there is no
transpose to replace and the split would cost one more pass over the
activation, so here every function takes the (N, C_in, H*W) view of the
NCHW input itself and reads it with stride-2 indexing: ``conv3x3s2(x)``
is JAX's ``conv3x3s2_phase(chw_phase_split(x))``, and ``conv3x3s2_dx(dy)``
is ``chw_phase_merge(_conv3x3s2_phase_dx(dy))``.  The ``custom_partitioning``
wrappers have no counterpart (multi-device runs are data parallel).

Each kernel has a wrapper that on a CUDA tensor launches the kernel (or
raises) and adds one to its ``launches`` count, and on a CPU tensor runs
the same function written in plain PyTorch (a tap matrix of strided,
zero-padded slices and an f32 product; the CPU tests' path and the
reference the kernel is held against on the card):

* :func:`conv3x3s2` (K4), plain :func:`conv3x3s2_plain`;
* :func:`conv3x3s2_dx` (K4dx), plain :func:`conv3x3s2_dx_plain`;
* :func:`conv3x3s2_dw` (K4dw), plain :func:`conv3x3s2_dw_plain`.

All three live in ``csrc/conv3x3s2.cu``.  Their bf16 paths run on the
tensor cores, their f32 paths on the CUDA cores in full f32.  K4's splits
the input into its even and odd columns in shared memory while it
transposes each landed piece for the products, so no pass over device
memory is added; K4dx's computes the four parity classes of the input
pixels as four products and writes each quad of dx straight from its
accumulators.  Weights are in K1's
wall form (C_out, 9*C_in), tap-major (``conv_chw.weights_to_wall``).  H and W are
the input's (pre-downsample) height and width, both even; the output is
(H/2, W/2), output pixel (r, c) reading input pixels (2r+ki-1, 2c+kj-1).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels

MAX_CH = 64  # K4 and K4dw keep the sums of at most this many output channels


def _taps(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(N, C, H*W) -> the f32 tap matrix (N, 9*C, H/2 * W/2): row ``t*C +
    i``, t = 3*ki + kj, holds input channel i at (2r+ki-1, 2c+kj-1), zero
    outside the image."""
    n, c, _ = x.shape
    xp = F.pad(x.float().reshape(n, c, H, W), (1, 1, 1, 1))
    taps = [xp[:, :, ki:ki + H:2, kj:kj + W:2] for ki in range(3) for kj in range(3)]
    return torch.stack(taps, dim=1).reshape(n, 9 * c, (H // 2) * (W // 2))


def conv3x3s2_plain(x: torch.Tensor, w_all: torch.Tensor, H: int,
                    W: int) -> torch.Tensor:
    """K4's function in plain PyTorch: the tap matrix of the stride-2
    windows, an f32 matmul with the wall, a cast back to the input dtype."""
    return torch.matmul(w_all.float(), _taps(x, H, W)).to(x.dtype)


def conv3x3s2_dx_plain(dy: torch.Tensor, w_all: torch.Tensor, H: int,
                       W: int) -> torch.Tensor:
    """K4dx's function in plain PyTorch: dP = wall^T @ dy in f32, each
    tap's rows added back at the input pixels it read, in tap order, and
    one cast to dy's dtype.  dy (N, C_out, H/2 * W/2) -> (N, C_in, H*W)."""
    n, c_out, _ = dy.shape
    c_in = w_all.shape[1] // 9
    h2, w2 = H // 2, W // 2
    dp = torch.matmul(w_all.float().t(), dy.float()).reshape(n, 9, c_in, h2, w2)
    dxp = torch.zeros((n, c_in, H + 2, W + 2), dtype=torch.float32, device=dy.device)
    for t in range(9):
        ki, kj = divmod(t, 3)
        dxp[:, :, ki:ki + H:2, kj:kj + W:2] += dp[:, t]
    return dxp[:, :, 1:H + 1, 1:W + 1].reshape(n, c_in, H * W).to(dy.dtype)


def conv3x3s2_dw_plain(x: torch.Tensor, dy: torch.Tensor, H: int,
                       W: int) -> torch.Tensor:
    """K4dw's function in plain PyTorch: ``sum_n P_n @ dy_n^T`` with P the
    tap matrix of :func:`conv3x3s2_plain`, in float32 -> (9*C_in, C_out),
    row ``t*C_in + i``, column ``o``."""
    return torch.einsum("nkl,nol->ko", _taps(x, H, W), dy.float())


def _check(name: str, H: int, W: int, *tensors: torch.Tensor):
    """Shared checks: ``kernels.check_operands``; H and W even."""
    kernels.check_operands(name, *tensors)
    if H < 2 or W < 2 or H % 2 or W % 2:
        raise ValueError(f"{name}: needs even H and W, got {H}x{W}")


def _check_map(name: str, t: torch.Tensor, length: int, what: str):
    """t is (N >= 1, C >= 1, length)."""
    if t.dim() != 3 or t.shape[2] != length or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f"{name}: {what} {tuple(t.shape)} is not (N, C, {length})")


def _check_wall(name: str, w_all: torch.Tensor, c_in: int, c_out: int):
    """w_all is (c_out, 9*c_in) with c_out <= MAX_CH (c_out < 0: any)."""
    if (w_all.dim() != 2 or w_all.shape[1] != 9 * c_in
            or not 1 <= w_all.shape[0] <= MAX_CH
            or (c_out >= 0 and w_all.shape[0] != c_out)):
        raise ValueError(f"{name}: w_all {tuple(w_all.shape)} is not (C_out <= {MAX_CH}, "
                         f"{9 * c_in})")


_SIGNATURES = {  # C function -> argtypes; pointers and the stream as c_void_p
    "conv3x3s2": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "conv3x3s2_dx": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "conv3x3s2_dw": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "conv3x3s2_dw_workspace": [ctypes.c_int] * 6,
}


def _fn(name: str):
    return kernels.function("conv3x3s2", name, _SIGNATURES[name])


def _launch(name: str, what: str, ref: torch.Tensor, *args) -> None:
    kernels.launch("conv3x3s2", name, _SIGNATURES[name], what, ref, *args,
                   int(ref.dtype == torch.bfloat16))


def conv3x3s2(x: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Stride-2 pad-1 3x3 conv: x (N, C_in, H*W), w_all (C_out, 9*C_in) in
    x's dtype (float32 or bfloat16), H and W even -> (N, C_out, H/2 * W/2)
    in x's dtype, accumulated in float32.

    On a CUDA tensor this launches K4 and adds one to
    ``conv3x3s2.launches``; on a CPU tensor it runs the plain version."""
    _check("conv3x3s2", H, W, x, w_all)
    _check_map("conv3x3s2", x, H * W, "x")
    _check_wall("conv3x3s2", w_all, x.shape[1], -1)
    if x.device.type == "cpu":
        return conv3x3s2_plain(x, w_all, H, W)
    n, c_in, _ = x.shape
    c_out = w_all.shape[0]
    out = torch.empty((n, c_out, (H // 2) * (W // 2)), dtype=x.dtype, device=x.device)
    _launch("conv3x3s2", f"x {tuple(x.shape)}, C_out {c_out}", x, x.data_ptr(),
            w_all.data_ptr(), out.data_ptr(), n, c_in, c_out, H, W)
    conv3x3s2.launches += 1
    return out


conv3x3s2.launches = 0


def conv3x3s2_dx(dy: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Input gradient of :func:`conv3x3s2`: dy (N, C_out, H/2 * W/2), w_all
    (C_out, 9*C_in) in dy's dtype -> dx (N, C_in, H*W) in dy's dtype,
    computed in float32 and rounded once.

    On a CUDA tensor this launches K4dx and adds one to
    ``conv3x3s2_dx.launches``; on a CPU tensor it runs the plain version."""
    _check("conv3x3s2_dx", H, W, dy, w_all)
    _check_map("conv3x3s2_dx", dy, (H // 2) * (W // 2), "dy")
    _check_wall("conv3x3s2_dx", w_all, max(1, w_all.shape[-1] // 9), dy.shape[1])
    if dy.device.type == "cpu":
        return conv3x3s2_dx_plain(dy, w_all, H, W)
    n, c_out, _ = dy.shape
    c_in = w_all.shape[1] // 9
    out = torch.empty((n, c_in, H * W), dtype=dy.dtype, device=dy.device)
    _launch("conv3x3s2_dx", f"dy {tuple(dy.shape)}, C_in {c_in}", dy, dy.data_ptr(),
            w_all.data_ptr(), out.data_ptr(), n, c_in, c_out, H, W)
    conv3x3s2_dx.launches += 1
    return out


conv3x3s2_dx.launches = 0


def conv3x3s2_dw(x: torch.Tensor, dy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Weight gradient of :func:`conv3x3s2`: x (N, C_in, H*W), dy (N, C_out,
    H/2 * W/2), both float32 or both bfloat16 -> (9*C_in, C_out) float32,
    summed over the batch in a fixed order (no float atomics), so two runs
    on the same inputs agree bit for bit.

    On a CUDA tensor this launches K4dw and adds one to
    ``conv3x3s2_dw.launches``; on a CPU tensor it runs the plain version."""
    _check("conv3x3s2_dw", H, W, x, dy)
    _check_map("conv3x3s2_dw", x, H * W, "x")
    _check_map("conv3x3s2_dw", dy, (H // 2) * (W // 2), "dy")
    if dy.shape[0] != x.shape[0] or dy.shape[1] > MAX_CH:
        raise ValueError(f"conv3x3s2_dw: dy {tuple(dy.shape)} is not (N = {x.shape[0]}, "
                         f"C_out <= {MAX_CH}, L)")
    if x.device.type == "cpu":
        return conv3x3s2_dw_plain(x, dy, H, W)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3s2_dw: no kernel for device {x.device}")
    n, c_in, _ = x.shape
    c_out = dy.shape[1]
    work = torch.empty(_fn("conv3x3s2_dw_workspace")(n, c_in, c_out, H, W,
                                                     int(x.dtype == torch.bfloat16)),
                       dtype=torch.float32, device=x.device)
    out = torch.empty((9 * c_in, c_out), dtype=torch.float32, device=x.device)
    _launch("conv3x3s2_dw", f"x {tuple(x.shape)}, dy {tuple(dy.shape)}", x, x.data_ptr(),
            dy.data_ptr(), work.data_ptr(), out.data_ptr(), n, c_in, c_out, H, W)
    conv3x3s2_dw.launches += 1
    return out


conv3x3s2_dw.launches = 0


class _ConvK4(torch.autograd.Function):
    """K4 with its gradients, the JAX package's ``conv3x3s2_phase_ad``: dx
    is K4dx (only where x needs a gradient), rounded to x's dtype as JAX
    rounds it (``dxp.astype(xp.dtype)``), dw is K4dw, rounded to the
    weight's compute dtype (``dw.astype(w.dtype)``)."""

    @staticmethod
    def forward(ctx, x, w_all, H, W):
        ctx.save_for_backward(x, w_all)
        ctx.hw = (H, W)
        return conv3x3s2(x, w_all, H, W)

    @staticmethod
    def backward(ctx, dy):
        x, w_all = ctx.saved_tensors
        H, W = ctx.hw
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3s2_dx(dy, w_all, H, W).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3s2_dw(x, dy, H, W).t().to(w_all.dtype)
        return dx, dw, None, None


def conv3x3s2_ad(x: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Differentiable :func:`conv3x3s2`: the gradient of w_all comes back in
    the wall layout (C_out, 9*C_in); autograd maps it through
    ``weights_to_wall`` to the OIHW weight."""
    return _ConvK4.apply(x, w_all, H, W)
