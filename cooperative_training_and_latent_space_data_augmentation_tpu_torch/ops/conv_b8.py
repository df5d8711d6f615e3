"""The output-blocked (B = 8) SAME 3x3 convolution (kernel K6) and its
gradients (K6 on flipped weights for dx, kernel K6dw for dw), the small-
channel conv that :mod:`..bench_b8_conv` times against K1 and cuDNN.  No
model path runs it, in the JAX package or here.

Counterpart of ``cooperative_training_and_latent_space_data_augmentation_tpu/
ops/pallas_conv_blocked.py``: ``blocked_weights``, ``_build_p_b8``,
``conv3x3_b8`` (K6), ``fold_dw_wall``, ``_conv3x3_b8_dw`` (K6dw), the custom
VJP ``conv3x3_b8_ad`` and the shape gate ``b8_eligible``.  The TPU kernel
blocks 8 consecutive output pixels of an image row into one matmul column
group, ``out'(HW/8, 8*C_out) = P'(HW/8, 30*C_in) @ W'(30*C_in, 8*C_out)``, so
that a 16-channel conv fills the MXU's lanes.  The plain versions here
compute exactly that blocked formulation (so the CPU tests hold the
blocking and the fold against JAX); the CUDA kernels compute the same
function without P' (``csrc/conv3x3_b8.cu``): K6 and K6dw in bf16 as
implicit GEMMs on the tensor cores (K6dw with the pixels as the reduction,
its blocks' sums added in a fixed order), K6 and K6dw in f32 by register
blocking on the CUDA cores.  The ``custom_partitioning`` wrappers have no
counterpart.

Each kernel has a wrapper that on a CUDA tensor launches the kernel (or
raises) and adds one to its ``launches`` count, and on a CPU tensor runs
the plain version:

* :func:`conv3x3_b8` (K6), plain :func:`conv3x3_b8_plain`;
* :func:`conv3x3_b8_dx`: K6 on dy with the flipped wall, counted apart;
  the kernel reads the flipped wall out of the unflipped one (``flip =
  1``), the plain version takes :func:`..conv_chw.flip_wall`;
* :func:`conv3x3_b8_dw` (K6dw), plain :func:`conv3x3_b8_dw_plain`.

Layouts are the port's, as for K1: x (N, C, H*W), weights in K1's wall form
(C_out, 9*C_in), dw (9*C_in, C_out) float32.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
    flip_wall,
)

B = 8        # output pixels per block
MAX_CH = 64  # the gate's largest channel count


def b8_eligible(h: int, w: int, c_in: int, c_out: int) -> bool:
    """The JAX package's ``b8_eligible``: 8 | W, H >= 2, C_in >= 8 and
    max(C) <= 64."""
    return w % B == 0 and h >= 2 and c_in >= 8 and max(c_in, c_out) <= MAX_CH


def wall_to_hwio(w_all: torch.Tensor) -> torch.Tensor:
    """(C_out, 9*C_in) wall -> (3, 3, C_in, C_out) HWIO."""
    c_out = w_all.shape[0]
    return w_all.reshape(c_out, 3, 3, -1).permute(1, 2, 3, 0)


def blocked_weights(w_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, C_in, C_out) -> W' (30*C_in, 8*C_out): row (di, c, i), column
    (j, o) holds ``w[di, c - j, i, o]`` for 0 <= c - j <= 2, else 0."""
    _, _, c_in, c_out = w_hwio.shape
    cols = [F.pad(w_hwio, (0, 0, 0, 0, j, B - 1 - j)) for j in range(B)]  # (3, 10, C_in, C_out)
    return torch.stack(cols, dim=3).reshape(3 * (B + 2) * c_in, B * c_out)


def blocked_rows(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H*W) -> the blocked row layout (N, H*W/8, 8*C): row r holds
    pixels 8r .. 8r+7, channels minor (a row-major reshape of NHWC)."""
    n, c, L = x.shape
    return x.permute(0, 2, 1).reshape(n, L // B, B * c)


def build_p_b8(xb: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """P' (N, HW/8, 30*C) in float32 from the blocked image xb (N, HW/8,
    8*C), as ``_build_p_b8``: for window row di, the block q = r + (di-1)*W/8
    rolled into row r, with the last pixel of block q-1 on its left and the
    first of block q+1 on its right, zero where the window leaves the image."""
    n, rows, bc = xb.shape
    c = bc // B
    wb = W // B
    xf = xb.float()
    r = torch.arange(rows, device=xb.device)[:, None]
    first_col = (r % wb) == 0
    last_col = (r % wb) == wb - 1
    parts = []
    for di in range(3):
        q = (di - 1) * wb
        mid = torch.roll(xf, -q, 1)
        prev = torch.roll(xf, -(q - 1), 1)
        nxt = torch.roll(xf, -(q + 1), 1)
        if di == 0:
            row_ok = r >= wb
        elif di == 2:
            row_ok = r < rows - wb
        else:
            row_ok = torch.ones_like(r, dtype=torch.bool)
        parts += [torch.where(row_ok & ~first_col, prev[..., (B - 1) * c:], 0.0),
                  torch.where(row_ok, mid, 0.0),
                  torch.where(row_ok & ~last_col, nxt[..., :c], 0.0)]
    return torch.cat(parts, dim=2)


def fold_dw_wall(wall: torch.Tensor, c_in: int, c_out: int) -> torch.Tensor:
    """(30*C_in, 8*C_out) wall -> (3, 3, C_in, C_out): tap (di, kj) appears
    once per output position j, at window column c = j + kj; summed over j
    in j order."""
    wall = wall.reshape(3, B + 2, c_in, B, c_out)
    taps = []
    for kj in range(3):
        acc = wall[:, kj, :, 0, :]
        for j in range(1, B):
            acc = acc + wall[:, j + kj, :, j, :]
        taps.append(acc)
    return torch.stack(taps, dim=1)


def conv3x3_b8_plain(x: torch.Tensor, w_all: torch.Tensor, H: int,
                     W: int) -> torch.Tensor:
    """K6's function in plain PyTorch, blocked as the TPU kernel: P' @ W' in
    float32 per image, the (HW/8, 8*C_out) result unblocked and cast back to
    the input dtype -> (N, C_out, H*W)."""
    n, _, L = x.shape
    c_out = w_all.shape[0]
    p = build_p_b8(blocked_rows(x), H, W)                       # (N, HW/8, 30*C_in)
    out = torch.matmul(p, blocked_weights(wall_to_hwio(w_all.float())))
    return out.reshape(n, L, c_out).permute(0, 2, 1).contiguous().to(x.dtype)


def conv3x3_b8_dw_plain(x: torch.Tensor, dy: torch.Tensor, H: int,
                        W: int) -> torch.Tensor:
    """K6dw's function in plain PyTorch: ``sum_n P'_n^T @ dY'_n`` in float32
    (the TPU kernel's accumulation over its image grid), folded to HWIO by
    :func:`fold_dw_wall` -> (9*C_in, C_out), row ``t*C_in + i``."""
    c_in, c_out = x.shape[1], dy.shape[1]
    p = build_p_b8(blocked_rows(x), H, W)                       # (N, HW/8, 30*C_in)
    dyb = blocked_rows(dy).float()                              # (N, HW/8, 8*C_out)
    wall = torch.einsum("nrk,nrc->kc", p, dyb)
    return fold_dw_wall(wall, c_in, c_out).reshape(9 * c_in, c_out)


def _check(name: str, H: int, W: int, c_in: int, c_out: int, *tensors: torch.Tensor):
    """``kernels.check_operands``; the forward conv (c_in -> c_out) passes
    :func:`b8_eligible`."""
    kernels.check_operands(name, *tensors)
    if not b8_eligible(H, W, c_in, c_out):
        raise ValueError(f"{name}: {c_in} -> {c_out} at {H}x{W} fails the B8 gate "
                         f"(8 | W, H >= 2, C_in >= 8, max(C) <= {MAX_CH})")


def _check_map(name: str, t: torch.Tensor, c: int, L: int, what: str):
    """t is (N >= 1, c, L)."""
    if t.dim() != 3 or t.shape[0] < 1 or t.shape[1] != c or t.shape[2] != L:
        raise ValueError(f"{name}: {what} {tuple(t.shape)} is not (N, {c}, {L})")


def _check_wall(name: str, w_all: torch.Tensor):
    if w_all.dim() != 2 or w_all.shape[1] % 9 or w_all.shape[0] < 1 or w_all.shape[1] < 9:
        raise ValueError(f"{name}: w_all {tuple(w_all.shape)} is not (C_out, 9*C_in)")


def _check_conv(name: str, a: torch.Tensor, w_all: torch.Tensor, H: int, W: int,
                flip: bool = False) -> int:
    """w_all is the forward conv's wall (C_out, 9*C_in) and the forward
    passes the gate; a is its input (N, C_in, H*W), or with ``flip`` its
    output gradient (N, C_out, H*W).  Returns the channels of the result."""
    _check_wall(name, w_all)
    c_out, c_in = w_all.shape[0], w_all.shape[1] // 9
    _check(name, H, W, c_in, c_out, a, w_all)
    _check_map(name, a, c_out if flip else c_in, H * W, "input")
    return c_in if flip else c_out


_SIGNATURES = {  # C function -> argtypes; pointers and the stream as c_void_p
    "conv3x3_b8": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    "conv3x3_b8_dw": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "conv3x3_b8_dw_workspace": [ctypes.c_int] * 5,
}


def _fn(name: str):
    return kernels.function("conv3x3_b8", name, _SIGNATURES[name])


def _launch(name: str, what: str, ref: torch.Tensor, *args) -> None:
    kernels.launch("conv3x3_b8", name, _SIGNATURES[name], what, ref, *args,
                   int(ref.dtype == torch.bfloat16))


def _launch_k6(x: torch.Tensor, w_all: torch.Tensor, c_out: int, H: int, W: int,
               flip: bool) -> torch.Tensor:
    """K6 on x with the wall w_all (``flip``: the forward's wall, read
    flipped and transposed).  The bf16 kernel lands x in 16-byte pieces, so
    x must start on a 16-byte boundary there."""
    n, c_in, L = x.shape
    if x.device.type == "cuda" and x.dtype == torch.bfloat16 and x.data_ptr() % 16:
        raise ValueError("conv3x3_b8: a bfloat16 input must start 16-byte aligned")
    out = torch.empty((n, c_out, L), dtype=x.dtype, device=x.device)
    _launch("conv3x3_b8", f"x {tuple(x.shape)}, C_out {c_out}, flip {int(flip)}", x,
            x.data_ptr(), w_all.data_ptr(), out.data_ptr(), n, c_in, c_out, H, W, int(flip))
    return out


def conv3x3_b8(x: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """SAME stride-1 3x3 conv, output-blocked: x (N, C_in, H*W), w_all
    (C_out, 9*C_in) in x's dtype (float32 or bfloat16), shapes that pass
    :func:`b8_eligible` -> (N, C_out, H*W) in x's dtype, accumulated in
    float32.

    On a CUDA tensor this launches K6 and adds one to
    ``conv3x3_b8.launches``; on a CPU tensor it runs the plain version."""
    c_out = _check_conv("conv3x3_b8", x, w_all, H, W)
    if x.device.type == "cpu":
        return conv3x3_b8_plain(x, w_all, H, W)
    out = _launch_k6(x, w_all, c_out, H, W, flip=False)
    conv3x3_b8.launches += 1
    return out


conv3x3_b8.launches = 0


def conv3x3_b8_dx(dy: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Input gradient of :func:`conv3x3_b8`: dy (N, C_out, H*W), w_all
    (C_out, 9*C_in) -> dx (N, C_in, H*W) in dy's dtype: K6 on the flipped,
    transposed wall (the JAX package's ``_b8_fwd_dispatch(dy,
    _flip_w(w))``).  The gate is the forward conv's.

    On a CUDA tensor this launches K6 with ``flip = 1``, which reads the
    flipped wall's element (i, t*C_out + o) from ``w_all[o, (8-t)*C_in + i]``
    (no flipped copy is made), and adds one to ``conv3x3_b8_dx.launches``
    (not to the forward's count); on a CPU tensor it runs
    :func:`conv3x3_b8_plain` on :func:`..conv_chw.flip_wall`."""
    c_in = _check_conv("conv3x3_b8_dx", dy, w_all, H, W, flip=True)
    if dy.device.type == "cpu":
        return conv3x3_b8_plain(dy, flip_wall(w_all).contiguous(), H, W)
    out = _launch_k6(dy, w_all, c_in, H, W, flip=True)
    conv3x3_b8_dx.launches += 1
    return out


conv3x3_b8_dx.launches = 0


def conv3x3_b8_dw(x: torch.Tensor, dy: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Weight gradient of :func:`conv3x3_b8`: x (N, C_in, H*W), dy (N, C_out,
    H*W), both float32 or both bfloat16 -> (9*C_in, C_out) float32, summed
    in a fixed order (no float atomics), so two runs on the same inputs
    agree bit for bit.

    On a CUDA tensor this launches K6dw and adds one to
    ``conv3x3_b8_dw.launches``; on a CPU tensor it runs the plain version.
    The bf16 kernel lands x and dy in 16-byte pieces, so both must start on
    a 16-byte boundary there."""
    if x.dim() != 3 or dy.dim() != 3:
        raise ValueError(f"conv3x3_b8_dw: x {tuple(x.shape)} and dy {tuple(dy.shape)} are "
                         f"not (N, C, H*W)")
    _check("conv3x3_b8_dw", H, W, x.shape[1], dy.shape[1], x, dy)
    _check_map("conv3x3_b8_dw", x, x.shape[1], H * W, "x")
    _check_map("conv3x3_b8_dw", dy, dy.shape[1], H * W, "dy")
    if dy.shape[0] != x.shape[0]:
        raise ValueError(f"conv3x3_b8_dw: x {tuple(x.shape)} and dy {tuple(dy.shape)} differ "
                         f"in batch")
    if x.device.type == "cpu":
        return conv3x3_b8_dw_plain(x, dy, H, W)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_b8_dw: no kernel for device {x.device}")
    if x.dtype == torch.bfloat16 and (x.data_ptr() % 16 or dy.data_ptr() % 16):
        raise ValueError("conv3x3_b8_dw: bfloat16 x and dy must start 16-byte aligned")
    n, c_in, _ = x.shape
    c_out = dy.shape[1]
    work = torch.empty(_fn("conv3x3_b8_dw_workspace")(n, c_in, c_out, H, W),
                       dtype=torch.float32, device=x.device)
    out = torch.empty((9 * c_in, c_out), dtype=torch.float32, device=x.device)
    _launch("conv3x3_b8_dw", f"x {tuple(x.shape)}, dy {tuple(dy.shape)}", x, x.data_ptr(),
            dy.data_ptr(), work.data_ptr(), out.data_ptr(), n, c_in, c_out, H, W)
    conv3x3_b8_dw.launches += 1
    return out


conv3x3_b8_dw.launches = 0


class _ConvK6(torch.autograd.Function):
    """K6 with its gradients, the JAX package's ``conv3x3_b8_ad``
    (``_b8_ad_bwd``): dx is K6 on the flipped wall (only where x needs a
    gradient), in dy's dtype; dw is K6dw, rounded to the weight's compute
    dtype (``dw.astype(w.dtype)``)."""

    @staticmethod
    def forward(ctx, x, w_all, H, W):
        ctx.save_for_backward(x, w_all)
        ctx.hw = (H, W)
        return conv3x3_b8(x, w_all, H, W)

    @staticmethod
    def backward(ctx, dy):
        x, w_all = ctx.saved_tensors
        H, W = ctx.hw
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_b8_dx(dy, w_all, H, W)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_b8_dw(x, dy, H, W).t().to(w_all.dtype)
        return dx, dw, None, None


def conv3x3_b8_ad(x: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Differentiable :func:`conv3x3_b8`: the gradient of w_all comes back in
    the wall layout (C_out, 9*C_in)."""
    return _ConvK6.apply(x, w_all, H, W)
