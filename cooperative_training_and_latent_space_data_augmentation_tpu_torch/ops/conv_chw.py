"""The CHW 3x3 convolution (kernel K1), its gradients (K1 on flipped
weights for dx, kernel K2 for dw) and the conv dispatcher, which also
routes the stride-2 downsamples to K4 (``ops/conv_s2.py``) and the
large-channel 3x3 convs to K5 (``ops/conv_nl.py``) when asked.

Counterpart of ``cooperative_training_and_latent_space_data_augmentation_tpu/
ops/pallas_conv.py``: ``weights_to_wall``, the channel eligibility rule,
``conv3x3_chw``, ``_conv3x3_chw_dw``, ``_flip_w``, the custom-VJP
``conv3x3_chw_ad`` (its ``PALLAS_VJP=pallas`` route) and the ``Conv``
dispatcher.  The JAX package's CHW-resident entry (``Conv(chw=...)``,
``nhwc_to_chw``, ``chw_to_nhwc``) has no counterpart: in NCHW the (N, C,
H*W) kernel layout is a free view of every activation, so the one NCHW
route serves both.

Each kernel has a wrapper that on a CUDA tensor launches the kernel (or
raises) and adds one to its ``launches`` count, and on a CPU tensor runs
the same function written in plain PyTorch (the CPU tests' path and the
reference the kernel is held against on the card):

* :func:`conv3x3_chw` (K1, ``csrc/conv3x3_chw.cu``), plain
  :func:`conv3x3_chw_plain`;
* :func:`conv3x3_chw_dx`: K1 on dy with the wall of the flipped,
  transposed kernel, counted apart from the forward;
* :func:`conv3x3_chw_dw` (K2, ``csrc/conv3x3_chw_dw.cu``), plain
  :func:`conv3x3_chw_dw_plain`.

Weights are PyTorch's OIHW.  The kernel takes them in the "wall" form
(C_out, 9*C_in), tap-major: column ``t*C_in + i`` holds ``w[:, i, t // 3,
t % 3]``, exactly the JAX package's ``weights_to_wall`` of the HWIO kernel.
"""

from __future__ import annotations

import ctypes
from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_nl import (
    conv3x3_nl_ad,
    eligible_channels_nl,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_s2 import (
    conv3x3s2_ad,
)

MAX_CH = 64  # K1 takes convs with max(C_in, C_out) <= MAX_CH


def weights_to_wall(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 3, 3) OIHW -> (C_out, 9*C_in), tap-major columns."""
    c_out, c_in = w.shape[0], w.shape[1]
    return w.permute(0, 2, 3, 1).reshape(c_out, 9 * c_in)


def eligible_channels(c_in: int, c_out: int) -> bool:
    """The JAX package's ``_eligible_channels`` at its default cutoff: the
    CHW kernel serves convs with at most 64 channels on either side."""
    return max(c_in, c_out) <= MAX_CH


def conv3x3_chw_plain(x: torch.Tensor, w_all: torch.Tensor, H: int,
                      W: int) -> torch.Tensor:
    """K1's function in plain PyTorch: the tap matrix P (9*C_in, H*W) of
    shifted, zero-padded copies of each image, an f32 matmul, a cast back
    to the input dtype."""
    n, c_in, _ = x.shape
    xp = F.pad(x.float().reshape(n, c_in, H, W), (1, 1, 1, 1))
    taps = [xp[:, :, ki:ki + H, kj:kj + W] for ki in range(3) for kj in range(3)]
    p = torch.stack(taps, dim=1).reshape(n, 9 * c_in, H * W)
    return torch.matmul(w_all.float(), p).to(x.dtype)


def _check_k1_args(x: torch.Tensor, w_all: torch.Tensor, H: int, W: int):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3_chw: x must be float32 or bfloat16, got {x.dtype}")
    if w_all.dtype != x.dtype:
        raise TypeError(f"conv3x3_chw: w_all is {w_all.dtype}, x is {x.dtype}")
    if w_all.device != x.device:
        raise ValueError(f"conv3x3_chw: w_all on {w_all.device}, x on {x.device}")
    if x.dim() != 3 or x.shape[2] != H * W or H < 1 or W < 1:
        raise ValueError(f"conv3x3_chw: x {tuple(x.shape)} is not (N, C_in, {H}*{W})")
    n, c_in, _ = x.shape
    if w_all.dim() != 2 or w_all.shape[1] != 9 * c_in:
        raise ValueError(f"conv3x3_chw: w_all {tuple(w_all.shape)} is not "
                         f"(C_out, {9 * c_in})")
    if not 1 <= w_all.shape[0] <= MAX_CH or c_in < 1 or n < 1:
        raise ValueError(f"conv3x3_chw: needs N >= 1, C_in >= 1 and "
                         f"1 <= C_out <= {MAX_CH}, got x {tuple(x.shape)}, "
                         f"w_all {tuple(w_all.shape)}")
    if not (x.is_contiguous() and w_all.is_contiguous()):
        raise ValueError("conv3x3_chw: x and w_all must be contiguous")


_SIGNATURES = {  # C function -> argtypes; pointers and the stream as c_void_p
    "conv3x3_chw": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "conv3x3_chw_dw": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    "conv3x3_chw_dw_workspace": [ctypes.c_int] * 5,
}


def _k1():
    return kernels.function("conv3x3_chw", "conv3x3_chw", _SIGNATURES["conv3x3_chw"])


def _launch_k1(x: torch.Tensor, w_all: torch.Tensor, H: int, W: int) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_chw: no kernel for device {x.device}")
    n, c_in, L = x.shape
    c_out = w_all.shape[0]
    out = torch.empty((n, c_out, L), dtype=x.dtype, device=x.device)
    kernels.launch("conv3x3_chw", "conv3x3_chw", _SIGNATURES["conv3x3_chw"],
                   f"x {tuple(x.shape)}, C_out {c_out}", x, x.data_ptr(), w_all.data_ptr(),
                   out.data_ptr(), n, c_in, c_out, H, W, int(x.dtype == torch.bfloat16))
    return out


def conv3x3_chw(x: torch.Tensor, w_all: torch.Tensor, H: int,
                W: int) -> torch.Tensor:
    """SAME stride-1 3x3 conv: x (N, C_in, H*W), w_all (C_out, 9*C_in) in
    x's dtype (float32 or bfloat16) -> (N, C_out, H*W) in x's dtype,
    accumulated in float32.

    On a CUDA tensor this launches K1 and adds one to
    ``conv3x3_chw.launches``; on a CPU tensor it runs the plain version.
    """
    _check_k1_args(x, w_all, H, W)
    if x.device.type == "cpu":
        return conv3x3_chw_plain(x, w_all, H, W)
    out = _launch_k1(x, w_all, H, W)
    conv3x3_chw.launches += 1
    return out


conv3x3_chw.launches = 0


def flip_wall(w_all: torch.Tensor) -> torch.Tensor:
    """The wall of the flipped, transposed kernel, the JAX package's
    ``weights_to_wall(_flip_w(w))``: for OIHW ``w``, ``w'[i, o, kh, kw] =
    w[o, i, 2-kh, 2-kw]``, so (C_out, 9*C_in) -> (C_in, 9*C_out) with
    column ``t*C_out + o`` of row ``i`` read from ``w_all[o, (8-t)*C_in + i]``."""
    c_out, k = w_all.shape
    c_in = k // 9
    return w_all.reshape(c_out, 9, c_in).flip(1).permute(2, 1, 0).reshape(c_in, 9 * c_out)


def conv3x3_chw_dx(dy: torch.Tensor, w_all: torch.Tensor, H: int,
                   W: int) -> torch.Tensor:
    """Input gradient of :func:`conv3x3_chw`: dy (N, C_out, H*W), w_all
    (C_out, 9*C_in) -> dx (N, C_in, H*W) in dy's dtype.  A SAME 3x3 conv's
    input gradient is the SAME 3x3 conv of dy with the flipped, transposed
    kernel, so this is K1 on :func:`flip_wall`.

    On a CUDA tensor this launches K1 and adds one to
    ``conv3x3_chw_dx.launches`` (not to the forward's count); on a CPU
    tensor it runs :func:`conv3x3_chw_plain` on the flipped wall."""
    w_flip = flip_wall(w_all).contiguous()
    _check_k1_args(dy, w_flip, H, W)
    if dy.device.type == "cpu":
        return conv3x3_chw_plain(dy, w_flip, H, W)
    out = _launch_k1(dy, w_flip, H, W)
    conv3x3_chw_dx.launches += 1
    return out


conv3x3_chw_dx.launches = 0


def conv3x3_chw_dw_plain(x: torch.Tensor, dy: torch.Tensor, H: int,
                         W: int) -> torch.Tensor:
    """K2's function in plain PyTorch: ``sum_n P_n @ dy_n^T`` with P the
    tap matrix of :func:`conv3x3_chw_plain`, in float32 -> (9*C_in, C_out),
    row ``t*C_in + i``, column ``o``."""
    n, c_in, _ = x.shape
    xp = F.pad(x.float().reshape(n, c_in, H, W), (1, 1, 1, 1))
    taps = [xp[:, :, ki:ki + H, kj:kj + W] for ki in range(3) for kj in range(3)]
    p = torch.stack(taps, dim=1).reshape(n, 9 * c_in, H * W)
    return torch.einsum("nkl,nol->ko", p, dy.float())


def _check_k2_args(x: torch.Tensor, dy: torch.Tensor, H: int, W: int):
    if x.dtype not in (torch.float32, torch.bfloat16) or dy.dtype != x.dtype:
        raise TypeError(f"conv3x3_chw_dw: x and dy must both be float32 or both "
                        f"bfloat16, got {x.dtype} and {dy.dtype}")
    if dy.device != x.device:
        raise ValueError(f"conv3x3_chw_dw: dy on {dy.device}, x on {x.device}")
    if (x.dim() != 3 or dy.dim() != 3 or x.shape[2] != H * W or dy.shape[2] != H * W
            or dy.shape[0] != x.shape[0] or H < 1 or W < 1):
        raise ValueError(f"conv3x3_chw_dw: x {tuple(x.shape)} and dy {tuple(dy.shape)} "
                         f"are not (N, C, {H}*{W})")
    if not (x.shape[0] >= 1 and x.shape[1] >= 1 and 1 <= dy.shape[1] <= MAX_CH):
        raise ValueError(f"conv3x3_chw_dw: needs N >= 1, C_in >= 1 and "
                         f"1 <= C_out <= {MAX_CH}, got x {tuple(x.shape)}, "
                         f"dy {tuple(dy.shape)}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("conv3x3_chw_dw: x and dy must be contiguous")


def conv3x3_chw_dw(x: torch.Tensor, dy: torch.Tensor, H: int,
                   W: int) -> torch.Tensor:
    """Weight gradient of :func:`conv3x3_chw`: x (N, C_in, H*W), dy (N,
    C_out, H*W), both float32 or both bfloat16 -> (9*C_in, C_out) float32,
    summed over the batch in a fixed order (no float atomics), so two runs
    on the same inputs agree bit for bit.

    On a CUDA tensor this launches K2 and adds one to
    ``conv3x3_chw_dw.launches``; on a CPU tensor it runs
    :func:`conv3x3_chw_dw_plain`."""
    _check_k2_args(x, dy, H, W)
    if x.device.type == "cpu":
        return conv3x3_chw_dw_plain(x, dy, H, W)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_chw_dw: no kernel for device {x.device}")
    n, c_in, _ = x.shape
    c_out = dy.shape[1]
    ws_size = kernels.function("conv3x3_chw_dw", "conv3x3_chw_dw_workspace",
                               _SIGNATURES["conv3x3_chw_dw_workspace"])
    work = torch.empty(ws_size(n, c_in, c_out, H, W), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((9 * c_in, c_out), dtype=torch.float32, device=x.device)
    kernels.launch("conv3x3_chw_dw", "conv3x3_chw_dw", _SIGNATURES["conv3x3_chw_dw"],
                   f"x {tuple(x.shape)}, dy {tuple(dy.shape)}", x, x.data_ptr(),
                   dy.data_ptr(), work.data_ptr(), out.data_ptr(), n, c_in, c_out, H, W,
                   int(x.dtype == torch.bfloat16))
    conv3x3_chw_dw.launches += 1
    return out


conv3x3_chw_dw.launches = 0


class _ConvK1(torch.autograd.Function):
    """K1 with its gradients, the JAX package's ``conv3x3_chw_ad`` on its
    ``PALLAS_VJP=pallas`` route: dx is K1 on the flipped wall (only where x
    needs a gradient: not for an image or a label), dw is K2, rounded to
    the weight's compute dtype as JAX rounds it (``dw.astype(w.dtype)``)."""

    @staticmethod
    def forward(ctx, x, w_all, H, W):
        ctx.save_for_backward(x, w_all)
        ctx.hw = (H, W)
        return conv3x3_chw(x, w_all, H, W)

    @staticmethod
    def backward(ctx, dy):
        x, w_all = ctx.saved_tensors
        H, W = ctx.hw
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_chw_dx(dy, w_all, H, W)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_chw_dw(x, dy, H, W).t().to(w_all.dtype)
        return dx, dw, None, None


def conv3x3_chw_ad(x: torch.Tensor, w_all: torch.Tensor, H: int,
                   W: int) -> torch.Tensor:
    """Differentiable :func:`conv3x3_chw`: the gradient of w_all comes
    back in the wall layout (C_out, 9*C_in); autograd maps it through
    :func:`weights_to_wall` to the OIHW weight."""
    return _ConvK1.apply(x, w_all, H, W)


@contextmanager
def full_f32(dtype: torch.dtype):
    """cuDNN without TF32 while a float32 conv runs.  PyTorch lets cuDNN
    round f32 conv inputs to TF32 (10-bit mantissa) by default; the port's
    f32 convs (the latent and output heads, the code decoupler, and every
    conv of an f32 predictor) compute in full f32 whatever that global
    setting says.  Their backward runs later, outside the forward's block,
    so the trainer wraps each backward in ``full_f32(torch.float32)``.
    Other dtypes run untouched."""
    if dtype != torch.float32:
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class Conv(nn.Module):
    """Conv layer with an ``nn.Conv2d`` state dict (OIHW ``weight``,
    ``bias``) that computes in ``dtype`` (None: the input's dtype) and
    routes like the JAX package's ``Conv``:

    * a stride-1 SAME 3x3 conv with eligible channels goes to K1, on the
      (N, C, H*W) view of the NCHW input (a free reshape in PyTorch's
      layout, so no transpose is needed around it), through
      :func:`conv3x3_chw_ad`, so its backward runs K1 (dx) and K2 (dw);
    * a stride-2 pad-1 3x3 conv built with ``k4=True`` (the caller checked
      the JAX package's ``s2_chain_ok`` channel rule) goes to K4 on an
      input of even height and width, through ``conv_s2.conv3x3s2_ad``, so
      its backward runs K4dx and K4dw;
    * a stride-1 SAME 3x3 conv built with ``k5=True`` whose channels pass
      ``conv_nl.eligible_channels_nl`` goes to K5, on the same (N, C, H*W)
      view, through ``conv_nl.conv3x3_nl_ad``, so its backward runs K5 (dx)
      and K5dw.  K1 comes first, as in the JAX package's ``Conv``, but the
      two channel rules are disjoint.  The route is chosen per call site,
      never by channel count alone: the JAX package sends to its NL kernel
      only the convs built with its dispatching ``Conv`` (the encoders' and
      decoders' residual stages), not the code decoupler's stock
      ``nn.Conv``, so only those blocks build their convs with ``k5``;
    * every other conv goes to ``F.conv2d``, as the JAX package leaves those
      to XLA, in full f32 when it computes in f32 (:func:`full_f32`);
    * the bias is added after the conv, in the compute dtype.
    """

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None, k4: bool = False,
                 k5: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.k4 = k4
        self.k5 = k5

    def uses_k1(self) -> bool:
        c_out, c_in, kh, _ = self.weight.shape
        return (kh == 3 and self.stride == 1 and self.padding == 1
                and eligible_channels(c_in, c_out))

    def uses_k4(self) -> bool:
        """Routed to K4 (on inputs of even height and width)."""
        return (self.k4 and self.weight.shape[2] == 3 and self.stride == 2
                and self.padding == 1)

    def uses_k5(self) -> bool:
        c_out, c_in, kh, _ = self.weight.shape
        return (self.k5 and kh == 3 and self.stride == 1 and self.padding == 1
                and not self.uses_k1() and eligible_channels_nl(c_in, c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight)

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """This layer's conv with the OIHW ``weight`` in place of its own
        (a float32 weight derived inside autograd, such as a spectrally
        normalised one), on this layer's route, stride, padding, dtype and
        bias."""
        dt = self.dtype or x.dtype
        x = x.to(dt)
        w = weight.to(dt)
        if self.uses_k1():
            n, c, h, ww = x.shape
            y = conv3x3_chw_ad(x.reshape(n, c, h * ww).contiguous(),
                               weights_to_wall(w).contiguous(), h, ww)
            y = y.reshape(n, -1, h, ww)
        elif self.uses_k4() and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            n, c, h, ww = x.shape
            y = conv3x3s2_ad(x.reshape(n, c, h * ww).contiguous(),
                             weights_to_wall(w).contiguous(), h, ww)
            y = y.reshape(n, -1, h // 2, ww // 2)
        elif self.uses_k5():
            n, c, h, ww = x.shape
            y = conv3x3_nl_ad(x.reshape(n, c, h * ww).contiguous(),
                              weights_to_wall(w).contiguous(), h, ww)
            y = y.reshape(n, -1, h, ww)
        else:
            with full_f32(dt):
                y = F.conv2d(x, w, None, self.stride, self.padding)
        return y + self.bias.to(dt)[:, None, None]
