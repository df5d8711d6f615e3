"""The CHW 3x3 convolution (kernel K1) and the conv dispatcher.

Counterpart of ``cooperative_training_and_latent_space_data_augmentation_tpu/
ops/pallas_conv.py``: ``weights_to_wall``, the channel eligibility rule,
``conv3x3_chw`` and the ``Conv`` dispatcher.  The JAX package's
CHW-resident entry (``Conv(chw=...)``, ``nhwc_to_chw``, ``chw_to_nhwc``) has
no counterpart: in NCHW the (N, C, H*W) kernel layout is a free view of
every activation, so the one NCHW route serves both.

``conv3x3_chw`` is the wrapper of K1 (``csrc/conv3x3_chw.cu``): on a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`conv3x3_chw_plain`, the same function written in plain PyTorch (the
CPU tests' path and the reference the kernel is held against on the card).

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


def _k1():
    fn = kernels.load("conv3x3_chw").conv3x3_chw
    if fn.argtypes is None:  # pointers and the stream must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_chw: no kernel for device {x.device}")
    n, c_in, L = x.shape
    c_out = w_all.shape[0]
    out = torch.empty((n, c_out, L), dtype=x.dtype, device=x.device)
    fn = _k1()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w_all.data_ptr(), out.data_ptr(), n, c_in, c_out,
                H, W, int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        msg = kernels.load("conv3x3_chw").conv3x3_chw_error_string
        msg.argtypes, msg.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"conv3x3_chw: launch failed with CUDA error {rc} "
                           f"({msg(rc).decode()}) for x {tuple(x.shape)}, "
                           f"C_out {c_out}")
    conv3x3_chw.launches += 1
    return out


conv3x3_chw.launches = 0


@contextmanager
def full_f32(dtype: torch.dtype):
    """cuDNN without TF32 while a float32 conv runs.  PyTorch lets cuDNN
    round f32 conv inputs to TF32 (10-bit mantissa) by default; the port's
    f32 convs (the latent and output heads, the code decoupler, and every
    conv of an f32 predictor) compute in full f32 whatever that global
    setting says.  Other dtypes run untouched."""
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
      layout, so no transpose is needed around it);
    * every other conv goes to ``F.conv2d``, as the JAX package leaves those
      to XLA, in full f32 when it computes in f32 (:func:`full_f32`);
    * the bias is added after the conv, in the compute dtype.
    """

    def __init__(self, c_in: int, c_out: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = stride
        self.padding = padding
        self.dtype = dtype

    def uses_k1(self) -> bool:
        c_out, c_in, kh, _ = self.weight.shape
        return (kh == 3 and self.stride == 1 and self.padding == 1
                and eligible_channels(c_in, c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        x = x.to(dt)
        w = self.weight.to(dt)
        if self.uses_k1():
            n, c, h, ww = x.shape
            y = conv3x3_chw(x.reshape(n, c, h * ww).contiguous(),
                            weights_to_wall(w).contiguous(), h, ww)
            y = y.reshape(n, -1, h, ww)
        else:
            with full_f32(dt):
                y = F.conv2d(x, w, None, self.stride, self.padding)
        return y + self.bias.to(dt)[:, None, None]
