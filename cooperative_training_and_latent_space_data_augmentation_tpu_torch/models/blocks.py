"""Residual conv building blocks, NCHW.

Counterpart of ``cooperative_training_and_latent_space_data_augmentation_tpu/
models/blocks.py``.  Module and parameter names follow the reference
PyTorch networks the JAX package was transplanted from (``inc.0``,
``down1.conv_input``, ``up1.up``, ...), so :mod:`..convert` is the inverse of
the JAX package's torch -> flax converter.

The JAX package keeps two routes through ``ConvBlock`` and ``_ResCore``: an
NHWC one, and a "fused" one that transposes once to the (N, C, H*W) kernel
layout so that consecutive Pallas convs need no transposes between them.
In NCHW, (N, C, H*W) is a free view of the activation, so one route serves
both: each :class:`Conv` sends its eligible 3x3 convs to K1 and the rest to
``F.conv2d``, and the kernel launches are the same as the JAX fused route's.

BatchNorm has the JAX package's three modes: eval (running statistics),
train (batch statistics, running statistics updated) and train with
frozen statistics (batch statistics, no update; :func:`frozen_stats`), the
reference's ``_disable_tracking_bn_stats``.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
    Conv,
    full_f32,
)

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: running <- 0.9 * running + 0.1 * batch
LEAKY_SLOPE = 0.2


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) written as flax's ``nn.leaky_relu``,
    ``where(x >= 0, x, slope * x)``, so that its gradient at exactly 0 is 1
    as in JAX (``F.leaky_relu``'s is the slope; exact zeros are common in
    bf16 after a residual add).  The slope is rounded to x's dtype first:
    JAX multiplies a bf16 activation by bf16(0.2) = 0.2001953125, PyTorch by
    the float 0.2, and the two products round apart for about one negative
    activation in four."""
    slope = torch.tensor(LEAKY_SLOPE, dtype=x.dtype).item()
    return torch.where(x >= 0, x, x * slope)


class BatchNorm(nn.Module):
    """BatchNorm2d over channel axis 1 with ``nn.BatchNorm2d``'s state dict,
    the JAX package's ``models/blocks.py:BatchNorm``.

    Statistics and affine math are float32 and the result is cast back to
    the input dtype (the JAX package's rounding point under bf16 mixed
    precision).  Eval mode normalizes with the running statistics.  Train
    mode normalizes with the batch mean and biased variance over every axis
    but 1 and, unless ``update_stats`` is off (:func:`frozen_stats`), moves
    the running statistics by ``BN_MOMENTUM`` toward the batch mean and the
    unbiased (Bessel-corrected) variance, as torch's BatchNorm2d does.
    Works on (N, C, H, W) and (N, C, H*W) alike.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x32 = x.float()
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            mean = x32.mean(axes)
            var = (x32 - mean.view(shape)).square().mean(axes)
            if self.update_stats:
                n = x.numel() // x.shape[1]
                unbiased = var.detach() * (n / (n - 1.0)) if n > 1 else var.detach()
                m = BN_MOMENTUM
                with torch.no_grad():
                    self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.detach())
                    self.running_var.copy_(m * self.running_var + (1.0 - m) * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = ((x32 - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
             * self.weight.view(shape) + self.bias.view(shape))
        return y.to(x.dtype)


@contextmanager
def frozen_stats(*modules: nn.Module):
    """Train-mode BatchNorms of ``modules`` normalize with batch statistics
    but leave their running statistics alone while the block runs: the
    JAX package discarding the emitted ``batch_stats``, the reference's
    ``_disable_tracking_bn_stats``."""
    bns = [m for mod in modules for m in mod.modules() if isinstance(m, BatchNorm)]
    before = [bn.update_stats for bn in bns]
    for bn in bns:
        bn.update_stats = False
    try:
        yield
    finally:
        for bn, flag in zip(bns, before):
            bn.update_stats = flag


class LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


def conv_bn_stack(c_in: int, features: int,
                  dtype: Optional[torch.dtype]) -> nn.Sequential:
    """conv3-BN-LeakyReLU(0.2)-conv3-BN, no trailing activation: the JAX
    package's ``ConvBlock`` (the encoder's ``inc``) and the residual branch
    of its ``_ResCore``.  Indices 0, 1, 3, 4 hold the parameters."""
    return nn.Sequential(
        Conv(c_in, features, 3, padding=1, dtype=dtype), BatchNorm(features),
        LeakyReLU(),
        Conv(features, features, 3, padding=1, dtype=dtype), BatchNorm(features))


class ResCore(nn.Module):
    """LeakyReLU(conv1x1(x) + [conv3-BN-LReLU-conv3-BN](x)): the JAX
    package's ``_ResCore``, with the reference's names ``conv_input`` (the
    1x1 shortcut) and ``conv`` (the residual branch)."""

    def __init__(self, c_in: int, features: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.conv_input = Conv(c_in, features, 1, dtype=dtype)
        self.conv = conv_bn_stack(c_in, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return leaky_relu(self.conv_input(x).to(h.dtype) + h)


class ResConvDown(ResCore):
    """Stride-2 pad-1 3x3 downsample (``F.conv2d``: the JAX package's
    default ``PALLAS_CONV_S2=0`` route), then the residual core."""

    def __init__(self, c_in: int, features: int, dtype: Optional[torch.dtype]):
        super().__init__(c_in, features, dtype)
        self.down = Conv(c_in, c_in, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.down(x))


class ConvTranspose2x2(nn.Module):
    """Stride-2 kernel-2 transposed conv with ``nn.ConvTranspose2d``'s state
    dict (weight (C_in, C_out, 2, 2)), computing in ``dtype``, bias added
    after in that dtype."""

    def __init__(self, c_in: int, c_out: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_in, c_out, 2, 2))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        with full_f32(dt):
            y = F.conv_transpose2d(x.to(dt), self.weight.to(dt), None, stride=2)
        return y + self.bias.to(dt)[:, None, None]


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """x2 nearest-neighbour upsample of NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class ResUp(ResCore):
    """x2 upsample ('NN' nearest or 'Conv2' k2s2 transposed conv), then the
    residual core."""

    def __init__(self, c_in: int, features: int, up_type: str,
                 dtype: Optional[torch.dtype]):
        super().__init__(c_in, features, dtype)
        if up_type == "Conv2":
            self.up = ConvTranspose2x2(c_in, c_in, dtype)
        elif up_type != "NN":
            raise NotImplementedError(f"up_type {up_type!r} is not ported")
        self.up_type = up_type

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.up(x) if self.up_type == "Conv2" else upsample_nearest(x)
        return super().forward(x)
