"""Custom layers: squeeze-and-excitation, self-attention and adaptive
norms, NCHW.

Counterpart of the JAX package's ``models/layers.py`` (the reference's
``custom_layers.py``).  Its layers built on flax's stock ``nn.Conv`` and
``nn.Dense`` draw their kernels from flax's default ``lecun_normal``
(:class:`PlainConv`, ``nn.Linear``; see ``train/predictor.py:
init_parameters``), and its norms built on flax's ``nn.BatchNorm`` follow
that class (:class:`BiasedBatchNorm`), not the JAX package's own BatchNorm.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BN_EPS,
    BN_MOMENTUM,
    InstanceNorm,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import Conv


class PlainConv(Conv):
    """A :class:`Conv` that stands for flax's stock ``nn.Conv`` with its
    default initialiser (``lecun_normal``: truncated, variance 1/fan_in, zero
    bias), where the JAX package's convs use ``he_normal``.  It routes like
    every :class:`Conv`."""


class BiasedBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over channel axis
    1, the norm of :class:`DomainSpecificBatchNorm` and
    :class:`BatchInstanceNorm`.  It differs from :class:`..blocks.BatchNorm`
    (the JAX package's own) in three ways: the running variance moves
    toward the *biased* batch variance, the variance is flax's fast
    ``E[x^2] - E[x]^2``, and the scale starts at 1.  Statistics in float32,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, the
    result in x's dtype.  ``affine=False`` has no scale and no bias."""

    def __init__(self, features: int, affine: bool = True):
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.ones(features))
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x32 = x.float()
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            mean = x32.mean(axes)
            var = torch.clamp((x32 * x32).mean(axes) - mean * mean, min=0.0)
            m = BN_MOMENTUM
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS)
        if self.weight is not None:
            mul = mul * self.weight
        y = (x32 - mean.view(shape)) * mul.view(shape)
        if self.bias is not None:
            y = y + self.bias.view(shape)
        return y.to(x.dtype)


class ChannelSELayer(nn.Module):
    """Squeeze-and-excitation over channels: the spatial mean through a
    bias-free ReLU MLP (C -> C / r -> C) and a sigmoid gate."""

    def __init__(self, channels: int, reduction_ratio: int = 2):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction_ratio, bias=False)
        self.fc2 = nn.Linear(channels // reduction_ratio, channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.fc1(x.mean((2, 3))))
        gate = torch.sigmoid(self.fc2(h))
        return x * gate[:, :, None, None]


class SpatialSELayer(nn.Module):
    """Spatial squeeze-and-excitation: a sigmoid gate from a 1x1 conv to
    one channel."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = PlainConv(channels, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.conv(x))


class ChannelSpatialSELayer(nn.Module):
    """The elementwise max of :class:`ChannelSELayer` and
    :class:`SpatialSELayer`."""

    def __init__(self, channels: int, reduction_ratio: int = 2):
        super().__init__()
        self.cse = ChannelSELayer(channels, reduction_ratio)
        self.sse = SpatialSELayer(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.maximum(self.cse(x), self.sse(x))


class SelfAttention(nn.Module):
    """SAGAN-style 2-D self-attention over the H W tokens: 1x1 query and
    key convs to max(C / 8, 1) channels and a 1x1 value conv, a softmax of
    float32 scores (cast back to x's dtype), ``gamma`` (starting at 0)
    times the attended values.  Returns ``(gamma out + x, gamma out,
    attention (N, HW, HW))``, the reference's 3-tuple."""

    def __init__(self, channels: int):
        super().__init__()
        d = max(channels // 8, 1)
        self.query = PlainConv(channels, d, 1)
        self.key = PlainConv(channels, d, 1)
        self.value = PlainConv(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor):
        n, c, h, w = x.shape
        q = self.query(x).reshape(n, -1, h * w).transpose(1, 2)
        k = self.key(x).reshape(n, -1, h * w).transpose(1, 2)
        v = self.value(x).reshape(n, c, h * w).transpose(1, 2)
        scores = torch.einsum("nqd,nkd->nqk", q.float(), k.float())
        attn = torch.softmax(scores, dim=-1).to(x.dtype)
        out = torch.einsum("nqk,nkc->nqc", attn, v).transpose(1, 2).reshape(n, c, h, w)
        weighted = self.gamma * out
        return weighted + x, weighted, attn


class DomainSpecificBatchNorm(nn.Module):
    """A bank of :class:`BiasedBatchNorm`, one per domain, selected by a
    static ``domain_id`` at each call: only the selected bank normalises
    and only its statistics move."""

    def __init__(self, features: int, num_domains: int = 2):
        super().__init__()
        self.banks = nn.ModuleList(BiasedBatchNorm(features) for _ in range(num_domains))

    def forward(self, x: torch.Tensor, domain_id: int) -> torch.Tensor:
        if not 0 <= domain_id < len(self.banks):
            raise ValueError(f"domain_id {domain_id} outside 0..{len(self.banks) - 1}")
        return self.banks[domain_id](x)


class BatchInstanceNorm(nn.Module):
    """A learnable blend of batch and instance norm, ``(rho bn + (1 - rho)
    in) gamma + beta`` with rho clipped to [0, 1]: bn is a scale-free
    :class:`BiasedBatchNorm`, in flax's ``GroupNorm`` with one channel a
    group (:class:`..blocks.InstanceNorm`: fast variance, eps 1e-5), both in
    x's dtype.  The clip is max-then-min, whose gradient at a bound is
    halved as JAX's is."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = BiasedBatchNorm(features, affine=False)
        self.inorm = InstanceNorm()
        self.rho = nn.Parameter(torch.ones(features))
        self.gamma = nn.Parameter(torch.ones(features))
        self.beta = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        bn, inm = self.bn(x), self.inorm(x).to(x.dtype)
        rho = torch.minimum(torch.maximum(self.rho, torch.zeros_like(self.rho)),
                            torch.ones_like(self.rho)).view(shape)
        return (rho * bn + (1.0 - rho) * inm) * self.gamma.view(shape) + self.beta.view(shape)


def adaptive_instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           eps: float = 1e-5) -> torch.Tensor:
    """AdaIN: instance-normalise NCHW ``x`` (two-pass variance) and apply
    the given style ``weight``/``bias`` ((C,) or broadcastable NCHW)."""
    return _adaptive_norm(x, weight, bias, eps, (2, 3))


def adaptive_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """AdaBN: batch-normalise NCHW ``x`` with its own statistics (two-pass
    variance) and apply the given ``weight``/``bias``."""
    return _adaptive_norm(x, weight, bias, eps, (0, 2, 3))


def _adaptive_norm(x, weight, bias, eps, axes):
    mean = x.mean(axes, keepdim=True)
    var = x.var(axes, unbiased=False, keepdim=True)
    if weight.dim() == 1:
        weight, bias = weight.view(1, -1, 1, 1), bias.view(1, -1, 1, 1)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def bilinear_additive_upsampling(x: torch.Tensor, to_channel: int) -> torch.Tensor:
    """x2 bilinear upsample (half-pixel centres, ``jax.image.resize``'s,
    which is PyTorch's align_corners=False for an upsample) and a sum over
    groups of C / to_channel consecutive channels."""
    n, c, h, w = x.shape
    if c % to_channel:
        raise ValueError(f"{c} channels do not split into {to_channel} groups")
    up = F.interpolate(x, size=(2 * h, 2 * w), mode="bilinear", align_corners=False)
    return up.reshape(n, to_channel, c // to_channel, 2 * h, 2 * w).sum(2)


def spatial_pyramid_pool(x: torch.Tensor, out_bin_sizes: Sequence[int] = (4, 2, 1)) -> torch.Tensor:
    """Spatial pyramid max pooling with the reference's windows: per level
    s, windows of ceil(h / s) at that stride, shifted by the padding
    ``(k s - h + 1) // 2`` and clipped to the image; each level flattened
    channel-major, the levels concatenated."""
    n, c, h, w = x.shape
    feats = []
    for size in out_bin_sizes:
        k_h, k_w = -(-h // size), -(-w // size)
        pad_h, pad_w = (k_h * size - h + 1) // 2, (k_w * size - w + 1) // 2
        bins_h = (h + 2 * pad_h - k_h) // k_h + 1
        bins_w = (w + 2 * pad_w - k_w) // k_w + 1
        rows = []
        for i in range(bins_h):
            y0, y1 = max(i * k_h - pad_h, 0), min(i * k_h - pad_h + k_h, h)
            rows.append(torch.stack([
                x[:, :, y0:y1, max(j * k_w - pad_w, 0):min(j * k_w - pad_w + k_w, w)].amax((2, 3))
                for j in range(bins_w)], dim=2))               # (n, c, bins_w)
        feats.append(torch.stack(rows, dim=2).reshape(n, -1))  # (n, c, bins_h, bins_w)
    return torch.cat(feats, dim=1)

