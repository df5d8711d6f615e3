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
reference's ``_disable_tracking_bn_stats``.  :func:`stacked_passes` runs
P passes of a module stacked along the batch axis as P sequential passes
would run (each slice on its own batch statistics, the running statistics
moved in pass order by the passes that track them): the JAX package's
vmapped pass batches (``FUSED_STN``, ``FUSED_FTN``).

The baselines' blocks (the JAX package's ``Norm``, ``SNConv``,
``upsample_bilinear`` and ``ResUp``'s ``bilinear`` and ``Conv4`` arms) are
here too: :func:`norm_layer` (batch, instance or none), :class:`SNConv`
(flax's spectral normalisation, one power iteration a call),
:func:`upsample_bilinear` (align_corners=True) and the general
:class:`ConvTranspose`.

Layer dropout (the JAX package's ``encoder_dropout``/``decoder_dropout``):
channel dropout at the end of each :class:`ResCore` in train mode, one
keep mask shared over H and W.  The masks are operands: a caller hands a
module forward its (N, C) keep masks in forward order with
:func:`dropout_masks`, and a train-mode ResCore with a rate refuses to run
without one.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
    Conv,
    eligible_channels,
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

    ``passes`` (set by :func:`stacked_passes`): a train-mode batch of P*N
    is P passes of N stacked in order; each is normalized with its own
    batch mean and biased variance, and the running statistics move once
    for each pass whose flag is True, in pass order, each by its own
    Bessel factor (n = N*H*W), as P sequential train-mode calls would move
    them.

    ``mesh`` (set by ``parallel/mesh.py:shard_train_step``): this rank's
    batch is its shard of a global batch, and train mode takes the global
    batch's statistics (per pass when stacked) through a differentiable
    all-reduce (``Mesh.batch_moments``), n the global count, so that the
    output, the gradients and the running statistics are those of one
    process on the whole batch, as under ``pjit`` in the JAX package.
    Without a mesh nothing of this runs.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.update_stats = True
        self.passes: Optional[Tuple[bool, ...]] = None
        self.mesh = None

    def _track(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """Move the running statistics toward one pass's batch mean and
        unbiased variance (``n`` values a channel)."""
        unbiased = var.detach() * (n / (n - 1.0)) if n > 1 else var.detach()
        m = BN_MOMENTUM
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.detach())
            self.running_var.copy_(m * self.running_var + (1.0 - m) * unbiased)

    def _forward_stacked(self, x: torch.Tensor) -> torch.Tensor:
        p = len(self.passes)
        if x.shape[0] % p:
            raise ValueError(f"a stacked batch of {x.shape[0]} is not {p} equal passes")
        xs = x.float().reshape(p, x.shape[0] // p, *x.shape[1:])
        axes = [1] + list(range(3, xs.dim()))
        shape = (p, 1, -1) + (1,) * (xs.dim() - 3)
        if self.mesh is None:
            mean = xs.mean(axes)                               # (P, C)
            var = (xs - mean.view(shape)).square().mean(axes)
            n = xs[0].numel() // x.shape[1]
        else:
            mean, var, n = self.mesh.batch_moments(xs, axes)
            mean, var = mean.view(p, -1), var.view(p, -1)
        if self.update_stats:
            for i, track in enumerate(self.passes):
                if track:
                    self._track(mean[i], var[i], n)
        w = self.weight.view((1, 1, -1) + (1,) * (xs.dim() - 3))
        b = self.bias.view((1, 1, -1) + (1,) * (xs.dim() - 3))
        y = (xs - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS) * w + b
        return y.reshape(x.shape).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.passes is not None:
            return self._forward_stacked(x)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        x32 = x.float()
        if self.training:
            axes = [0] + list(range(2, x.dim()))
            if self.mesh is None:
                mean = x32.mean(axes)
                var = (x32 - mean.view(shape)).square().mean(axes)
                n = x.numel() // x.shape[1]
            else:
                mean, var, n = self.mesh.batch_moments(x32, axes)
                mean, var = mean.view(-1), var.view(-1)
            if self.update_stats:
                self._track(mean, var, n)
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


@contextmanager
def stacked_passes(*modules: nn.Module, update_flags: Optional[Sequence[bool]]):
    """Train-mode BatchNorms of ``modules`` take their input as
    ``len(update_flags)`` passes stacked along the batch axis while the
    block runs (see :class:`BatchNorm`), the running statistics moved by
    the passes whose flag is True; ``update_flags=None`` runs them
    unstacked.  Inside :func:`frozen_stats` no pass moves them.  Nothing is
    read back, so a stacked step captures into a CUDA graph."""
    bns = [m for mod in modules for m in mod.modules() if isinstance(m, BatchNorm)]
    before = [bn.passes for bn in bns]
    flags = None if update_flags is None else tuple(bool(f) for f in update_flags)
    for bn in bns:
        bn.passes = flags
    try:
        yield
    finally:
        for bn, passes in zip(bns, before):
            bn.passes = passes


def stacked_flags(module: nn.Module) -> Optional[Tuple[bool, ...]]:
    """The pass flags :func:`stacked_passes` set on ``module``'s BatchNorms
    (None when unstacked)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            return m.passes
    return None


_MASKS: list = []  # the active dropout_masks blocks' iterators, innermost last


@contextmanager
def dropout_masks(masks: Sequence[torch.Tensor]):
    """Hand the train-mode ResCores that run in the block their channel
    keep masks, one (N, C) 0/1 tensor each, in forward order; the block
    must consume every one (``RuntimeError`` otherwise)."""
    it = [iter(masks), len(masks), 0]
    _MASKS.append(it)
    try:
        yield
    finally:
        _MASKS.pop()
    if it[2] != it[1]:
        raise RuntimeError(f"dropout: {it[1]} keep masks given, {it[2]} used")


def _next_mask() -> torch.Tensor:
    if not _MASKS:
        raise RuntimeError("layer dropout in train mode needs its keep masks "
                           "(models.blocks.dropout_masks; StepDraws.dropout in a train step)")
    it = _MASKS[-1]
    try:
        mask = next(it[0])
    except StopIteration:
        raise RuntimeError(f"dropout: all {it[1]} keep masks used, another asked for") from None
    it[2] += 1
    return mask


def channel_dropout(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """flax's ``nn.Dropout(rate, broadcast_dims=(1, 2))`` on NCHW ``x``
    with the (N, C) keep mask ``keep``: ``where(keep, x / (1 - rate), 0)``
    in x's dtype."""
    keep = keep.to(device=x.device, dtype=torch.bool).view(*keep.shape, *([1] * (x.dim() - 2)))
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def layer_dropout(x: torch.Tensor, rate: Optional[float], training: bool) -> torch.Tensor:
    """flax's ``nn.Dropout(rate, broadcast_dims=(1, 2))`` at a call site:
    in train mode with a rate, :func:`channel_dropout` on the next mask of
    :func:`dropout_masks`; otherwise ``x``."""
    if rate and training:
        return channel_dropout(x, _next_mask(), rate)
    return x


class LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(x)


def conv_bn_stack(c_in: int, features: int, dtype: Optional[torch.dtype],
                  conv_nl: bool = False) -> nn.Sequential:
    """conv3-BN-LeakyReLU(0.2)-conv3-BN, no trailing activation: the JAX
    package's ``ConvBlock`` (the encoder's ``inc``) and the residual branch
    of its ``_ResCore``.  Indices 0, 1, 3, 4 hold the parameters.  With
    ``conv_nl`` (the JAX package's ``PALLAS_CONV_NL=1``) both 3x3 convs go to
    K5 where their channels pass the NL rule (:meth:`Conv.uses_k5`), as they
    are the JAX package's dispatching ``Conv``."""
    return nn.Sequential(
        Conv(c_in, features, 3, padding=1, dtype=dtype, k5=conv_nl), BatchNorm(features),
        LeakyReLU(),
        Conv(features, features, 3, padding=1, dtype=dtype, k5=conv_nl),
        BatchNorm(features))


class ResCore(nn.Module):
    """LeakyReLU(conv1x1(x) + [conv3-BN-LReLU-conv3-BN](x)): the JAX
    package's ``_ResCore``, with the reference's names ``conv_input`` (the
    1x1 shortcut) and ``conv`` (the residual branch).  ``conv_nl`` reaches
    the residual branch's two 3x3 convs only, never the shortcut.  With a
    ``dropout`` rate, train mode ends with :func:`channel_dropout` on the
    next mask of :func:`dropout_masks`."""

    def __init__(self, c_in: int, features: int, dtype: Optional[torch.dtype],
                 conv_nl: bool = False, dropout: Optional[float] = None):
        super().__init__()
        self.conv_input = Conv(c_in, features, 1, dtype=dtype)
        self.conv = conv_bn_stack(c_in, features, dtype, conv_nl)
        self.dropout = dropout if dropout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return layer_dropout(leaky_relu(self.conv_input(x).to(h.dtype) + h), self.dropout,
                             self.training)


class ResConvDown(ResCore):
    """Stride-2 pad-1 3x3 downsample, then the residual core.

    The downsample runs on ``F.conv2d`` by default (the JAX package's
    default ``PALLAS_CONV_S2=0`` route).  With ``conv_s2`` it runs on K4
    wherever the JAX package's ``s2_chain_ok`` holds: max(C_in, features)
    <= 64, and even H and W (checked per call by :class:`Conv`).  The JAX
    package's CHW stage chaining around it is a layout change only, and in
    NCHW the (N, C, H*W) kernel layout is a free view, so nothing else
    changes route.  The parameters are the same under both routes.
    ``conv_nl`` reaches the residual core, never the downsample."""

    def __init__(self, c_in: int, features: int, dtype: Optional[torch.dtype],
                 conv_s2: bool = False, conv_nl: bool = False, dropout: Optional[float] = None):
        super().__init__(c_in, features, dtype, conv_nl, dropout)
        self.down = Conv(c_in, c_in, 3, stride=2, padding=1, dtype=dtype,
                         k4=conv_s2 and eligible_channels(c_in, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(self.down(x))


class ConvTranspose(nn.Module):
    """Transposed conv with ``nn.ConvTranspose2d``'s (or ``3d``'s) state
    dict, weight (C_in, C_out, *kernel), 2-D or 3-D by the kernel's rank,
    computing in ``dtype`` (None: the input's) on ``F.conv_transpose*``
    (full f32 when f32, :func:`full_f32`), bias added after in that dtype.

    flax's ``ConvTranspose(kernel, strides, padding="SAME")`` is this with
    ``padding = k - 1 - a`` on each axis, where ``a`` is the low padding
    ``lax.conv_transpose`` gives the dilated input (``a = k - 1`` when
    ``s > k - 1``, else ``ceil((k + s - 2) / 2)``): k2s2 -> 0, k4s2 -> 1,
    k1s1 -> 0.  flax does not flip the kernel and PyTorch does, so
    ``convert`` flips it."""

    def __init__(self, c_in: int, c_out: int, kernel_size: Sequence[int],
                 stride: Sequence[int], padding: Sequence[int], dtype: Optional[torch.dtype]):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_in, c_out, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.stride = tuple(stride)
        self.padding = tuple(padding)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        fn = F.conv_transpose2d if self.weight.dim() == 4 else F.conv_transpose3d
        with full_f32(dt):
            y = fn(x.to(dt), self.weight.to(dt), None, stride=self.stride, padding=self.padding)
        return y + self.bias.to(dt).view(-1, *([1] * (self.weight.dim() - 2)))


class ConvTranspose2x2(ConvTranspose):
    """Stride-2 kernel-2 transposed conv (the decoders' ``Conv2`` upsample)."""

    def __init__(self, c_in: int, c_out: int, dtype: Optional[torch.dtype]):
        super().__init__(c_in, c_out, (2, 2), (2, 2), (0, 0), dtype)


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """x2 nearest-neighbour upsample of NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _corner_coords(out_n: int, in_n: int, device) -> torch.Tensor:
    if out_n == 1 or in_n == 1:
        return torch.zeros(out_n, device=device)
    return torch.arange(out_n, dtype=torch.float32, device=device) * ((in_n - 1) / (out_n - 1))


def upsample_bilinear(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """align_corners=True bilinear upsample of NCHW ``x`` by ``factor`` in
    one step (the JAX package's ``upsample_bilinear``): output row i reads
    input coordinate ``i (h - 1) / (H - 1)``, in float32; the fractions are
    cast to x's dtype and the blend runs in it, as there."""
    n, c, h, w = x.shape
    oh, ow = h * factor, w * factor
    ys, xs = _corner_coords(oh, h, x.device), _corner_coords(ow, w, x.device)
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    fy = (ys - y0).view(1, 1, oh, 1).to(x.dtype)
    fx = (xs - x0).view(1, 1, 1, ow).to(x.dtype)
    rows0, rows1 = x.index_select(2, y0), x.index_select(2, y1)
    top = rows0.index_select(3, x0) * (1 - fx) + rows0.index_select(3, x1) * fx
    bot = rows1.index_select(3, x0) * (1 - fx) + rows1.index_select(3, x1) * fx
    return top * (1 - fy) + bot * fy


class InstanceNorm(nn.Module):
    """flax's ``nn.InstanceNorm(epsilon=1e-5, use_scale=False,
    use_bias=False, dtype=float32)``: per sample and channel over every
    axis after 1, mean and flax's fast variance ``E[x^2] - E[x]^2``
    (clamped at 0), in float32, output float32.  No parameters, no
    running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        axes = list(range(2, x.dim()))
        mean = x32.mean(axes, keepdim=True)
        var = torch.clamp((x32 * x32).mean(axes, keepdim=True) - mean * mean, min=0.0)
        return (x32 - mean) * torch.rsqrt(var + BN_EPS)


def norm_layer(kind: str, features: int) -> nn.Module:
    """The JAX package's ``Norm(kind)``: ``batch`` (:class:`BatchNorm`),
    ``instance`` (:class:`InstanceNorm`) or ``none`` (identity)."""
    if kind == "batch":
        return BatchNorm(features)
    if kind == "instance":
        return InstanceNorm()
    if kind == "none":
        return nn.Identity()
    raise NotImplementedError(f"unknown norm kind {kind!r}")


SN_EPS = 1e-12


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    return v * torch.rsqrt((v * v).sum() + SN_EPS)


def power_iteration(weight: torch.Tensor, u: torch.Tensor):
    """One step of flax's power iteration on the OIHW ``weight`` as a
    (C_out, taps) matrix from ``u`` (1, C_out): ``(sigma, u')``, sigma with
    a gradient to ``weight``, u' without (see :class:`SNConv`)."""
    mat = weight.reshape(weight.shape[0], -1)
    with torch.no_grad():
        v = _l2_normalize(u @ mat)
        u_new = _l2_normalize(v @ mat.t())
    return ((v @ mat.t()) @ u_new.t())[0, 0], u_new


class SNConv(Conv):
    """Stride-1 SAME conv with optional spectral normalisation, the JAX
    package's ``SNConv`` (flax ``nn.SpectralNorm``, one power iteration,
    eps 1e-12), on :class:`Conv`'s routes.

    With ``if_SN`` every call runs one power iteration from the stored
    ``u`` (1, C_out) on the kernel as a matrix W (rows: the C_in x kh x kw
    taps, columns: C_out; a permutation of flax's rows, which changes
    neither u nor sigma): ``v = l2n(u W^T)``, ``u' = l2n(v W)``, both
    without gradient; ``sigma = v W u'^T`` carries a gradient to the kernel,
    and the conv runs on ``kernel / sigma`` (float32; cast to the compute
    dtype by :meth:`Conv.conv`).  Train mode stores ``u'`` and ``sigma``;
    eval mode stores nothing but still iterates (flax's eval output depends
    on the stored ``u``).  PyTorch's ``spectral_norm`` differs (no
    iteration in eval, a stored ``v``)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3, if_SN: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(c_in, c_out, kernel_size, padding=kernel_size // 2, dtype=dtype)
        self.if_SN = if_SN
        if if_SN:
            self.register_buffer("u", torch.zeros(1, c_out))
            self.register_buffer("sigma", torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.if_SN:
            return super().forward(x)
        return self.conv(x, self.normalized_weight())

    def normalized_weight(self) -> torch.Tensor:
        sigma, u = power_iteration(self.weight, self.u)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class ResUp(ResCore):
    """x2 upsample, then the residual core (``conv_nl`` and ``dropout`` as
    for :class:`ResCore`): ``up_type`` 'NN' (nearest), 'bilinear'
    (:func:`upsample_bilinear`), 'Conv2' (k2s2 transposed conv) or 'Conv4'
    (k4s2 "SAME" transposed conv, PyTorch's k4s2p1), the transposed convs
    keeping the channels."""

    def __init__(self, c_in: int, features: int, up_type: str,
                 dtype: Optional[torch.dtype], conv_nl: bool = False,
                 dropout: Optional[float] = None):
        super().__init__(c_in, features, dtype, conv_nl, dropout)
        if up_type == "Conv2":
            self.up = ConvTranspose2x2(c_in, c_in, dtype)
        elif up_type == "Conv4":
            self.up = ConvTranspose(c_in, c_in, (4, 4), (2, 2), (1, 1), dtype)
        elif up_type not in ("NN", "bilinear"):
            raise NotImplementedError(f"unknown up_type {up_type!r}")
        self.up_type = up_type

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up_type == "NN":
            x = upsample_nearest(x)
        elif self.up_type == "bilinear":
            x = upsample_bilinear(x)
        else:
            x = self.up(x)
        return super().forward(x)
