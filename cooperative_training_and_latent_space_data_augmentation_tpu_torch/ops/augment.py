"""On-device data augmentation, batched, with the random draws as operands.

Counterpart of the JAX package's ``ops/augment.py`` (the training policy
pipeline and the evaluation transform).  The JAX package vmaps one sample's
pipeline over the batch and draws inside it from a key; here every stage
works on the whole batch (leading axis N) and takes its raw draws as
tensors, an :class:`AugmentDraws` made by :func:`draw_augment` from a CPU
``torch.Generator`` (tests replay the JAX key schedule into one).  The
draws are raw ``[0, 1)`` uniforms and unit normals; each stage scales them
as ``jax.random.uniform`` does, ``max(lo, u * (hi - lo) + lo)`` in float32.
Every stage whose probability is above 0 is computed for every sample and
selected per sample with ``torch.where`` on its gate, so no branch waits
for the device.

Stages, in the reference's order: pad -> flip -> bias field v1 -> bias
field v2 -> brightness/contrast -> gamma -> one composed geometric warp
(affine with the 45-degree group rotation, the dense elastic field, the
coarse 3x3 elastic field; the centre crop folded into its sample grid) ->
min-max normalise.  The warp is order-3 B-spline sampling (:mod:`.spline`):
the image ('reflect' coefficients, zero outside the frame) and the one-hot
label classes 1..C-1 (scipy 'nearest' coefficients, the ascending
``>= 0.5`` overwrite) share one coefficient stack and one gather, the
arithmetic of the JAX package's per-pixel gather (``FUSED_WARP=1``).

:func:`warp_image` samples an image alone (the corruptions' motion
model).  The warp's other arms are a keyword of the pipeline, ``warp``
(:data:`WARPS`): ``"composed"`` is the above (the JAX package's default),
``"two_gather"`` samples the image and the label with separate gathers,
:func:`warp_image_batch` and :func:`warp_label_batch` (its
``FUSED_WARP=0``), and ``"sequential"`` resamples the reference's way, the
affine at the padded size and then the elastic field composed with the
crop, each a composed image+label warp (its ``SEQ_WARP=1``; two gathers of
interpolation blur).  :func:`eval_transform_sample`, :class:`Transformations`
(the reference's named pipelines), :func:`motion_estimation` (inter-slice
shifts of a label stack, its normals drawn by :func:`draw_motion`) and
:func:`clahe` (numpy, host side) complete the JAX module.  Its
``TILED_WARP`` evaluation is a TPU rewrite of the gather and is not
ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from functools import lru_cache
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import spline

# the geometric warp's arms (see the module docstring)
WARPS = ("composed", "two_gather", "sequential")

# --------------------------------------------------------------- policy cfg
@dataclass(frozen=True)
class AugmentPolicy:
    """Mirror of the reference policy dicts (transform.py:115-314)."""

    # geometric
    flip_h: bool = False
    flip_v: bool = False
    flip_p: float = 0.0
    shift_val: Tuple[float, float] = (0.0, 0.0)
    rotate_val: float = 0.0
    scale_val: Tuple[float, float] = (1.0, 1.0)
    shear_val: float = 0.0
    rotate_groups: Tuple[float, ...] = ()
    # intensity
    intensity_prob: float = 0.0
    contrast_range: Tuple[float, float] = (0.8, 1.2)
    brightness_range: Tuple[float, float] = (-0.1, 0.1)
    gamma_prob: float = 0.0
    gamma_range: Tuple[float, float] = (0.8, 1.2)
    # elastic
    elastic_prob: float = 0.0
    elastic_prob_v2: float = 0.0
    # bias field v1
    perturb_prob: float = 0.0
    max_sigma: float = 16.0
    multi_control_points: Tuple[int, ...] = (4,)
    perturb_magnitude: float = 0.3
    add_noise: bool = False
    noise_epsilon: float = 0.01
    # bias field v2
    perturb_v2_prob: float = 0.0
    perturb_v2_magnitude: float = 0.2
    ms_control_point_spacing: Tuple[int, ...] = (32,)
    perturb_v2_add_noise: bool = False
    perturb_v2_noise_epsilon: float = 0.01


def _p(**kw) -> AugmentPolicy:
    return AugmentPolicy(**kw)


_ACDC_AFFINE = dict(flip_h=True, flip_v=True, flip_p=0.2, shift_val=(0.1, 0.1),
                    rotate_val=15.0, scale_val=(0.8, 1.1),
                    rotate_groups=tuple(45.0 * i for i in range(8)))

# policy registry (transform.py:16-42 + the policy methods :115-314)
POLICIES: Dict[str, AugmentPolicy] = {
    "no_aug": _p(),
    "scale": _p(scale_val=(0.8, 1.2)),
    "gamma": _p(gamma_prob=0.5),
    "gamma_scale": _p(gamma_prob=0.5, scale_val=(0.9, 1.1)),
    "affine": _p(shift_val=(0.1, 0.1), rotate_val=15.0, scale_val=(0.9, 1.1)),
    "elastic": _p(elastic_prob=1.0),
    "elastic_v2": _p(elastic_prob_v2=1.0),
    "elastic_scale": _p(elastic_prob=0.5, scale_val=(0.9, 1.1)),
    "gamma_elastic": _p(gamma_prob=0.5, elastic_prob=0.5),
    "affine_elastic": _p(shift_val=(0.1, 0.1), rotate_val=15.0,
                         scale_val=(0.9, 1.1), elastic_prob=0.5),
    "affine_gamma": _p(shift_val=(0.1, 0.1), rotate_val=15.0,
                       scale_val=(0.9, 1.1), gamma_prob=0.5),
    "affine_gamma_elastic": _p(shift_val=(0.1, 0.1), rotate_val=15.0,
                               scale_val=(0.9, 1.1), gamma_prob=0.5,
                               elastic_prob=0.5),
    "ACDC_affine": _p(**_ACDC_AFFINE),
    "ACDC_affine_intensity": _p(**_ACDC_AFFINE, intensity_prob=0.5),
    "ACDC_affine_elastic": _p(**_ACDC_AFFINE, elastic_prob=0.5),
    "ACDC_affine_elastic_intensity": _p(**_ACDC_AFFINE, intensity_prob=0.5,
                                        elastic_prob=0.5),
    "ACDC_affine_elastic_intensity_v2": _p(**_ACDC_AFFINE, intensity_prob=0.5,
                                           elastic_prob_v2=0.5),
    "ACDC_affine_perturb": _p(**_ACDC_AFFINE, perturb_prob=0.5, max_sigma=16,
                              multi_control_points=(2, 4, 8), add_noise=True),
    "ACDC_affine_perturb_v2": _p(**_ACDC_AFFINE, perturb_v2_prob=0.5,
                                 perturb_v2_magnitude=0.3,
                                 ms_control_point_spacing=(64, 1),
                                 perturb_v2_add_noise=True),
    "ACDC_affine_elastic_bias": _p(**_ACDC_AFFINE, perturb_v2_prob=0.5,
                                   perturb_v2_magnitude=0.3,
                                   ms_control_point_spacing=(64, 1),
                                   perturb_v2_add_noise=True, elastic_prob=0.5),
    "ACDC_affine_all": _p(**_ACDC_AFFINE, perturb_v2_prob=0.5,
                          perturb_v2_magnitude=0.3,
                          ms_control_point_spacing=(64, 1),
                          perturb_v2_add_noise=True, elastic_prob=0.5,
                          intensity_prob=0.5),
    "Atrial_basic": _p(flip_h=True, flip_v=True, flip_p=0.5,
                       shift_val=(0.1, 0.1), rotate_val=10.0,
                       scale_val=(0.7, 1.3), gamma_range=(0.8, 2.0),
                       gamma_prob=0.5),
    "Atrial_perturb": _p(flip_h=True, flip_v=True, flip_p=0.5,
                         shift_val=(0.1, 0.1), rotate_val=10.0,
                         scale_val=(0.7, 1.3), gamma_range=(0.8, 2.0),
                         gamma_prob=0.5, perturb_prob=0.5, max_sigma=16,
                         multi_control_points=(2, 4, 8)),
    "Prostate_affine_elastic_intensity": _p(flip_h=True, flip_v=True, flip_p=0.5,
                                            shift_val=(0.1, 0.1), rotate_val=15.0,
                                            scale_val=(0.8, 1.2),
                                            intensity_prob=0.5, elastic_prob=0.5),
}


def get_policy(name: str) -> AugmentPolicy:
    if name not in POLICIES:
        raise KeyError(f"unknown augmentation policy {name!r}; have {sorted(POLICIES)}")
    return POLICIES[name]


def _needs_geometry(policy: AugmentPolicy) -> bool:
    return bool(policy.rotate_val > 0 or policy.shift_val != (0.0, 0.0)
                or policy.scale_val != (1.0, 1.0) or policy.shear_val > 0
                or policy.rotate_groups or policy.elastic_prob > 0
                or policy.elastic_prob_v2 > 0)


# ------------------------------------------------------------------- draws
@dataclass
class AugmentDraws:
    """The raw draws of one batch's augmentation, per sample (leading N).

    Uniforms are ``[0, 1)`` and normals unit, float32; a field is None where
    the policy draws nothing for it (a stage of probability 0, or a flip
    axis or the geometry the policy lacks).  H, W are the padded size.

    flip_h, flip_v: (N,) coins.  bias1_grids: one (N, cp, cp) grid per
    control point count in ``sorted(multi_control_points)``; bias1_noise:
    (N, H, W, C) (``add_noise`` only).  bias2_knots: (N, n_h, n_w);
    bias2_noise: (N, H, W, C) (``perturb_v2_add_noise`` only).  contrast,
    brightness, gamma: (N,).  rotation, shift_y, shift_x, shear, zoom:
    (N,); group: (N,) int64, the index into ``rotate_groups``.
    elastic_alpha, elastic_sigma: (N,); elastic_dx, elastic_dy: (N, H, W).
    coarse_dx, coarse_dy: (N, 3, 3) normals.  gate_*: (N,) uniforms, a
    stage applies where its gate is below its probability."""

    flip_h: Optional[torch.Tensor] = None
    flip_v: Optional[torch.Tensor] = None
    bias1_grids: Optional[Tuple[torch.Tensor, ...]] = None
    bias1_noise: Optional[torch.Tensor] = None
    bias2_knots: Optional[torch.Tensor] = None
    bias2_noise: Optional[torch.Tensor] = None
    contrast: Optional[torch.Tensor] = None
    brightness: Optional[torch.Tensor] = None
    gamma: Optional[torch.Tensor] = None
    rotation: Optional[torch.Tensor] = None
    shift_y: Optional[torch.Tensor] = None
    shift_x: Optional[torch.Tensor] = None
    shear: Optional[torch.Tensor] = None
    zoom: Optional[torch.Tensor] = None
    group: Optional[torch.Tensor] = None
    elastic_alpha: Optional[torch.Tensor] = None
    elastic_sigma: Optional[torch.Tensor] = None
    elastic_dx: Optional[torch.Tensor] = None
    elastic_dy: Optional[torch.Tensor] = None
    coarse_dx: Optional[torch.Tensor] = None
    coarse_dy: Optional[torch.Tensor] = None
    gate_bias1: Optional[torch.Tensor] = None
    gate_bias2: Optional[torch.Tensor] = None
    gate_intensity: Optional[torch.Tensor] = None
    gate_gamma: Optional[torch.Tensor] = None
    gate_elastic: Optional[torch.Tensor] = None
    gate_coarse: Optional[torch.Tensor] = None

    def to(self, device) -> "AugmentDraws":
        moved = {}
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, tuple):
                moved[f.name] = tuple(t.to(device) for t in v)
            elif v is not None:
                moved[f.name] = v.to(device)
        return replace(self, **moved)


# each gate of AugmentDraws -> the policy field that holds its probability
GATES = {"flip_h": "flip_p", "flip_v": "flip_p", "gate_bias1": "perturb_prob",
         "gate_bias2": "perturb_v2_prob", "gate_intensity": "intensity_prob",
         "gate_gamma": "gamma_prob", "gate_elastic": "elastic_prob",
         "gate_coarse": "elastic_prob_v2"}


def _v2_geometry(h: int, w: int, policy: AugmentPolicy):
    """Bias field v2's (spacing, ext_h, ext_w, n_h, n_w): the canvas
    extended by 1.5 spacings and its knot counts."""
    spacing = max(int(policy.ms_control_point_spacing[0]), 1)
    ext_h = int(round(h + spacing * 1.5))
    ext_w = int(round(w + spacing * 1.5))
    n_h = len(range(-(ext_h // 2), ext_h // 2 + 1, spacing))
    n_w = len(range(-(ext_w // 2), ext_w // 2 + 1, spacing))
    return spacing, ext_h, ext_w, n_h, n_w


def draw_augment(generator: torch.Generator, policy: AugmentPolicy, n: int,
                 pad_hw: Tuple[int, int], image_ch: int = 1,
                 device: Union[str, torch.device, None] = None) -> AugmentDraws:
    """The draws of one batch of ``n`` samples padded to ``pad_hw`` under
    ``policy``, on the host from a CPU ``generator``, moved to ``device``
    (default: left on the CPU).  The fields are drawn at the padded size and
    cropped after, so no draw depends on the crop."""
    if generator.device.type != "cpu":
        raise ValueError("augmentation draws are made on the host from a CPU generator; "
                         "move them to the device with AugmentDraws.to")
    h, w = pad_hw

    def u(*shape):
        return torch.rand((n, *shape), generator=generator)

    def g(*shape):
        return torch.randn((n, *shape), generator=generator)

    kw = {}
    if policy.flip_p > 0:
        if policy.flip_h:
            kw["flip_h"] = u()
        if policy.flip_v:
            kw["flip_v"] = u()
    if policy.perturb_prob > 0:
        kw["bias1_grids"] = tuple(u(cp, cp) for cp in sorted(policy.multi_control_points))
        if policy.add_noise:
            kw["bias1_noise"] = g(h, w, image_ch)
        kw["gate_bias1"] = u()
    if policy.perturb_v2_prob > 0:
        _, _, _, n_h, n_w = _v2_geometry(h, w, policy)
        kw["bias2_knots"] = u(n_h, n_w)
        if policy.perturb_v2_add_noise:
            kw["bias2_noise"] = g(h, w, image_ch)
        kw["gate_bias2"] = u()
    if policy.intensity_prob > 0:
        kw.update(contrast=u(), brightness=u(), gate_intensity=u())
    if policy.gamma_prob > 0:
        kw.update(gamma=u(), gate_gamma=u())
    if _needs_geometry(policy):
        kw.update(rotation=u(), shift_y=u(), shift_x=u(), shear=u(), zoom=u())
        if policy.rotate_groups:
            kw["group"] = torch.randint(0, len(policy.rotate_groups), (n,), generator=generator)
        if policy.elastic_prob > 0:
            kw.update(elastic_alpha=u(), elastic_sigma=u(), elastic_dx=u(h, w),
                      elastic_dy=u(h, w), gate_elastic=u())
        if policy.elastic_prob_v2 > 0:
            kw.update(coarse_dx=g(3, 3), coarse_dy=g(3, 3), gate_coarse=u())
    draws = AugmentDraws(**kw)
    return draws if device is None else draws.to(device)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform``'s scaling of raw [0, 1) draws to [lo, hi):
    ``max(lo, u * (hi - lo) + lo)`` with lo, hi and hi - lo in float32."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi32 - lo32) + float(lo32), min=float(lo32))


def _gate(u: torch.Tensor, prob: float, ndim: int) -> torch.Tensor:
    """Per-sample choice ``u < prob``, shaped to broadcast over ``ndim``
    dims."""
    return (u < prob).view(-1, *([1] * (ndim - 1)))


@lru_cache(maxsize=None)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


# ------------------------------------------------------------ basic helpers
def pad_to(x: torch.Tensor, pad_hw: Tuple[int, int]) -> torch.Tensor:
    """Center zero-pad the spatial dims (1, 2) of NHWC/NHW batches to at
    least pad_hw (ts.PadNumpy); an odd pad puts its extra pixel on the
    leading side."""
    h, w = x.shape[1], x.shape[2]
    ph = max(0, pad_hw[0] - h)
    pw = max(0, pad_hw[1] - w)
    pads = [pw // 2 + pw % 2, pw // 2, ph // 2 + ph % 2, ph // 2]
    if x.ndim == 4:
        pads = [0, 0] + pads
    return F.pad(x, pads)


def center_crop(x: torch.Tensor, crop_hw: Tuple[int, int]) -> torch.Tensor:
    """Center crop of the spatial dims (1, 2) of NHWC/NHW batches
    (MySpecialCrop crop_type=0)."""
    h, w = x.shape[1], x.shape[2]
    hs = (h - crop_hw[0]) // 2
    ws = (w - crop_hw[1]) // 2
    return x[:, hs:hs + crop_hw[0], ws:ws + crop_hw[1]]


def percentile_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Per-sample min-max to [0, 1] (MyNormalizeMedicPercentile,
    intensity_transform.py:216-269): the JAX package takes the 0th and
    100th percentiles, which are the min and the max.  The low-anchored
    ``(x - lo) * (1 / (hi - lo + eps))`` form maps a constant slice to 0."""
    dims = tuple(range(1, x.ndim))
    lo = x.amin(dim=dims, keepdim=True)
    hi = x.amax(dim=dims, keepdim=True)
    return (x - lo) * (1.0 / (hi - lo + eps))


@lru_cache(maxsize=None)
def _freq2(h: int, w: int, device: torch.device) -> torch.Tensor:
    """``fftfreq(h)[:, None] ** 2 + rfftfreq(w)[None, :] ** 2`` in float32."""
    fy = np.fft.fftfreq(h).astype(np.float32)[:, None]
    fx = np.fft.rfftfreq(w).astype(np.float32)[None, :]
    return torch.from_numpy(fy ** 2 + fx ** 2).to(device)


def fft_gaussian_blur(x: torch.Tensor, sigma: Union[float, torch.Tensor]) -> torch.Tensor:
    """2-D Gaussian blur over the last two axes of ``x`` (..., H, W) with
    one ``sigma``, or one a field (a tensor broadcast over the leading
    axes), via rFFT
    (circular boundary): the transfer function of a Gaussian is
    exp(-2 pi^2 sigma^2 f^2)."""
    h, w = x.shape[-2], x.shape[-1]
    if torch.is_tensor(sigma):
        sigma = sigma.reshape(sigma.shape + (1, 1))
    transfer = torch.exp(-2.0 * (math.pi ** 2) * (sigma ** 2) * _freq2(h, w, x.device))
    return torch.fft.irfft2(torch.fft.rfft2(x) * transfer, s=(h, w))


@lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float32 weights of ``jax.image.resize(..., "bicubic")``
    along one axis (``jax/_src/image/scale.py:compute_weight_mat``, antialias
    on): Keys' cubic kernel with a = -0.5 at the sample positions
    ``(o + 0.5) / scale - 0.5``, each output's weights normalised by their
    sum and zeroed where the position lies outside ``[-0.5, n_in - 0.5]``.
    Not ``F.interpolate(mode="bicubic")``, whose kernel has a = -0.75."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    weights = np.where(x >= 2.0, f32(0.0), out).astype(f32)
    total = weights.sum(axis=0, keepdims=True, dtype=f32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32).T.copy()


@lru_cache(maxsize=None)
def _resize_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(resize_matrix(n_in, n_out)).to(device)


def resize_bicubic(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (h, w), "bicubic")`` over the last two axes of
    ``x`` (..., a, b): one static weight matrix an axis."""
    r_h = _resize_on(x.shape[-2], hw[0], x.device)
    r_w = _resize_on(x.shape[-1], hw[1], x.device)
    return torch.matmul(torch.matmul(r_h, x), r_w.t())


# ------------------------------------------------------------ random fields
def _affine_inverse_matrix(d: AugmentDraws, policy: AugmentPolicy, h: int, w: int):
    """Random inverse affine (rotation+group-rotation, shear, zoom, shift)
    about the image center (ts.RandomAffine + MyRandomChoiceRotate):
    ((N, 2, 2) matrix, (N, 2) shift (y, x))."""
    deg = _uniform(d.rotation, -policy.rotate_val, policy.rotate_val)
    if policy.rotate_groups:
        deg = deg + _const(tuple(policy.rotate_groups), deg.device)[d.group]
    theta = -deg * math.pi / 180.0  # inverse rotation
    shear = -_uniform(d.shear, -policy.shear_val, policy.shear_val) * math.pi / 180.0
    zoom = _uniform(d.zoom, policy.scale_val[0], policy.scale_val[1])
    ty = _uniform(d.shift_y, -policy.shift_val[0], policy.shift_val[0]) * h
    tx = _uniform(d.shift_x, -policy.shift_val[1], policy.shift_val[1]) * w
    cos, sin = torch.cos(theta), torch.sin(theta)
    one = torch.ones_like(theta)
    rot = torch.stack([cos, -sin, sin, cos], dim=-1).view(-1, 2, 2)
    shear_m = torch.stack([one, torch.tan(shear), 0.0 * shear, one], dim=-1).view(-1, 2, 2)
    inv_zoom = 1.0 / zoom
    mat = torch.bmm(rot, shear_m) * inv_zoom.view(-1, 1, 1)
    return mat, torch.stack([ty, tx], dim=-1)


def _elastic_field(d: AugmentDraws, h: int, w: int):
    """Simard dense displacement (elastic_transform.MyElasticTransform:16-101):
    dx,dy ~ U(-1,1) blurred with sigma=H*U(0.1,0.2)*3/4, scaled by
    alpha=H*U(1.5,2).  Returns (dy, dx), each (N, h, w)."""
    alpha = h * _uniform(d.elastic_alpha, 1.5, 2.0)
    sigma = h * _uniform(d.elastic_sigma, 0.1, 0.2) * 0.75
    both = torch.stack([_uniform(d.elastic_dx, -1.0, 1.0),
                        _uniform(d.elastic_dy, -1.0, 1.0)], dim=1)
    # scipy's gaussian_filter is normalized; the FFT Gaussian preserves that.
    both = fft_gaussian_blur(both, sigma.view(-1, 1)) * alpha.view(-1, 1, 1, 1)
    return both[:, 1], both[:, 0]


def _coarse_elastic_field(d: AugmentDraws, h: int, w: int, mu: float = 0.0,
                          sigma: float = 10.0):
    """3x3 coarse N(mu, sigma) grid upsampled bicubically
    (MyElasticTransformCoarseGrid:105-172).  Returns (dy, dx)."""
    dx = resize_bicubic(d.coarse_dx * sigma + mu, (h, w))
    dy = resize_bicubic(d.coarse_dy * sigma + mu, (h, w))
    return dy, dx


# ----------------------------------------------------------- intensity ops
def random_flip(d: AugmentDraws, img: torch.Tensor, lbl: torch.Tensor,
                policy: AugmentPolicy):
    """MyRandomFlip: per-axis coin with probability flip_p."""
    if policy.flip_h and policy.flip_p > 0:
        img = torch.where(_gate(d.flip_h, policy.flip_p, 4), img.flip(2), img)
        lbl = torch.where(_gate(d.flip_h, policy.flip_p, 3), lbl.flip(2), lbl)
    if policy.flip_v and policy.flip_p > 0:
        img = torch.where(_gate(d.flip_v, policy.flip_p, 4), img.flip(1), img)
        lbl = torch.where(_gate(d.flip_v, policy.flip_p, 3), lbl.flip(1), lbl)
    return img, lbl


# Amplitude gain matching the reference's *realized* V1 field (the JAX
# package's ops/augment.py says how it was fitted: the reference's PIL byte
# reinterpretation replaces its smoothed grid by byte noise).
_V1_REALIZED_GAIN = 1.75


def bias_field_v1_field(grids: Tuple[torch.Tensor, ...], h: int, w: int,
                        policy: AugmentPolicy) -> torch.Tensor:
    """The V1 multiplicative bias field (MyRandomPurtarbation,
    intensity_transform.py:300-345), (N, h, w): per-scale random control
    grids (``grids`` in ``sorted(multi_control_points)`` order) -> bicubic
    upsample -> 1/cp weights -> sum -> Gaussian(max_sigma) blur ->
    normalize to mean 1 -> clip to [1 +/- magnitude]."""
    total = 0.0
    for cp, grid in zip(sorted(policy.multi_control_points), grids):
        interp = resize_bicubic(grid, (h, w))
        interp = interp / (interp.sum(dim=(1, 2), keepdim=True) * cp + 1e-12)
        total = total + interp
    total = fft_gaussian_blur(total, float(policy.max_sigma))
    total = total / (total.sum(dim=(1, 2), keepdim=True) + 1e-12) * (h * w)
    total = 1.0 + _V1_REALIZED_GAIN * (total - 1.0)
    return torch.clamp(total, 1.0 - policy.perturb_magnitude, 1.0 + policy.perturb_magnitude)


def _rescale(out: torch.Tensor) -> torch.Tensor:
    mn = out.amin(dim=(1, 2, 3), keepdim=True)
    mx = out.amax(dim=(1, 2, 3), keepdim=True)
    return (out - mn) / (mx - mn + 1e-8)


def bias_field_v1(d: AugmentDraws, img: torch.Tensor, policy: AugmentPolicy) -> torch.Tensor:
    """Multi-scale multiplicative bias + per-image min-max rescale + noise
    (MyRandomPurtarbation, intensity_transform.py:272-370)."""
    h, w = img.shape[1], img.shape[2]
    out = _rescale(img * bias_field_v1_field(d.bias1_grids, h, w, policy)[..., None])
    if policy.add_noise:
        out = torch.clamp(out + d.bias1_noise * policy.noise_epsilon, 0.0, 1.0)
    return out


def _bspline_weight_matrix(n_out: int, n_coef: int, spacing: float) -> np.ndarray:
    """Uniform cubic B-spline evaluation weights: W[o, i] = B3(o/spacing - i),
    rows renormalized at the boundary."""
    o = np.arange(n_out, dtype=np.float64)[:, None] / spacing
    i = np.arange(n_coef, dtype=np.float64)[None, :]
    t = np.abs(o - i)
    w = np.where(t < 1, (4 - 6 * t**2 + 3 * t**3) / 6,
                 np.where(t < 2, (2 - t)**3 / 6, 0.0))
    w = w / w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


@lru_cache(maxsize=None)
def _bspline_on(n_out: int, n_coef: int, spacing: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_bspline_weight_matrix(n_out, n_coef, spacing)).to(device)


def bias_field_v2_field(knots_u: torch.Tensor, h: int, w: int,
                        policy: AugmentPolicy) -> torch.Tensor:
    """The V2 B-spline bias field (MyRandomPurtarbationV2,
    intensity_transform.py:420-520), (N, h, w): 1 + U(-m, m) knots every
    ``spacing`` px over the canvas extended to h + 1.5 spacing, a uniform
    cubic B-spline with the knots as coefficients, normalised to mean 1 on
    the extended field, centre-cropped back, clipped to [1 +/- m]."""
    spacing, ext_h, ext_w, n_h, n_w = _v2_geometry(h, w, policy)
    m = abs(policy.perturb_v2_magnitude)
    knots = 1.0 + _uniform(knots_u, -m, m)
    w_y = _bspline_on(ext_h, n_h, spacing, knots.device)
    w_x = _bspline_on(ext_w, n_w, spacing, knots.device)
    z = torch.matmul(torch.matmul(w_y, knots), w_x.t())
    z = z / (z.sum(dim=(1, 2), keepdim=True) + 1e-12) * (ext_h * ext_w)
    off_h, off_w = (ext_h - h) // 2, (ext_w - w) // 2
    return torch.clamp(z[:, off_h:off_h + h, off_w:off_w + w], 1.0 - m, 1.0 + m)


def bias_field_v2(d: AugmentDraws, img: torch.Tensor, policy: AugmentPolicy) -> torch.Tensor:
    """Coarse-knot B-spline multiplicative bias + rescale + noise
    (MyRandomPurtarbationV2:373-546)."""
    h, w = img.shape[1], img.shape[2]
    out = _rescale(img * bias_field_v2_field(d.bias2_knots, h, w, policy)[..., None])
    if policy.perturb_v2_add_noise:
        out = torch.clamp(out + d.bias2_noise * policy.perturb_v2_noise_epsilon, 0.0, 1.0)
    return out


def _range(img: torch.Tensor):
    return img.amin(dim=(1, 2, 3), keepdim=True), img.amax(dim=(1, 2, 3), keepdim=True)


def brightness_contrast(d: AugmentDraws, img: torch.Tensor,
                        policy: AugmentPolicy) -> torch.Tensor:
    """scale/shift clipped to each image's own range
    (RandomBrightnessFluctuation:114-162)."""
    scale = _uniform(d.contrast, *policy.contrast_range).view(-1, 1, 1, 1)
    bright = _uniform(d.brightness, *policy.brightness_range).view(-1, 1, 1, 1)
    mn, mx = _range(img)
    return torch.clamp(img * scale + bright, mn, mx)


def random_gamma(d: AugmentDraws, img: torch.Tensor, policy: AugmentPolicy) -> torch.Tensor:
    """x ** (1/gamma) clipped to each image's own range (RandomGamma:68-111)."""
    gamma = _uniform(d.gamma, *policy.gamma_range).view(-1, 1, 1, 1)
    mn, mx = _range(img)
    return torch.clamp(torch.clamp(img, min=0.0) ** (1.0 / gamma), mn, mx)


# -------------------------------------------------------------- warp engine
_WARP_PAD = spline.NEAREST_PAD  # scipy 'nearest' edge pre-pad


def _fused_warp_coeffs(img: torch.Tensor, lbl: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Channel-concatenated spline-coefficient stack (N, H + 28, W + 28,
    C_img + C - 1) for the fused warp of NHWC images and NHW labels.

    * label channels: one-hot classes 1..C-1, edge-pad 12, mirror
      prefilter, 2-wide mirror ('reflect' in numpy's words) pad: scipy's
      'nearest' construction (``spline.map_coordinates_cubic``).
    * image channels: 'reflect' prefilter + 2-wide scipy-'reflect' (numpy's
      'symmetric') pad, embedded at offset +12 inside the label's padded
      frame, so that original tap t sits at padded row t + 14 in BOTH
      stacks: in-domain coordinates share indices and B-spline weights.
      Rows the two extensions would disagree on are fetched only for
      out-of-domain coordinates, which both outputs mask.
    """
    pad = _WARP_PAD
    classes = torch.arange(1, num_classes, device=lbl.device).view(1, -1, 1, 1)
    onehot = (lbl.unsqueeze(1) == classes).float()                 # (N, C-1, H, W)
    lbl_ext = spline.pad_axes(onehot, pad, "nearest")
    lbl_cfp = spline.pad_axes(spline.spline_coefficients(lbl_ext, "mirror"),
                              spline.PAD, "mirror")
    img_cfp = spline.pad_axes(spline.spline_coefficients(img.permute(0, 3, 1, 2), "reflect"),
                              spline.PAD, "reflect")
    img_big = F.pad(img_cfp, (pad, pad, pad, pad))
    return torch.cat([img_big, lbl_cfp], dim=1).permute(0, 2, 3, 1).contiguous()


def _fused_warp_prep(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int):
    """Clip sample coords into the padded frame, split into integer tap
    start (in the 2-padded coefficient frame) + the 4 cubic B-spline tap
    weights per axis.  Elementwise — works for any leading batch shape."""
    pad = _WARP_PAD
    hl, wl = h + 2 * pad, w + 2 * pad
    yl = torch.clamp(ys + pad, 0.0, hl - 1.0)
    xl = torch.clamp(xs + pad, 0.0, wl - 1.0)
    y0 = torch.floor(yl)
    x0 = torch.floor(xl)
    wy = torch.stack(spline._bspline_weights(yl - y0), dim=-1)        # (..., 4)
    wx = torch.stack(spline._bspline_weights(xl - x0), dim=-1)
    # the gather's start row for tap a is iy + a in the 2-padded frame
    return y0.long() + 1, x0.long() + 1, wy, wx


def _fused_warp_post(out: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor, h: int, w: int,
                     n_img: int, num_classes: int):
    """Zero-fill the image outside the source frame; the reference's >=0.5
    ascending per-class overwrite for the label (int32)."""
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    img_out = torch.where(valid.unsqueeze(-1), out[..., :n_img], 0.0)
    result = torch.zeros(ys.shape, dtype=torch.int32, device=ys.device)
    for cc in range(1, num_classes):
        hit = (out[..., n_img + cc - 1] >= 0.5) & valid
        result = torch.where(hit, cc, result)
    return img_out, result


def _fused_warp_scores(imgs: torch.Tensor, labels: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The warp's interpolated channels (N, h_out, w_out, C_img + C - 1)
    before masking: the image, then the class 1..C-1 scores."""
    h, w = labels.shape[1], labels.shape[2]
    big = _fused_warp_coeffs(imgs, labels, num_classes)
    iy, ix, wy, wx = _fused_warp_prep(ys, xs, h, w)
    return spline.gather_4x4(big, iy, ix, wy, wx)


def warp_image(img_hwc: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """An HWC image sampled at the (H_out, W_out) coordinates (ys, xs),
    zero outside the source frame ``[0, h-1] x [0, w-1]``: order-3
    B-splines with 'reflect' coefficients, scipy's
    ``map_coordinates(order=3, mode='reflect')`` (the JAX package's
    ``warp_image`` at its default order; the corruptions' motion model
    samples with it)."""
    h, w = img_hwc.shape[0], img_hwc.shape[1]
    out = spline.map_coordinates_cubic(img_hwc, ys, xs, mode="reflect")
    valid = ((ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1))[..., None]
    return torch.where(valid, out, 0.0).to(img_hwc.dtype)


def warp_image_batch(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """:func:`warp_image` of each NHWC image at its own (N, h_out, w_out)
    coordinates, batched."""
    h, w = imgs.shape[1], imgs.shape[2]
    out = spline.map_coordinates_cubic_batch(imgs, ys, xs, mode="reflect")
    valid = ((ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1))[..., None]
    return torch.where(valid, out, 0.0).to(imgs.dtype)


def warp_label_batch(labels: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """The JAX package's ``warp_label`` (order 3) of each NHW label map at
    its own coordinates: the one-hot classes 1..C-1 sampled with scipy's
    'nearest' mode, then ``result[score_c >= 0.5] = c`` in ascending class
    order, background outside the source frame.  int32."""
    h, w = labels.shape[1], labels.shape[2]
    classes = torch.arange(1, num_classes, device=labels.device).view(1, 1, 1, -1)
    onehot = (labels.unsqueeze(-1) == classes).float()
    scores = spline.map_coordinates_cubic_batch(onehot, ys, xs, mode="nearest")
    valid = (ys >= 0) & (ys <= h - 1) & (xs >= 0) & (xs <= w - 1)
    result = torch.zeros(ys.shape, dtype=torch.int32, device=ys.device)
    for c in range(1, num_classes):
        result = torch.where((scores[..., c - 1] >= 0.5) & valid, c, result)
    return result


def warp_image_and_label_batch(imgs: torch.Tensor, labels: torch.Tensor, ys: torch.Tensor,
                               xs: torch.Tensor, num_classes: int):
    """Order-3 image + per-class label warp of a batch sharing ONE gather:
    NHWC images and NHW labels sampled at (N, h_out, w_out) coordinates
    (ys, xs).  Returns (warped images NHWC, warped labels NHW int32)."""
    out = _fused_warp_scores(imgs, labels, ys, xs, num_classes)
    return _fused_warp_post(out, ys, xs, labels.shape[1], labels.shape[2], imgs.shape[-1],
                            num_classes)


def warp_image_and_label(img_hwc: torch.Tensor, label_hw: torch.Tensor, ys: torch.Tensor,
                         xs: torch.Tensor, num_classes: int):
    """:func:`warp_image_and_label_batch` for one sample (HWC, HW)."""
    img, lbl = warp_image_and_label_batch(img_hwc[None], label_hw[None], ys[None], xs[None],
                                          num_classes)
    return img[0], lbl[0]


# ------------------------------------------------------------ full pipeline
def _augment_pre_warp(d: AugmentDraws, images: torch.Tensor, labels: torch.Tensor,
                      policy: AugmentPolicy, pad_hw: Tuple[int, int],
                      crop_hw: Tuple[int, int], raw_geometry: bool = False):
    """Everything before the geometric warp: pad, flips, intensity stages,
    and (when the policy has geometry) the warp's sample coordinates at the
    crop's pixels.  Returns (img at pad_hw, lbl at pad_hw, ya, xa); ya/xa
    (N, *crop_hw) are None when the policy needs no geometry.

    ``raw_geometry`` (the ``sequential`` warp) returns the pieces instead,
    (img, lbl, (mat, trans, dy, dx)) with the gated elastic displacement
    (N, H, W) at the padded size, or (img, lbl, None): the same draws, the
    same fields."""
    img = pad_to(images.float(), pad_hw)
    lbl = pad_to(labels, pad_hw)
    h, w = img.shape[1], img.shape[2]

    img, lbl = random_flip(d, img, lbl, policy)
    # intensity stages (each gated by its probability; computed then selected)
    if policy.perturb_prob > 0:
        img = torch.where(_gate(d.gate_bias1, policy.perturb_prob, 4),
                          bias_field_v1(d, img, policy), img)
    if policy.perturb_v2_prob > 0:
        img = torch.where(_gate(d.gate_bias2, policy.perturb_v2_prob, 4),
                          bias_field_v2(d, img, policy), img)
    if policy.intensity_prob > 0:
        img = torch.where(_gate(d.gate_intensity, policy.intensity_prob, 4),
                          brightness_contrast(d, img, policy), img)
    if policy.gamma_prob > 0:
        img = torch.where(_gate(d.gate_gamma, policy.gamma_prob, 4),
                          random_gamma(d, img, policy), img)
    if not _needs_geometry(policy):
        return (img, lbl, None) if raw_geometry else (img, lbl, None, None)
    if raw_geometry:
        mat, trans = _affine_inverse_matrix(d, policy, h, w)
        dy_full = torch.zeros((img.shape[0], h, w), dtype=torch.float32, device=img.device)
        dx_full = torch.zeros_like(dy_full)
        for prob, field, gate in ((policy.elastic_prob, _elastic_field, d.gate_elastic),
                                  (policy.elastic_prob_v2, _coarse_elastic_field,
                                   d.gate_coarse)):
            if prob > 0:
                dy, dx = field(d, h, w)
                do = _gate(gate, prob, 3)
                dy_full = dy_full + torch.where(do, dy, 0.0)
                dx_full = dx_full + torch.where(do, dx, 0.0)
        return img, lbl, (mat, trans, dy_full, dx_full)

    # one geometric warp: affine (+ group rotation), then elastic offsets,
    # evaluated only at the crop's pixels (the fields are made at pad
    # resolution and cropped, so every sample coordinate is unchanged)
    oy = (h - crop_hw[0]) // 2
    ox = (w - crop_hw[1]) // 2
    dev = img.device
    ys = (torch.arange(crop_hw[0], dtype=torch.float32, device=dev) + oy).view(1, -1, 1)
    xs = (torch.arange(crop_hw[1], dtype=torch.float32, device=dev) + ox).view(1, 1, -1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    mat, trans = _affine_inverse_matrix(d, policy, h, w)
    yc = ys - cy - trans[:, 0].view(-1, 1, 1)
    xc = xs - cx - trans[:, 1].view(-1, 1, 1)
    m = mat.view(-1, 4, 1, 1)
    ya = m[:, 0] * yc + m[:, 1] * xc + cy
    xa = m[:, 2] * yc + m[:, 3] * xc + cx
    if policy.elastic_prob > 0:
        dy, dx = _elastic_field(d, h, w)
        do = _gate(d.gate_elastic, policy.elastic_prob, 3)
        ya = ya + torch.where(do, center_crop(dy, crop_hw), 0.0)
        xa = xa + torch.where(do, center_crop(dx, crop_hw), 0.0)
    if policy.elastic_prob_v2 > 0:
        dy, dx = _coarse_elastic_field(d, h, w)
        do = _gate(d.gate_coarse, policy.elastic_prob_v2, 3)
        ya = ya + torch.where(do, center_crop(dy, crop_hw), 0.0)
        xa = xa + torch.where(do, center_crop(dx, crop_hw), 0.0)
    return img, lbl, ya, xa


def _sequential_warp(d: AugmentDraws, images: torch.Tensor, labels: torch.Tensor,
                     policy: AugmentPolicy, pad_hw: Tuple[int, int],
                     crop_hw: Tuple[int, int], num_classes: int):
    """The ``sequential`` warp (the JAX package's ``SEQ_WARP=1`` arm of
    ``augment_sample``): the affine resample over the whole padded frame,
    then the elastic resample composed with the crop."""
    img, lbl, geom = _augment_pre_warp(d, images, labels, policy, pad_hw, crop_hw,
                                       raw_geometry=True)
    if geom is None:
        return center_crop(img, crop_hw), center_crop(lbl, crop_hw)
    mat, trans, dy_full, dx_full = geom
    h, w = img.shape[1], img.shape[2]
    dev = img.device
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, -1, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, -1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yc = ys - cy - trans[:, 0].view(-1, 1, 1)
    xc = xs - cx - trans[:, 1].view(-1, 1, 1)
    m = mat.view(-1, 4, 1, 1)
    img, lbl = warp_image_and_label_batch(img, lbl, m[:, 0] * yc + m[:, 1] * xc + cy,
                                          m[:, 2] * yc + m[:, 3] * xc + cx, num_classes)
    oy = (h - crop_hw[0]) // 2
    ox = (w - crop_hw[1]) // 2
    ys2 = (torch.arange(crop_hw[0], dtype=torch.float32, device=dev) + oy).view(1, -1, 1)
    xs2 = (torch.arange(crop_hw[1], dtype=torch.float32, device=dev) + ox).view(1, 1, -1)
    return warp_image_and_label_batch(img, lbl, ys2 + center_crop(dy_full, crop_hw),
                                      xs2 + center_crop(dx_full, crop_hw), num_classes)


def augment_batch(draws: AugmentDraws, images: torch.Tensor, labels: torch.Tensor,
                  policy: AugmentPolicy, pad_hw: Tuple[int, int] = (224, 224),
                  crop_hw: Tuple[int, int] = (192, 192), num_classes: int = 4,
                  warp: str = "composed"):
    """Training augmentation of a batch (images NHWC float [0, 1], labels
    NHW int) with ``draws``: (images NHWC, labels NHW int32) at crop_hw,
    the geometry by the ``warp`` arm (:data:`WARPS`)."""
    if warp not in WARPS:
        raise ValueError(f"warp {warp!r}: not one of {WARPS}")
    if warp == "sequential":
        img, lbl = _sequential_warp(draws, images, labels, policy, pad_hw, crop_hw,
                                    num_classes)
        return percentile_normalize(img), lbl.to(torch.int32)
    img, lbl, ya, xa = _augment_pre_warp(draws, images, labels, policy, pad_hw, crop_hw)
    if ya is None:
        img, lbl = center_crop(img, crop_hw), center_crop(lbl, crop_hw)
    elif warp == "two_gather":
        img, lbl = warp_image_batch(img, ya, xa), warp_label_batch(lbl, ya, xa, num_classes)
    else:
        img, lbl = warp_image_and_label_batch(img, lbl, ya, xa, num_classes)
    return percentile_normalize(img), lbl.to(torch.int32)


def eval_transform(images: torch.Tensor, labels: Optional[torch.Tensor] = None,
                   pad_hw: Tuple[int, int] = (224, 224), crop_hw: Tuple[int, int] = (192, 192)):
    """Validate/test transform of a batch (the JAX package's
    ``eval_transform_sample`` over each sample): pad -> center crop ->
    min-max normalize (transform.py:88-112)."""
    img = percentile_normalize(center_crop(pad_to(images.float(), pad_hw), crop_hw))
    if labels is None:
        return img
    return img, center_crop(pad_to(labels, pad_hw), crop_hw).to(torch.int32)


# how far (pixels) a flip at one pixel of the sequential warp's first
# resample reaches into the second one's output: the cubic prefilter
# spreads it by a factor 0.268 a pixel (2-sqrt(3)), below 1e-4 of its size
# after 7 pixels, and the 4x4 taps add 2 more
SEQUENTIAL_REACH = 9


def _near_edge(ys: torch.Tensor, xs: torch.Tensor, h: int, w: int, tol: float):
    return torch.stack([ys.abs(), (ys - (h - 1)).abs(), xs.abs(),
                        (xs - (w - 1)).abs()]).amin(0) <= tol


def unsure_pixels(draws: AugmentDraws, images: torch.Tensor, labels: torch.Tensor,
                  policy_name: str, pad_hw: Tuple[int, int] = (224, 224),
                  crop_hw: Tuple[int, int] = (192, 192), num_classes: int = 4,
                  keep_orig: bool = True, tol: float = 1e-3, warp: str = "composed"):
    """Where the training pipeline's output may flip under rounding, for
    holding one run of it against another: ``(edge, label)`` boolean (N',
    *crop_hw) masks aligned with ``make_batch_train_pipeline``'s batch.
    ``edge``: the sample coordinate lies within ``tol`` of the source
    frame's edge (the in-frame test decides the image and the label there);
    ``label``: ``edge``, or a class score within ``tol`` of 0.5.  The
    ``two_gather`` warp samples at the same coordinates and class scores.
    The ``sequential`` warp's second resample also reads its first one's
    flips: an output pixel is unsure where its sample coordinate lies
    within :data:`SEQUENTIAL_REACH` pixels of a first-resample pixel that
    is (``edge`` for the image, ``label`` for the labels).  The original
    half of a ``keep_orig`` batch is never unsure."""
    policy = get_policy(policy_name)
    n = images.shape[0]
    edge = torch.zeros((n, *crop_hw), dtype=torch.bool, device=images.device)
    label = edge
    labels = labels.to(torch.int32)
    if warp == "sequential" and _needs_geometry(policy):
        img, lbl, (mat, trans, dy_full, dx_full) = _augment_pre_warp(
            draws, images, labels, policy, pad_hw, crop_hw, raw_geometry=True)
        h, w = lbl.shape[1], lbl.shape[2]
        dev = img.device
        ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, -1, 1)
        xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, -1)
        yc = ys - (h - 1) / 2.0 - trans[:, 0].view(-1, 1, 1)
        xc = xs - (w - 1) / 2.0 - trans[:, 1].view(-1, 1, 1)
        m = mat.view(-1, 4, 1, 1)
        ya = m[:, 0] * yc + m[:, 1] * xc + (h - 1) / 2.0
        xa = m[:, 2] * yc + m[:, 3] * xc + (w - 1) / 2.0
        edge1 = _near_edge(ya, xa, h, w, tol)
        scores = _fused_warp_scores(img, lbl, ya, xa, num_classes)
        label1 = edge1 | ((scores[..., img.shape[-1]:] - 0.5).abs() <= tol).any(-1)
        img, lbl = _fused_warp_post(scores, ya, xa, h, w, img.shape[-1], num_classes)
        k = 2 * SEQUENTIAL_REACH + 1
        reach = [F.max_pool2d(t.float().unsqueeze(1), k, 1, SEQUENTIAL_REACH)[:, 0] > 0
                 for t in (edge1, label1)]
        oy, ox = (h - crop_hw[0]) // 2, (w - crop_hw[1]) // 2
        ys2 = (torch.arange(crop_hw[0], dtype=torch.float32, device=dev) + oy).view(1, -1, 1) \
            + center_crop(dy_full, crop_hw)
        xs2 = (torch.arange(crop_hw[1], dtype=torch.float32, device=dev) + ox).view(1, 1, -1) \
            + center_crop(dx_full, crop_hw)
        at = (ys2.round().clamp(0, h - 1).long() * w + xs2.round().clamp(0, w - 1).long())
        read = [r.reshape(n, -1).gather(1, at.reshape(n, -1)).view(n, *crop_hw) for r in reach]
        edge = _near_edge(ys2, xs2, h, w, tol) | read[0]
        scores2 = _fused_warp_scores(img, lbl, ys2, xs2, num_classes)[..., img.shape[-1]:]
        label = edge | read[1] | ((scores2 - 0.5).abs() <= tol).any(-1)
    elif warp != "sequential":
        img, lbl, ya, xa = _augment_pre_warp(draws, images, labels, policy, pad_hw, crop_hw)
        if ya is not None:
            h, w = lbl.shape[1], lbl.shape[2]
            edge = _near_edge(ya, xa, h, w, tol)
            scores = _fused_warp_scores(img, lbl, ya, xa, num_classes)[..., img.shape[-1]:]
            label = edge | ((scores - 0.5).abs() <= tol).any(-1)
    if keep_orig:
        edge = torch.cat([edge, torch.zeros_like(edge)])
        label = torch.cat([label, torch.zeros_like(label)])
    return edge, label


def make_batch_augment(policy_name: str, pad_hw=(224, 224), crop_hw=(192, 192),
                       num_classes: int = 4, warp: str = "composed"):
    """Batch augmentation: (draws, images NHWC, labels NHW) -> (images NHWC
    at crop, labels NHW int32 at crop)."""
    policy = get_policy(policy_name)

    def run(draws: AugmentDraws, images: torch.Tensor, labels: torch.Tensor):
        return augment_batch(draws, images, labels, policy, pad_hw, crop_hw, num_classes, warp)

    return run


def make_batch_eval_transform(pad_hw=(224, 224), crop_hw=(192, 192)):
    """(images NHWC, labels NHW) -> pad, centre crop, min-max normalise."""
    def run(images: torch.Tensor, labels: torch.Tensor):
        return eval_transform(images, labels, pad_hw, crop_hw)

    return run


def _train_batch_body(draws, images, labels, policy, pad_hw, crop_hw, num_classes,
                      keep_orig, warp):
    labels = labels.to(torch.int32)
    aug_i, aug_l = augment_batch(draws, images, labels, policy, pad_hw, crop_hw, num_classes,
                                 warp)
    if not keep_orig:
        return {"image": aug_i, "label": aug_l}
    orig_i, orig_l = eval_transform(images, labels, pad_hw, crop_hw)
    return {"image": torch.cat([aug_i, orig_i]), "label": torch.cat([aug_l, orig_l])}


def make_batch_train_pipeline(policy_name: str, pad_hw=(224, 224), crop_hw=(192, 192),
                              num_classes: int = 4, keep_orig: bool = True,
                              warp: str = "composed"):
    """Training batch assembly: (draws, images, labels) -> {'image',
    'label'} at crop resolution; with ``keep_orig`` the batch is
    [augmented || original], the original half through the eval
    transform; ``warp``: the geometric warp's arm (:data:`WARPS`).  Its
    output feeds ``CooperativeTrainer.train_step``."""
    policy = get_policy(policy_name)
    if warp not in WARPS:
        raise ValueError(f"warp {warp!r}: not one of {WARPS}")

    def run(draws: AugmentDraws, images: torch.Tensor, labels: torch.Tensor):
        return _train_batch_body(draws, images, labels, policy, pad_hw, crop_hw,
                                 num_classes, keep_orig, warp)

    return run


def make_batch_train_pipeline_indexed(policy_name: str, pad_hw=(224, 224),
                                      crop_hw=(192, 192), num_classes: int = 4,
                                      keep_orig: bool = True, warp: str = "composed"):
    """Device-resident-dataset variant: (draws, images_ALL, labels_ALL, idx)
    -> batch; the samples at ``idx`` are gathered on the dataset's device."""
    policy = get_policy(policy_name)
    if warp not in WARPS:
        raise ValueError(f"warp {warp!r}: not one of {WARPS}")

    def run(draws: AugmentDraws, images_all: torch.Tensor, labels_all: torch.Tensor,
            idx: torch.Tensor):
        images = torch.index_select(images_all, 0, idx)
        labels = torch.index_select(labels_all, 0, idx)
        return _train_batch_body(draws, images, labels, policy, pad_hw, crop_hw,
                                 num_classes, keep_orig, warp)

    return run


# ------------------------------------------------- the rest of the module
def eval_transform_sample(img_hwc: torch.Tensor, label_hw: Optional[torch.Tensor] = None,
                          pad_hw: Tuple[int, int] = (224, 224),
                          crop_hw: Tuple[int, int] = (192, 192)):
    """:func:`eval_transform` of one sample (HWC image, HW label or None):
    pad -> centre crop -> min-max normalise (transform.py:88-112)."""
    if label_hw is None:
        return eval_transform(img_hwc[None], None, pad_hw, crop_hw)[0]
    img, lbl = eval_transform(img_hwc[None], label_hw[None], pad_hw, crop_hw)
    return img[0], lbl[0]


class Transformations:
    """The reference's ``transform.Transformations`` (transform.py:7-112)
    over the batched pipeline: :meth:`get_transformation` returns its four
    named pipelines, 'train' and 'aug_validate' ``(draws, images NHWC,
    labels NHW) -> (images, labels)``, 'validate' ``(images, labels) ->
    (images, labels)`` (pad, crop, normalise) and 'test' ``(images,) ->
    images``."""

    def __init__(self, data_aug_policy_name: str = "ACDC_affine_elastic_intensity",
                 pad_size=(224, 224), crop_size=(192, 192), num_classes: int = 4):
        self.policy_name = data_aug_policy_name
        self.pad_hw = tuple(pad_size[:2])
        self.crop_hw = tuple(crop_size[:2])
        self.num_classes = num_classes

    def get_transformation(self):
        train = make_batch_augment(self.policy_name, self.pad_hw, self.crop_hw,
                                   num_classes=self.num_classes)

        def test(images: torch.Tensor) -> torch.Tensor:
            return eval_transform(images, None, self.pad_hw, self.crop_hw)

        return {"train": train, "validate": make_batch_eval_transform(self.pad_hw, self.crop_hw),
                "test": test, "aug_validate": train}


def draw_motion(generator: torch.Generator, n: int) -> torch.Tensor:
    """The (n, 2) unit normals of :func:`motion_estimation`'s shifts (dy,
    dx), from a CPU ``generator``, as ``jax.random.normal(key, (n, 2))``
    draws them."""
    if generator.device.type != "cpu":
        raise ValueError("motion draws are made on the host from a CPU generator")
    return torch.randn((n, 2), generator=generator)


def motion_estimation(normals: torch.Tensor, label_nhw: torch.Tensor,
                      shift: float = 1.0) -> torch.Tensor:
    """Inter-slice motion of a label stack (affine_transform.motion_estimation:
    109-134): slice i moves by ``clip(normals[i], -3, 3) * shift`` (dy, dx),
    sampled nearest (source coordinates rounded half to even), zero outside.
    ``normals``: (N, 2) (:func:`draw_motion`) on the labels' device."""
    n, h, w = label_nhw.shape
    shifts = torch.clamp(normals.float(), -3.0, 3.0) * shift
    dev = label_nhw.device
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, -1, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, -1)
    sy = torch.round(ys + shifts[:, 0].view(-1, 1, 1)).to(torch.int64)
    sx = torch.round(xs + shifts[:, 1].view(-1, 1, 1)).to(torch.int64)
    valid = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    flat = sy.clamp(0, h - 1) * w + sx.clamp(0, w - 1)
    out = torch.gather(label_nhw.reshape(n, h * w), 1, flat.reshape(n, h * w)).view(n, h, w)
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=dev))


def clahe(image_hw: np.ndarray, clip_limit: float = 0.01, nbins: int = 256,
          tile_grid: Tuple[int, int] = (8, 8)) -> np.ndarray:
    """Contrast-limited adaptive histogram equalisation in numpy, host
    side (the reference wraps skimage's ``equalize_adapthist``,
    intensity_transform.MyRandomImageContrastTransform:12-65, off in every
    policy): tile histograms clipped at ``clip_limit`` x the tile's size
    with the excess spread over the bins, each pixel a bilinear blend of
    its four nearest tiles' clipped-CDF maps; the output rescaled to the
    input's [min, max], in its dtype.  A copy of the JAX package's."""
    img = np.asarray(image_hw, np.float64)
    lo, hi = img.min(), img.max()
    if hi - lo < 1e-12:
        return np.asarray(image_hw).copy()
    norm = (img - lo) / (hi - lo)
    h, w = norm.shape
    gh, gw = tile_grid
    bins = np.minimum((norm * (nbins - 1)).astype(np.int64), nbins - 1)

    # per-tile clipped-CDF lookup tables
    ys = np.linspace(0, h, gh + 1).astype(int)
    xs = np.linspace(0, w, gw + 1).astype(int)
    luts = np.zeros((gh, gw, nbins))
    for i in range(gh):
        for j in range(gw):
            tile = bins[ys[i]:ys[i + 1], xs[j]:xs[j + 1]]
            hist = np.bincount(tile.ravel(), minlength=nbins).astype(np.float64)
            limit = max(clip_limit * tile.size, 1.0)
            excess = np.clip(hist - limit, 0, None).sum()
            hist = np.minimum(hist, limit) + excess / nbins
            cdf = np.cumsum(hist)
            luts[i, j] = (cdf - cdf[0]) / max(cdf[-1] - cdf[0], 1e-12)

    # bilinear blend of the 4 surrounding tile mappings per pixel
    cy = (ys[:-1] + ys[1:]) / 2.0
    cx = (xs[:-1] + xs[1:]) / 2.0
    py = np.clip(np.interp(np.arange(h), cy, np.arange(gh)), 0, gh - 1)
    px = np.clip(np.interp(np.arange(w), cx, np.arange(gw)), 0, gw - 1)
    y0 = np.floor(py).astype(int)
    y1 = np.minimum(y0 + 1, gh - 1)
    x0 = np.floor(px).astype(int)
    x1 = np.minimum(x0 + 1, gw - 1)
    fy = (py - y0)[:, None]
    fx = (px - x0)[None, :]

    def lut_at(ti, tj):
        return luts[ti[:, None], tj[None, :], bins]

    out = ((1 - fy) * (1 - fx) * lut_at(y0, x0)
           + (1 - fy) * fx * lut_at(y0, x1)
           + fy * (1 - fx) * lut_at(y1, x0)
           + fy * fx * lut_at(y1, x1))
    return (out * (hi - lo) + lo).astype(np.asarray(image_hw).dtype)
