"""TorchIO-style MRI corruptions (the ACDC-C test-set generator's models).

Counterpart of the JAX package's ``ops/corruptions.py``, the re-design of
``medseg/dataset_loader/generate_artefacted_data.py`` (:56-62): the four
corruption models of TorchIO's {RandomBias, RandomSpike, RandomGhosting,
RandomMotion(degrees=30, translation=10)}, k-space ops by ``torch.fft``
(cuFFT on the card), on an (N, H, W) float32 stack of slices in [0, 1] on
any device:

  * bias field: exp(polynomial in normalised coordinates), order 3,
    coefficients U(-0.5, 0.5), multiplicative;
  * spike: spike(s) added at random positions of the centred spectrum with
    amplitude ``intensity * max|spectrum|``;
  * ghosting: every num_ghosts-th line of the centred spectrum along one
    axis attenuated (the central low-frequency band spared);
  * motion: the rows of the (uncentred) spectrum split into segments taken
    from differently translated and rotated copies (degrees <= 30,
    translation <= 10 px; the copies sampled by order-3 B-splines,
    :func:`..ops.augment.warp_image`).

Each output slice is rescaled to [0, 1] by its own min and max
(preprocess3D / recover_image, generate_artefacted_data.py:17-44).

The random draws are operands, as everywhere in the port: a
:class:`CorruptionDraws` made by :func:`draw_corruption` from a CPU
``torch.Generator`` (tests replay the JAX package's keys into one).  One
draw serves every slice of a volume (``corrupt_volume``'s volume-coherent
artifacts, as the JAX package vmaps one key over the slices).  Uniforms are
raw ``[0, 1)`` draws, scaled as ``jax.random.uniform`` scales them; a draw
that is a branch (the ghost period, the ghost axis) is a host int.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields, replace
from typing import Optional, Tuple, Union

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
    warp_image,
)

NAMES = ("RandomBias", "RandomSpike", "RandomGhosting", "RandomMotion")
# pi / 180 in float32 as XLA folds ``* pi / 180.0``: pi times the reciprocal of 180
DEG_TO_RAD = float(np.float32(np.float32(math.pi) * np.float32(1.0 / 180.0)))


@dataclass
class CorruptionDraws:
    """The draws of one corruption of one volume.  Tensors are raw ``[0, 1)``
    uniforms (float32) unless stated; a field is None where the corruption
    draws nothing for it.

    RandomBias: ``coeffs`` (n_coeff,).  RandomSpike: ``spike_pos`` (S, 2),
    ``spike_sign`` (S, 2) of +-1 (float32), ``spike_intensity`` (S,).
    RandomGhosting: ``num_ghosts`` and ``ghost_axis`` host ints,
    ``ghost_intensity`` ().  RandomMotion: ``theta``, ``dy``, ``dx`` and
    ``bounds``, (T,) each."""

    name: str
    coeffs: Optional[torch.Tensor] = None
    spike_pos: Optional[torch.Tensor] = None
    spike_sign: Optional[torch.Tensor] = None
    spike_intensity: Optional[torch.Tensor] = None
    num_ghosts: Optional[int] = None
    ghost_axis: Optional[int] = None
    ghost_intensity: Optional[torch.Tensor] = None
    theta: Optional[torch.Tensor] = None
    dy: Optional[torch.Tensor] = None
    dx: Optional[torch.Tensor] = None
    bounds: Optional[torch.Tensor] = None

    def to(self, device) -> "CorruptionDraws":
        return replace(self, **{f.name: getattr(self, f.name).to(device) for f in fields(self)
                                if torch.is_tensor(getattr(self, f.name))})


def n_coefficients(order: int) -> int:
    """The bias polynomial's coefficient count, ``x^j y^i`` with i + j <= order."""
    return sum(1 for i in range(order + 1) for j in range(order + 1 - i))


def draw_corruption(generator: torch.Generator, name: str, order: int = 3,
                    num_spikes: int = 1, num_ghosts_range: Tuple[int, int] = (4, 10),
                    axis: Optional[int] = None, num_transforms: int = 2,
                    device: Union[str, torch.device, None] = None) -> CorruptionDraws:
    """The draws of corruption ``name`` for one volume, on the host from a
    CPU ``generator``, moved to ``device`` (default: left on the CPU).  The
    keyword arguments are the corruption's own (its function's defaults)."""
    if generator.device.type != "cpu":
        raise ValueError("corruption draws are made on the host from a CPU generator; "
                         "move them to the device with CorruptionDraws.to")

    def u(*shape):
        return torch.rand(shape, generator=generator)

    if name == "RandomBias":
        d = CorruptionDraws(name, coeffs=u(n_coefficients(order)))
    elif name == "RandomSpike":
        sign = torch.randint(0, 2, (num_spikes, 2), generator=generator) * 2 - 1
        d = CorruptionDraws(name, spike_pos=u(num_spikes, 2), spike_sign=sign.float(),
                            spike_intensity=u(num_spikes))
    elif name == "RandomGhosting":
        lo, hi = num_ghosts_range
        num_ghosts = int(torch.randint(lo, hi + 1, (), generator=generator))
        intensity = u()
        if axis is None:
            axis = int(torch.randint(0, 2, (), generator=generator))
        d = CorruptionDraws(name, num_ghosts=num_ghosts, ghost_axis=axis,
                            ghost_intensity=intensity)
    elif name == "RandomMotion":
        d = CorruptionDraws(name, theta=u(num_transforms), dy=u(num_transforms),
                            dx=u(num_transforms), bounds=u(num_transforms))
    else:
        raise KeyError(f"unknown corruption {name!r}; one of {NAMES}")
    return d if device is None else d.to(device)


def _uniform(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform``'s scaling of raw [0, 1) draws to [lo, hi),
    ``max(lo, u * (hi - lo) + lo)``, with the multiply-add rounded once, as
    XLA fuses it (the product of two float32 values is exact in float64)."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    scaled = (u.double() * float(hi32 - lo32) + float(lo32)).float()
    return torch.clamp(scaled, min=float(lo32))


def _rescale01(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Each slice of (N, H, W) to [0, 1] by its own min and max."""
    mn = x.amin(dim=(-2, -1), keepdim=True)
    mx = x.amax(dim=(-2, -1), keepdim=True)
    return (x - mn) / (mx - mn + eps)


def _linspace(n: int, device: torch.device) -> torch.Tensor:
    return torch.linspace(-1.0, 1.0, n, dtype=torch.float32, device=device)


def _centred_spectrum(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(torch.fft.fft2(x), dim=(-2, -1))


def _from_centred(spectrum: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(torch.fft.ifftshift(spectrum, dim=(-2, -1))).abs()


# ------------------------------------------------------------------ bias
def random_bias_field(d: CorruptionDraws, volume_nhw: torch.Tensor,
                      coefficients: float = 0.5, order: int = 3) -> torch.Tensor:
    """Multiplicative exp-polynomial bias field (TorchIO RandomBiasField)."""
    h, w = volume_nhw.shape[-2:]
    ys = _linspace(h, volume_nhw.device)[:, None]
    xs = _linspace(w, volume_nhw.device)[None, :]
    coeffs = _uniform(d.coeffs, -coefficients, coefficients)
    field = torch.zeros((h, w), dtype=torch.float32, device=volume_nhw.device)
    k = 0
    for i in range(order + 1):
        for j in range(order + 1 - i):
            field = field + coeffs[k] * (ys ** i) * (xs ** j)
            k += 1
    return _rescale01(volume_nhw * torch.exp(field))


# ----------------------------------------------------------------- spike
def spike_positions(d: CorruptionDraws, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ys, xs) of the spikes on the centred spectrum: ``(h // 2 + sign * pos
    * h)`` in float32, truncated toward zero, modulo h (and so for x)."""
    pos, sign = _uniform(d.spike_pos, 0.05, 0.45), d.spike_sign
    ys = (h // 2 + sign[:, 0] * pos[:, 0] * h).to(torch.int32) % h
    xs = (w // 2 + sign[:, 1] * pos[:, 1] * w).to(torch.int32) % w
    return ys, xs


def random_spike(d: CorruptionDraws, volume_nhw: torch.Tensor,
                 intensity_range: Tuple[float, float] = (1.0, 3.0)) -> torch.Tensor:
    """k-space spike artifact (TorchIO RandomSpike defaults)."""
    n, h, w = volume_nhw.shape
    spectrum = _centred_spectrum(volume_nhw)
    max_mag = spectrum.abs().amax(dim=(-2, -1))                              # (N,)
    intensity = _uniform(d.spike_intensity, *intensity_range)                # (S,)
    ys, xs = spike_positions(d, h, w)
    s = ys.shape[0]
    rows = torch.arange(n, device=volume_nhw.device)[:, None].expand(n, s)
    amp = (max_mag[:, None] * intensity[None, :]).to(spectrum.dtype)
    spectrum.index_put_((rows, ys.long()[None].expand(n, s), xs.long()[None].expand(n, s)),
                        amp, accumulate=True)
    return _rescale01(_from_centred(spectrum))


# --------------------------------------------------------------- ghosting
def ghost_lines(d: CorruptionDraws, n: int, restore: float = 0.02) -> np.ndarray:
    """The attenuated lines along the ghost axis (length ``n``): every
    num_ghosts-th index outside the spared band ``|idx - n // 2| <
    max(1, int(restore * n))``."""
    idx = np.arange(n)
    is_ghost_line = idx % max(d.num_ghosts, 1) == 0
    keep = np.abs(idx - n // 2) < max(1, int(np.float32(restore * n)))
    return is_ghost_line & ~keep


def random_ghosting(d: CorruptionDraws, volume_nhw: torch.Tensor,
                    intensity_range: Tuple[float, float] = (0.5, 1.0),
                    restore: float = 0.02) -> torch.Tensor:
    """Motion-ghost replicas by periodic k-space attenuation (TorchIO
    RandomGhosting defaults: num_ghosts (4, 10), intensity (0.5, 1))."""
    h, w = volume_nhw.shape[-2:]
    n = h if d.ghost_axis == 0 else w
    lines = torch.from_numpy(ghost_lines(d, n, restore)).to(volume_nhw.device)
    intensity = _uniform(d.ghost_intensity, *intensity_range)
    scale = torch.where(lines, 1.0 - intensity, torch.ones((), device=volume_nhw.device))
    scale = scale.reshape((n, 1) if d.ghost_axis == 0 else (1, n))
    return _rescale01(_from_centred(_centred_spectrum(volume_nhw) * scale))


# ------------------------------------------------------------------ motion
def _translate_rotate(volume_nhw: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
                      theta: torch.Tensor) -> torch.Tensor:
    """Every slice moved by one rigid transform: order-3 B-spline samples
    ('reflect') at the rotated and shifted grid, zero outside the frame."""
    h, w = volume_nhw.shape[-2:]
    dev = volume_nhw.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(-theta), torch.sin(-theta)
    yy = cos * (ys - cy) - sin * (xs - cx) + cy - dy
    xx = sin * (ys - cy) + cos * (xs - cx) + cx - dx
    return warp_image(volume_nhw.permute(1, 2, 0), yy, xx).permute(2, 0, 1)


def random_motion(d: CorruptionDraws, volume_nhw: torch.Tensor, degrees: float = 30.0,
                  translation: float = 10.0) -> torch.Tensor:
    """Motion artifact: k-space row segments from differently moved copies
    (TorchIO RandomMotion; the reference uses degrees=30, translation=10,
    generate_artefacted_data.py:58)."""
    h = volume_nhw.shape[-2]
    num_transforms = d.theta.shape[0]
    spectrum = torch.fft.fft2(volume_nhw)
    theta = _uniform(d.theta, -degrees, degrees) * DEG_TO_RAD
    dy = _uniform(d.dy, -translation, translation)
    dx = _uniform(d.dx, -translation, translation)
    bounds = torch.sort(_uniform(d.bounds, 0.1, 0.9)).values
    rows = (torch.arange(h, device=volume_nhw.device, dtype=torch.float32) / h)[:, None]
    for i in range(num_transforms):
        moved = torch.fft.fft2(_translate_rotate(volume_nhw, dy[i], dx[i], theta[i]))
        lo = bounds[i]
        hi = bounds[i + 1] if i + 1 < num_transforms else 1.1
        spectrum = torch.where((rows >= lo) & (rows < hi), moved, spectrum)
    return _rescale01(torch.fft.ifft2(spectrum).abs())


CORRUPTIONS = {
    "RandomBias": random_bias_field,
    "RandomSpike": random_spike,
    "RandomGhosting": random_ghosting,
    "RandomMotion": random_motion,
}


def corrupt_volume(draws: CorruptionDraws, volume_nhw: torch.Tensor) -> torch.Tensor:
    """Corruption ``draws.name`` on an (N, H, W) volume in [0, 1], one draw
    shared by every slice: the same bias field, spike position, ghost
    period and motion segments on each (the reference's one TorchIO
    transform per patient volume, generate_artefacted_data.py:66-110)."""
    return CORRUPTIONS[draws.name](draws, volume_nhw.float())
