"""The random draws of one cooperative train step, as tensors.

The JAX package draws inside its jitted step from a key
(``cooperative.py:611-615``, ``masking.py:107-112,125,146,171,201,235``).
The port takes the same draws as operands instead: a :class:`StepDraws`
made by :func:`draw_step` from an explicit ``torch.Generator`` (tests
replay the JAX key schedule into one, so both packages see the same
numbers).  Branch choices are Python ints drawn on the host, so the step
takes its branch without waiting for the device.

Layer dropout's keep masks are operands too: one (N, C) mask for every
dropout site of every module forward of the step, in the order the step
runs them (:func:`forward_plan`), where the JAX package folds a per-forward
counter into a third key (``cooperative.py:82-115,611-612``).

The fused paths draw a whole epoch, or a window of epochs, up front
(:func:`stage_draws`): every batch's augmentation draws and every step's
draws, in the streaming loop's call order, packed into one pinned host
buffer a dtype, copied to the device once without blocking, and read there
through views (:class:`StagedDraws`); under a data-parallel mesh, each
step's draws as this rank's rows.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, is_dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
    MaskConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.masking import (
    BRANCHES,
)


@dataclass
class CodeDraws:
    """Draws of one latent code's perturbation.

    branch: 0 dropout, 1 spatial, 2 channel.  keep: (N, C) 0/1 dropout keep
    mask (dropout only).  p: the percentile, a 0-d float32 tensor
    (targeted only).  soft: (N, D) values written at masked positions,
    ``0.5 * U(0, 1)`` for soft masks and zeros for hard ones, D = C for
    channel and h*w for spatial masking (targeted only)."""

    branch: int
    keep: Optional[torch.Tensor] = None
    p: Optional[torch.Tensor] = None
    soft: Optional[torch.Tensor] = None

    def to(self, device) -> "CodeDraws":
        move = (lambda t: None if t is None else t.to(device))
        return replace(self, keep=move(self.keep), p=move(self.p), soft=move(self.soft))


@dataclass
class StepDraws:
    """Draws of one train step: ``noise`` (N, 1, H, W) standard normal
    (the step scales it by its noise std), the image and shape codes'
    :class:`CodeDraws` (None where latent DA leaves the code alone), and
    ``dropout``, the layer-dropout keep masks ((N, C) 0/1 float32, in the
    step's forward order; None without layer dropout)."""

    noise: torch.Tensor
    image: Optional[CodeDraws] = None
    shape: Optional[CodeDraws] = None
    dropout: Optional[List[torch.Tensor]] = None

    def to(self, device) -> "StepDraws":
        return StepDraws(self.noise.to(device),
                         None if self.image is None else self.image.to(device),
                         None if self.shape is None else self.shape.to(device),
                         None if self.dropout is None else [m.to(device) for m in self.dropout])


def forward_plan(latent_da: Optional[LatentDAConfig], branches: Dict[str, int],
                 saliency_bn_update: bool = False) -> List[str]:
    """The module forwards of one train step, by module name, in the order
    the step runs them (the JAX package's trace order): the standard pass
    (FTN, ground-truth recon, predicted recon); per perturbed code (image,
    then shape; ``branches`` {"image": b, "shape": b}) the decoder's
    saliency forward (targeted branches only), its decode of the masked
    code and, with ``saliency_bn_update``, its forward on the unmasked
    code; then the hard pass (FTN and the recon of its prediction on the
    hard image; the recon of the perturbed segmentation)."""
    ftn = ["image_encoder", "segmentation_decoder", "image_decoder"]
    stn = ["shape_encoder", "shape_decoder"]
    plan = ftn + stn + stn
    if latent_da is None or not (latent_da.gen_corrupted_image or latent_da.gen_corrupted_seg):
        return plan
    codes = (("image", latent_da.gen_corrupted_image, "image_decoder"),
             ("shape", latent_da.gen_corrupted_seg, "segmentation_decoder"))
    for key, on, decoder in codes:
        if on:
            plan += [decoder] * ((branches[key] != 0) + 1 + saliency_bn_update)
    if latent_da.gen_corrupted_image:
        plan += ftn + stn
    if latent_da.gen_corrupted_seg:
        plan += stn
    return plan


def draw_dropout(generator: torch.Generator, n: int, plan: Sequence[str],
                 sites: Dict[str, Tuple[float, Sequence[int]]]) -> List[torch.Tensor]:
    """Keep masks for the forwards of ``plan``: for a module with
    ``sites[name] = (rate, channels)``, one (n, c) ``bernoulli(1 - rate)``
    mask per channel count, in order."""
    masks = []
    for name in plan:
        rate, channels = sites.get(name, (None, ()))
        for c in channels:
            masks.append(torch.bernoulli(torch.full((n, c), 1.0 - rate), generator=generator))
    return masks


def draw_code(generator: torch.Generator, cfg: MaskConfig, n: int, c: int,
              latent_hw: Tuple[int, int]) -> CodeDraws:
    """One code's draws for a code of (n, c, *latent_hw), on the host from
    a CPU ``generator``: the branch (uniform over the three under
    ``mask_type="random"``), then what that branch uses."""
    _check_host(generator)
    if cfg.mask_type == "random":
        branch = int(torch.randint(0, 3, (), generator=generator))
    else:
        branch = BRANCHES.index(cfg.mask_type)
    thr = cfg.max_threshold
    if branch == 0:
        keep = torch.bernoulli(torch.full((n, c), 1.0 - thr), generator=generator)
        return CodeDraws(branch, keep=keep)
    if cfg.random_threshold:
        p = torch.rand((), generator=generator) * thr
    else:
        p = torch.tensor(thr, dtype=torch.float32)
    d = c if branch == 2 else latent_hw[0] * latent_hw[1]
    if cfg.if_soft:
        soft = 0.5 * torch.rand((n, d), generator=generator)
    else:
        soft = torch.zeros((n, d))
    return CodeDraws(branch, p=p, soft=soft)


def _check_host(generator: torch.Generator) -> None:
    if generator.device.type != "cpu":
        raise ValueError("draws are made on the host from a CPU generator (so a "
                         "branch is known without a device sync); move them to the "
                         "device with StepDraws.to")


def draw_step(generator: torch.Generator, n: int, image_hw: Tuple[int, int],
              latent_da: Optional[LatentDAConfig], latent_ch: int = 128,
              image_ch: int = 1, device: Union[str, torch.device, None] = None,
              dropout_sites: Optional[Dict[str, Tuple[float, Sequence[int]]]] = None,
              saliency_bn_update: bool = False) -> StepDraws:
    """The draws of one step for a batch of ``n`` images of ``image_hw``
    (latent (latent_ch, H/16, W/16)) from a CPU ``generator``, moved to
    ``device`` (default: left on the CPU).  ``dropout_sites`` ({module:
    (rate, channels of its dropout sites)}, the trainer's
    ``dropout_sites``) adds the layer-dropout masks of the step's
    :func:`forward_plan`."""
    _check_host(generator)
    h, w = image_hw
    latent_hw = (h // 16, w // 16)
    noise = torch.randn((n, image_ch, h, w), generator=generator)
    image = shape = None
    if latent_da is not None and latent_da.gen_corrupted_image:
        image = draw_code(generator, latent_da.image_code, n, latent_ch, latent_hw)
    if latent_da is not None and latent_da.gen_corrupted_seg:
        shape = draw_code(generator, latent_da.shape_code, n, latent_ch, latent_hw)
    masks = None
    if dropout_sites:
        branches = {k: c.branch for k, c in (("image", image), ("shape", shape)) if c is not None}
        masks = draw_dropout(generator, n, forward_plan(latent_da, branches, saliency_bn_update),
                             dropout_sites)
    draws = StepDraws(noise, image, shape, masks)
    return draws if device is None else draws.to(device)


def shard_draws(draws: StepDraws, mesh) -> StepDraws:
    """This rank's draws of a global step's ``draws`` over ``mesh``
    (``parallel/mesh.py``): the rows of every per-sample tensor (the
    noise, each code's keep mask and soft values, the dropout keep masks);
    the percentile ``p`` and the branches, one a batch, as they are."""
    def code(c: Optional[CodeDraws]) -> Optional[CodeDraws]:
        if c is None:
            return None
        return replace(c, keep=None if c.keep is None else mesh.rows(c.keep),
                       soft=None if c.soft is None else mesh.rows(c.soft))

    return StepDraws(mesh.rows(draws.noise), code(draws.image), code(draws.shape),
                     None if draws.dropout is None else [mesh.rows(m) for m in draws.dropout])


# --------------------------------------------------------------- staging
def tensors_of(draws) -> List[torch.Tensor]:
    """Every tensor of a draws structure (a dataclass of tensors, tuples,
    lists, nested dataclasses and host ints such as a branch), in field
    order."""
    if isinstance(draws, torch.Tensor):
        return [draws]
    if isinstance(draws, (list, tuple)):
        return [t for v in draws for t in tensors_of(v)]
    if is_dataclass(draws):
        return [t for f in fields(draws) for t in tensors_of(getattr(draws, f.name))]
    return []


def _rebuild(draws, tensors):
    """``draws`` with its tensors, in :func:`tensors_of` order, taken from
    the iterator ``tensors``."""
    if isinstance(draws, torch.Tensor):
        return next(tensors)
    if isinstance(draws, (list, tuple)):
        return type(draws)(_rebuild(v, tensors) for v in draws)
    if is_dataclass(draws):
        return replace(draws, **{f.name: _rebuild(getattr(draws, f.name), tensors)
                                 for f in fields(draws)})
    return draws


def packed_sizes(draws) -> Dict[torch.dtype, int]:
    """Elements a dtype that :func:`views_into` reads for ``draws``."""
    sizes: Dict[torch.dtype, int] = {}
    for t in tensors_of(draws):
        sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
    return sizes


def views_into(draws, flats: Dict[torch.dtype, torch.Tensor]):
    """A structure like ``draws`` whose tensors are views, in
    :func:`tensors_of` order, into the flat 1-D tensors ``flats`` (one a
    dtype, read from their start): two structures with the same branches
    and shapes lay out the same, so one copy a dtype moves one into the
    other."""
    at = dict.fromkeys(flats, 0)
    views = []
    for t in tensors_of(draws):
        i = at[t.dtype]
        views.append(flats[t.dtype][i:i + t.numel()].view(t.shape))
        at[t.dtype] = i + t.numel()
    return _rebuild(draws, iter(views))


@dataclass
class StagedStep:
    """One staged step: its batch's ``augment`` draws and its ``step``
    draws, views into ``flats``, its contiguous segment (one flat tensor a
    dtype) of the staged buffers."""

    augment: object
    step: StepDraws
    flats: Dict[torch.dtype, torch.Tensor]

    @property
    def branches(self) -> Dict[str, int]:
        return {key: code.branch for key, code in (("image", self.step.image),
                                                   ("shape", self.step.shape))
                if code is not None}


class StagedDraws:
    """The draws of a run of steps on ``device``: ``(augment, step)``
    pairs drawn on the host, packed into one flat host buffer a dtype
    (pinned when ``device`` is a CUDA device), copied there without
    blocking, and handed out as :class:`StagedStep` views.  The host
    buffers stay referenced as long as this object, so the copy never reads
    freed memory."""

    def __init__(self, pairs: Sequence[Tuple[object, StepDraws]],
                 device: Union[str, torch.device]):
        device = torch.device(device)
        dtypes = sorted({t.dtype for pair in pairs for t in tensors_of(pair)}, key=str)
        host = {dt: torch.cat([t.reshape(-1) for pair in pairs for t in tensors_of(pair)
                               if t.dtype == dt]) for dt in dtypes}
        if device.type == "cuda":
            host = {dt: t.pin_memory() for dt, t in host.items()}
        self._host = host
        flat = {dt: t.to(device, non_blocking=True) for dt, t in host.items()}
        self.steps: List[StagedStep] = []
        at = dict.fromkeys(dtypes, 0)
        for pair in pairs:
            sizes = packed_sizes(pair)
            seg = {dt: flat[dt][at[dt]:at[dt] + n] for dt, n in sizes.items()}
            for dt, n in sizes.items():
                at[dt] += n
            augment, step = views_into(pair, seg)
            self.steps.append(StagedStep(augment, step, seg))

    def __len__(self) -> int:
        return len(self.steps)


def stage_draws(source, epochs: Sequence[int], n_steps: int, policy, raw_n: int, pad_hw,
                n: int, hw: Tuple[int, int], latent_da: Optional[LatentDAConfig],
                device: Union[str, torch.device], mesh=None, **kw) -> StagedDraws:
    """Draw ``n_steps`` steps of each epoch of ``epochs`` from the draw
    source ``source`` (``augment(epoch, policy, raw_n, pad_hw)`` and
    ``step(n, hw, latent_da, **kw)``, see :mod:`.driver`) in the streaming
    loop's order, batch k's augmentation draws and then step k's draws,
    and stage them on ``device``.  Under a ``mesh`` each step's draws are
    the global step's drawn in full and staged as this rank's rows
    (:func:`shard_draws`); the augmentation draws stay whole, since each
    rank augments the global batch and keeps its rows."""
    pairs = []
    for epoch in epochs:
        for _ in range(n_steps):
            augment = source.augment(epoch, policy, raw_n, pad_hw)
            step = source.step(n, hw, latent_da, **kw)
            pairs.append((augment, step if mesh is None else shard_draws(step, mesh)))
    return StagedDraws(pairs, device)
