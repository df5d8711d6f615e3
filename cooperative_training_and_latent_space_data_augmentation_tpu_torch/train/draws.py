"""The random draws of one cooperative train step, as tensors.

The JAX package draws inside its jitted step from a key
(``cooperative.py:611-615``, ``masking.py:107-112,125,146,171,201,235``).
The port takes the same draws as operands instead: a :class:`StepDraws`
made by :func:`draw_step` from an explicit ``torch.Generator`` (tests
replay the JAX key schedule into one, so both packages see the same
numbers).  Branch choices are Python ints drawn on the host, so the step
takes its branch without waiting for the device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union

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
    (the step scales it by its noise std), and the image and shape codes'
    :class:`CodeDraws` (None where latent DA leaves the code alone)."""

    noise: torch.Tensor
    image: Optional[CodeDraws] = None
    shape: Optional[CodeDraws] = None

    def to(self, device) -> "StepDraws":
        return StepDraws(self.noise.to(device),
                         None if self.image is None else self.image.to(device),
                         None if self.shape is None else self.shape.to(device))


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
              image_ch: int = 1, device: Union[str, torch.device, None] = None
              ) -> StepDraws:
    """The draws of one step for a batch of ``n`` images of ``image_hw``
    (latent (latent_ch, H/16, W/16)) from a CPU ``generator``, moved to
    ``device`` (default: left on the CPU)."""
    _check_host(generator)
    h, w = image_hw
    latent_hw = (h // 16, w // 16)
    noise = torch.randn((n, image_ch, h, w), generator=generator)
    image = shape = None
    if latent_da is not None and latent_da.gen_corrupted_image:
        image = draw_code(generator, latent_da.image_code, n, latent_ch, latent_hw)
    if latent_da is not None and latent_da.gen_corrupted_seg:
        shape = draw_code(generator, latent_da.shape_code, n, latent_ch, latent_hw)
    draws = StepDraws(noise, image, shape)
    return draws if device is None else draws.to(device)
