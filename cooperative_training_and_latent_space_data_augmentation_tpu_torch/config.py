"""Latent-DA configuration of the cooperative train step.

A copy of ``MaskConfig`` and ``LatentDAConfig`` from the JAX package's
``config.py`` (the port imports nothing of the JAX package), which mirror
``latent_DA`` in ``configs/ACDC/cooperative_training.json``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence


@dataclass
class MaskConfig:
    """One latent-code masking config (cooperative_training.json:54-66).

    ``loss_name``: task loss whose gradient drives targeted masking
    (mse | ce | corr).  ``mask_type``: random | dropout | spatial | channel;
    "random" draws uniformly among the latter three each step.
    """

    loss_name: str = "mse"
    mask_type: str = "random"
    max_threshold: float = 0.5
    random_threshold: bool = True
    if_soft: bool = True


@dataclass
class LatentDAConfig:
    """Mirrors ``latent_DA`` (cooperative_training.json:51-67)."""

    mask_scope: Sequence[str] = ("image code", "shape code")
    image_code: MaskConfig = field(default_factory=lambda: MaskConfig(loss_name="mse"))
    shape_code: MaskConfig = field(default_factory=lambda: MaskConfig(loss_name="ce"))

    @property
    def gen_corrupted_image(self) -> bool:
        return "image code" in self.mask_scope

    @property
    def gen_corrupted_seg(self) -> bool:
        return "shape code" in self.mask_scope
