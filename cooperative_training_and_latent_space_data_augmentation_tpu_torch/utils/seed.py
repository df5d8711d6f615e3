"""Seeding, a copy of the JAX package's ``utils/seed.py`` (the reference's
``basic_operations.set_seed:22-34`` without its torch and cuDNN toggles:
the port's draws come from explicit ``torch.Generator``s, and every step
on the card runs cuDNN's deterministic algorithms)."""

from __future__ import annotations

import random

import numpy as np


def set_seed(seed: int = 42) -> int:
    random.seed(seed)
    np.random.seed(seed)
    return seed
