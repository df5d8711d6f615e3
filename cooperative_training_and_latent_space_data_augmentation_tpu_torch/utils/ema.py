"""Exponential moving average of a model's parameters.

Counterpart of the JAX package's ``utils/ema.py`` (the reference's
``model_util.ExponentialMovingAverage``): the same surface (``update``,
``copy_to``, ``store``, ``restore``) and warm-up decay
``min(decay, (1 + n) / (10 + n))`` with ``use_num_updates``.  The JAX class
returns new trees; this one keeps its shadow tensors and copies in place, as
the reference does.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch


class ExponentialMovingAverage:
    """An EMA of ``parameters`` (an iterable of tensors, in a fixed order)."""

    def __init__(self, parameters: Iterable[torch.Tensor], decay: float,
                 use_num_updates: bool = True):
        if decay < 0.0 or decay > 1.0:
            raise ValueError("Decay must be between 0 and 1")
        self.decay = decay
        self.num_updates: Optional[int] = 0 if use_num_updates else None
        self.shadow_params: List[torch.Tensor] = [p.detach().clone() for p in parameters]
        self.collected_params: Optional[List[torch.Tensor]] = None

    @torch.no_grad()
    def update(self, parameters: Iterable[torch.Tensor]) -> None:
        """Fold the current parameters into the shadow, ``s - (1 - d)(s -
        p)`` (call after each optimizer step)."""
        decay = self.decay
        if self.num_updates is not None:
            self.num_updates += 1
            decay = min(decay, (1 + self.num_updates) / (10 + self.num_updates))
        one_minus = float(torch.tensor(1.0) - torch.tensor(decay, dtype=torch.float32))
        for s, p in zip(self.shadow_params, parameters):
            s.sub_(one_minus * (s - p.detach()))

    @torch.no_grad()
    def copy_to(self, parameters: Iterable[torch.Tensor]) -> None:
        """Write the EMA values into ``parameters``."""
        for s, p in zip(self.shadow_params, parameters):
            p.copy_(s)

    def store(self, parameters: Iterable[torch.Tensor]) -> None:
        """Stash copies of ``parameters`` (before :meth:`copy_to` swaps the
        EMA values in)."""
        self.collected_params = [p.detach().clone() for p in parameters]

    @torch.no_grad()
    def restore(self, parameters: Iterable[torch.Tensor]) -> None:
        """Write the stashed values back into ``parameters``; without a
        stash, leave them and say so, as the reference does."""
        if self.collected_params is None:
            print("did not find any copy, use the original params")
            return
        for c, p in zip(self.collected_params, parameters):
            p.copy_(c)
