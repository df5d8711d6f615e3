"""Input construction for the STN (shape autoencoder).

Counterpart of the logits branch of the JAX package's
``ops/image.py:construct_input``; the label-map branch (one-hot, label
smoothing) comes with the training slice.
"""

from __future__ import annotations

import torch


def construct_input(logits: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """Temperature softmax ``softmax(logits / T)`` over the class axis of
    NCHW logits."""
    return torch.softmax(logits / temperature, dim=1)
