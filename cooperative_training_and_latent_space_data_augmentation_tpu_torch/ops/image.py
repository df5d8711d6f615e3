"""Input construction for the STN (shape autoencoder).

Counterpart of the JAX package's ``ops/image.py:construct_input``: the
logits branch (temperature softmax) and the label-map branch (one-hot).
Label smoothing and the image concatenation are not on the train step's
path and are not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def construct_input(logits: torch.Tensor, temperature: float = 2.0) -> torch.Tensor:
    """Temperature softmax ``softmax(logits / T)`` over the class axis of
    NCHW logits."""
    return torch.softmax(logits / temperature, dim=1)


def one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N, H, W) integer labels -> (N, num_classes, H, W) float32 one-hot:
    the label-map branch of ``construct_input``."""
    return F.one_hot(labels.long(), num_classes).permute(0, 3, 1, 2).float()
