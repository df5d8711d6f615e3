"""The segmentation loss of the cooperative train step.

Counterpart of the hard-label, unweighted branch of the JAX package's
``ops/losses.py:cross_entropy_2d``, the only loss branch the step reaches.
"""

from __future__ import annotations

import torch


def cross_entropy_2d(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Pixelwise cross entropy of NCHW ``logits`` against (N, H, W) integer
    labels: the summed negative log-likelihood under a log-softmax over the
    class axis, divided by ``target.numel() + 1e-10`` as the JAX package
    divides by ``target.size + 1e-10``."""
    log_p = torch.log_softmax(logits, dim=1)
    nll = -log_p.gather(1, target.long().unsqueeze(1))
    return nll.sum() / (target.numel() + 1e-10)
