"""The segmentation loss of the cooperative train step.

Counterpart of the JAX package's ``ops/losses.py:cross_entropy_2d`` (the
reference's ``custom_loss.cross_entropy_2D``), NCHW: hard labels or soft
targets, with or without class weights.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch


def cross_entropy_2d(logits: torch.Tensor, target: torch.Tensor,
                     weight: Optional[Union[Sequence[float], torch.Tensor]] = None,
                     size_average: bool = True) -> torch.Tensor:
    """Pixelwise cross entropy of NCHW ``logits`` under a log-softmax over
    the class axis.

    * (N, H, W) integer ``target``: the summed negative log-likelihood,
      divided by ``target.numel() + 1e-10`` with ``size_average`` (the JAX
      package's ``target.size + 1e-10``); class weights are normalised to
      sum C (``w / w.sum() * C``) and multiply each pixel's term.
    * (N, C, H, W) ``target``: the logits of a soft reference q =
      softmax(target); ``-sum_c q log p`` averaged over pixels, or with
      weights ``-sum(q log p w) / (target.numel() / C)``.
    """
    c = logits.shape[1]
    log_p = torch.log_softmax(logits, dim=1)
    w = None
    if weight is not None:
        w = torch.as_tensor(weight, dtype=log_p.dtype, device=log_p.device)
        w = w / w.sum() * c
    if target.dim() == logits.dim() - 1:
        nll = -log_p.gather(1, target.long().unsqueeze(1))
        if w is not None:
            nll = nll * w[target.long()].unsqueeze(1)
        loss = nll.sum()
        return loss / (target.numel() + 1e-10) if size_average else loss
    if target.dim() == logits.dim():
        plogq = torch.softmax(target, dim=1) * log_p
        if w is None:
            return -plogq.sum(1).mean()
        return -(plogq * w.view(1, c, 1, 1)).sum() / (target.numel() / c)
    raise ValueError(f"bad target rank {target.dim()} for logits rank {logits.dim()}")
