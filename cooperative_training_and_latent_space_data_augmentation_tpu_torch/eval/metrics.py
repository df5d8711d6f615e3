"""The validation metric: a confusion matrix on the device, its IoU and
accuracy scores on the host.

Counterpart of the device side of the JAX package's ``eval/metrics.py``
(``confusion_matrix_update``, ``scores_from_confusion``, ``RunningScore``;
the reference's ``medseg/common_utils/metrics.py:runningScore:12-54``).
Its scipy surface metrics come with the held-out evaluation.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch


def confusion_matrix_update(confusion: torch.Tensor, label_true: torch.Tensor,
                            label_pred: torch.Tensor) -> torch.Tensor:
    """``confusion`` (C, C) int64 plus the counts of (true, predicted)
    pairs of two integer label maps, on their device, without reading
    anything back to the host.  Pixels whose true label lies outside
    ``[0, C)`` are not counted; the flat bin is clipped to ``[0, C * C]`` as
    ``jnp.bincount(..., length=C * C + 1)`` clips it.  (``torch.bincount``
    reads its input's minimum and maximum back to the host on a CUDA
    tensor, so the counts are one ``index_add_`` instead.)"""
    n = confusion.shape[0]
    lt = label_true.reshape(-1).long()
    lp = label_pred.reshape(-1).long()
    valid = (lt >= 0) & (lt < n)
    idx = torch.where(valid, lt * n + lp, n * n).clamp(0, n * n)
    counts = torch.zeros(n * n + 1, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return confusion + counts[:-1].view(n, n)


def scores_from_confusion(hist) -> Tuple[Dict[str, float], Dict[int, float]]:
    """IoU/acc summary with the reference's exact dict keys
    (metrics.py:30-52), in float64."""
    hist = np.asarray(hist, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        mean_iu = np.nanmean(iu)
        freq = hist.sum(axis=1) / hist.sum()
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()
    return {
        "Overall Acc: \t": acc,
        "Mean Acc : \t": acc_cls,
        "FreqW Acc : \t": fwavacc,
        "Mean IoU : \t": mean_iu,
    }, dict(zip(range(hist.shape[0]), iu))


class RunningScore:
    """Confusion-matrix mean IoU and accuracy (metrics.runningScore:12-54).
    The matrix accumulates on ``device`` in int64 (exact counts);
    :meth:`get_scores` is its only read back to the host."""

    def __init__(self, n_classes: int, device: Union[str, torch.device] = "cuda"):
        self.n_classes = n_classes
        self.device = torch.device(device)
        self.reset()

    def update(self, label_trues, label_preds) -> None:
        lt = torch.as_tensor(label_trues, device=self.device)
        lp = torch.as_tensor(label_preds, device=self.device)
        self.confusion_matrix = confusion_matrix_update(self.confusion_matrix, lt, lp)

    def get_scores(self):
        return scores_from_confusion(self.confusion_matrix.cpu().numpy())

    def reset(self) -> None:
        self.confusion_matrix = torch.zeros((self.n_classes, self.n_classes),
                                            dtype=torch.int64, device=self.device)
