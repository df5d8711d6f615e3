"""The K-epoch window: E epochs of training, each followed by validation,
Mean IoU and best-model selection on the device, one read back a window.

Counterpart of the JAX package's ``train/multi_epoch.py``
(``device_scores_from_confusion``; ``make_window_runner`` as
:class:`WindowRunner`), which scans E whole epochs inside one jitted
dispatch.  Here an epoch is the fused epoch
(``train/graphs.py:StepGraphs.run_epoch``, one CUDA graph replay a step on
the card), validation one replay of
``train/graphs.py:ValidationGraph`` over the stacked evaluation epoch, and
the selection a few device ops; nothing is read back until the training
loop (``train/driver.py``) fetches the window's results.

Semantics match the serial loop's:

* draws: the window's steps take the staged draws of its E epochs in the
  streaming loop's order (``train/draws.py:stage_draws``);
* validation: ``predict(n_iter=2)`` with STN refinement, wrap-padded eval
  rows left out of the confusion matrix;
* selection: strictly greater Mean IoU; the parameters and BN running
  statistics of the winning epoch are kept in best buffers on the device
  (``torch.where`` copies), as the reference saves exactly those.

The device's Mean IoU is float32 (the host's float64); the training loop
recomputes the logged scores in float64 from the same confusion matrices,
so only the selection rests on float32 rounding.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
)

StateDicts = Dict[str, Dict[str, torch.Tensor]]


def device_scores_from_confusion(hist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Mean IoU, mean class accuracy) of a (C, C) confusion matrix as
    float32 0-d tensors on its device, the JAX package's
    ``device_scores_from_confusion``: a class with no pixels (0 / 0) is
    left out of the means (``nanmean``)."""
    hist = hist.to(torch.float32)
    diag = torch.diagonal(hist)
    row, col = hist.sum(dim=1), hist.sum(dim=0)
    acc_cls = torch.nanmean(diag / row)
    iu = diag / (row + col - diag)
    return torch.nanmean(iu), acc_cls


def state_buffers(model) -> StateDicts:
    """Device copies of every module's ``state_dict`` (parameters and
    running statistics), outside any graph's memory pool."""
    return {name: {k: v.detach().clone() for k, v in getattr(model, name).state_dict().items()}
            for name in MODULE_NAMES}


class WindowRunner:
    """The JAX package's ``make_window_runner`` on the port's fused epoch
    and validation graph: ``run(idx_mats, steps, best_iou)`` trains E
    epochs with ``run_epoch`` (``train/graphs.py:StepGraphs.run_epoch``) on
    the staged steps (``steps[e * K:(e + 1) * K]`` for epoch e of the (E,
    K, raw_bs) index matrices ``idx_mats``), validates after each with ``validate``
    (``train/graphs.py:ValidationGraph``) and keeps the best epoch's
    parameters and BN statistics in :attr:`best` (allocated once, outside
    the graphs' pool).  It returns, all on the device: ``metrics`` (E, K,
    10) in ``METRIC_KEYS`` order, ``val_iou`` and ``val_acc`` (E,) float32,
    ``confusion`` (E, C, C) int64, ``best_iou`` (float32), ``best_epoch``
    (int64, the index into the window, -1 if no epoch beat ``best_iou``)
    and ``best`` (the best buffers, the window's first state when no epoch
    improved)."""

    def __init__(self, run_epoch, validate, model):
        self.run_epoch = run_epoch
        self.validate = validate
        self.model = model
        self.best = state_buffers(model)

    def _pairs(self):
        for name in MODULE_NAMES:
            live = getattr(self.model, name).state_dict()
            for k, best in self.best[name].items():
                yield best, live[k]

    def __call__(self, idx_mats: np.ndarray, steps: Sequence, best_iou: float) -> Dict:
        e_count, k_count = idx_mats.shape[:2]
        if len(steps) != e_count * k_count:
            raise ValueError(f"window: {e_count} x {k_count} batches, {len(steps)} staged steps")
        device = next(self.model.parameters()).device
        c = self.model.num_classes
        metrics = torch.empty((e_count, k_count, 10), dtype=torch.float32, device=device)
        confusion = torch.empty((e_count, c, c), dtype=torch.int64, device=device)
        ious = torch.empty(e_count, dtype=torch.float32, device=device)
        accs = torch.empty(e_count, dtype=torch.float32, device=device)
        # fills on the device, not host copies, so the host never waits here
        b_iou = torch.full((), best_iou, dtype=torch.float32, device=device)
        b_epoch = torch.full((), -1, dtype=torch.int64, device=device)
        # state_dict() hands out detached tensors, so these copies stay out
        # of autograd while the fused epochs in between train
        for best, live in self._pairs():
            best.copy_(live)
        for e in range(e_count):
            self.run_epoch(idx_mats[e], steps[e * k_count:(e + 1) * k_count], out=metrics[e])
            self.validate(confusion[e])
            iou, acc = device_scores_from_confusion(confusion[e])
            ious[e], accs[e] = iou, acc
            better = iou > b_iou
            b_iou = torch.where(better, iou, b_iou)
            b_epoch = torch.where(better, e, b_epoch)
            for best, live in self._pairs():
                best.copy_(torch.where(better, live, best))
        return {"metrics": metrics, "val_iou": ious, "val_acc": accs, "confusion": confusion,
                "best_iou": b_iou, "best_epoch": b_epoch, "best": self.best}
