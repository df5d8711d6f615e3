"""Learning-rate schedules, the Adam-bound gradient clip and the baselines'
optimizer.

Counterpart of the JAX package's ``utils/schedulers.py`` (the reference's
``model_util.get_scheduler``, ``lr_poly`` and ``clip_grad``).  There the
optimizer is optax's Adam with the learning rate a function of the update
count, evaluated at the count *before* each update; here it is
``torch.optim.Adam`` whose learning rate :class:`Optimizer` sets from that
count before every step (no ``torch.optim.lr_scheduler``).  The
metric-driven 'plateau' policies are the host-side
:class:`ReduceLROnPlateau`, whose scale the caller writes into the
optimizer's ``learning_rate``, as ``inject_hyperparams`` does there.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

LR_POLICIES = ("lambda", "step", "step2", "plateau", "plateau2",
               "step_warmstart", "step_warmstart2", "poly")
EPOCH_WISE_POLICIES = ("lambda", "step", "step2", "step_warmstart", "step_warmstart2")


def lr_poly(base_lr: float, i: float, max_iter: float, power: float) -> float:
    """Polynomial decay ``base_lr (1 - i / max_iter) ** power``."""
    return base_lr * ((1 - float(i) / max_iter) ** power)


def make_lr_schedule(policy: str, lr_decay_iters: int = 5, epoch_count: int = 0,
                     niter: Optional[int] = None, niter_decay: Optional[int] = None,
                     max_iter: Optional[int] = None,
                     power: float = 0.985) -> Callable[[int], float]:
    """A ``step -> multiplicative scale`` function for ``policy``; steps are
    epochs for the epoch-wise policies and iterations for 'poly'."""
    if policy == "lambda":
        if niter is None or niter_decay is None:
            raise ValueError("'lambda' needs niter and niter_decay")

        def sched(e):
            return min(max(1.0 - max(0.0, e + 1 + epoch_count - niter) / float(niter_decay + 1),
                           0.0), 1.0)
    elif policy == "step":
        def sched(e):
            return 0.5 ** math.floor(e / lr_decay_iters)
    elif policy == "step2":
        def sched(e):
            return 0.1 ** math.floor(e / lr_decay_iters)
    elif policy == "step_warmstart":
        def sched(e):
            return 0.1 if e < 5 else 1.0 if e < 100 else 0.1 if e < 200 else 0.01
    elif policy == "step_warmstart2":
        def sched(e):
            return 0.1 if e < 5 else 1.0 if e < 50 else 0.1 if e < 100 else 0.01
    elif policy == "poly":
        if max_iter is None:
            raise ValueError("'poly' needs max_iter")

        def sched(i):
            return (1.0 - min(i, max_iter - 1) / max_iter) ** power
    elif policy in ("plateau", "plateau2"):
        raise ValueError(f"{policy!r} is metric-driven; use ReduceLROnPlateau and write its "
                         "scale into Optimizer.learning_rate")
    else:
        raise NotImplementedError(f"learning rate policy [{policy}] is not implemented")
    return sched


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch's ReduceLROnPlateau, mode 'min',
    relative threshold): ``step(metric)`` returns the current scale."""

    def __init__(self, factor: float = 0.1, threshold: float = 0.01, patience: int = 5,
                 min_scale: float = 1e-8):
        self.factor = factor
        self.threshold = threshold
        self.patience = patience
        self.min_scale = min_scale
        self.best = float("inf")
        self.num_bad = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.num_bad = 0
        return self.scale


def make_plateau_scheduler(policy: str) -> ReduceLROnPlateau:
    if policy == "plateau":
        return ReduceLROnPlateau(factor=0.1, threshold=0.01, patience=5)
    if policy == "plateau2":
        return ReduceLROnPlateau(factor=0.2, threshold=0.01, patience=5)
    raise NotImplementedError(policy)


class AdamBoundClip:
    """The IGEBM Adam-bound clip: each gradient clamped to
    ``+-(3 sqrt(nu / (1 - 0.999^count)) + 0.1)`` with this transform's own
    second-moment estimate ``nu`` *before* the update (the reference clips
    before ``optimizer.step()``), skipped at count 0, then ``nu`` moved by
    the clipped gradient.  The bias correction is in float32, as JAX's."""

    def __init__(self, params: Iterable[torch.Tensor], beta2: float = 0.999, eps: float = 0.1,
                 mult: float = 3.0):
        self.beta2, self.eps, self.mult = beta2, eps, mult
        self.nu = [torch.zeros_like(p, memory_format=torch.preserve_format) for p in params]

    @torch.no_grad()
    def apply(self, params, count: int) -> None:
        """Clip the ``.grad`` of ``params`` in place at update ``count``."""
        bias = float(np.float32(1.0) - np.float32(self.beta2) ** np.float32(max(count, 1)))
        for p, v in zip(params, self.nu):
            g = p.grad
            if g is None:
                continue
            if count >= 1:
                bound = self.mult * torch.sqrt(v / bias) + self.eps
                g.copy_(torch.minimum(torch.maximum(g, -bound), bound))
            v.mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)


class Optimizer:
    """optax's ``adam(learning_rate)`` (b1 0.9, b2 0.999, eps 1e-8), behind
    the :class:`AdamBoundClip` with ``clip``: ``torch.optim.Adam`` whose
    learning rate is set before each step from ``learning_rate`` (a float,
    or a function of the update count ``count`` before the update).
    ``learning_rate`` may be reassigned between steps (the plateau
    policies)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: Union[float, Callable[[int], float]], clip: bool = False):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.adam = torch.optim.Adam(self.params, lr=self.lr(0))
        self.clip = AdamBoundClip(self.params) if clip else None
        self.count = 0

    def lr(self, count: Optional[int] = None) -> float:
        """The learning rate of the update at ``count`` (default: the next)."""
        count = self.count if count is None else count
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = self.lr()
        for group in self.adam.param_groups:
            group["lr"] = lr
        if self.clip is not None:
            self.clip.apply(self.params, self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> Dict[str, object]:
        return {"adam": self.adam.state_dict(), "count": self.count,
                "clip_nu": None if self.clip is None else [v.detach().cpu() for v in self.clip.nu]}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])
        if self.clip is not None:
            for v, saved in zip(self.clip.nu, state["clip_nu"]):
                v.copy_(saved)


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   policy: Optional[str] = None, clip: bool = False,
                   steps_per_epoch: int = 1, **sched_kw) -> Optimizer:
    """Adam with an optional named LR policy and the Adam-bound clip.
    ``steps_per_epoch`` turns the update count into the epoch count of the
    epoch-wise policies (ignored by 'poly').  Under 'plateau'/'plateau2'
    the learning rate is a plain float for the caller to rescale."""
    lr: Union[float, Callable[[int], float]] = learning_rate
    if policy is not None and policy not in ("plateau", "plateau2"):
        sched = make_lr_schedule(policy, **sched_kw)
        if policy in EPOCH_WISE_POLICIES:
            def lr(count):
                return learning_rate * sched(count // steps_per_epoch)
        else:
            def lr(count):
                return learning_rate * sched(count)
    return Optimizer(params, lr, clip)
