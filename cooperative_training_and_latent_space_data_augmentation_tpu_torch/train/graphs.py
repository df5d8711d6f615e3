"""CUDA graphs of the cooperative train step and of validation.

The JAX package never runs its step op by op: ``make_train_step`` is one
jitted program, and its fused epoch scans (gather + augment + step) over
an epoch in one dispatch.  In PyTorch one device program replayed without
per-op host work is a CUDA graph, so the port's fused paths replay graphs
captured from its own step, augmentation and ``predict``.  This module has
no JAX counterpart: it is the mechanism behind ``jax.jit`` there.

:class:`StepGraphs` keeps one graph per tuple of host branches of a step
(``train/draws.py`` draws them as host ints; ``mask_type="random"`` on both
codes gives at most 3 x 3), each covering the batch's gather by index from
the dataset on the device, the training augmentation (whose stages are
selected per sample by ``torch.where``, so it has no host branch) and
``CooperativeTrainer.train_step``.  Its static inputs (the index vector
and one flat buffer a dtype holding the ``AugmentDraws`` and the
``StepDraws``, dropout masks included) are loaded by one device-to-device
copy each from the staged draws (``train/draws.py:StagedDraws``).
:class:`ValidationGraph` is one graph of validation over the stacked
evaluation epoch: ``predict(n_iter=2)``, the argmax and the confusion
matrix by ``index_add_``, so nothing is read back.

Memory.  Every graph is captured into one shared memory pool
(``torch.cuda.graph_pool_handle()``), so nine graphs do not cost nine
steps' activations.  PyTorch documents a shared pool for graphs replayed
in the order they were captured; here they replay in any order, so the
rule kept is that nothing a graph leaves in the pool is read after
another graph replays: each replay's outputs are copied out, outside the
graph, before the next replay; the ``.grad`` tensors are dead after the
optimizer step; parameters, BN buffers, Adam's state, the static inputs
and the window's best buffers are all allocated outside the pool.

Warm-up.  PyTorch's warm-up iterations before a capture would be real
optimizer steps here.  So the first occurrence of a branch tuple runs
eagerly, as its own real step, on the capture's side stream (it also
creates Adam's state and cuDNN's and cuBLAS's handles there), and the tuple
is captured right after it (a capture executes nothing); every later
occurrence replays.  A capture that fails raises: the port never falls
back to the streaming step.

The kernels' launch counters count Python calls of their wrappers, so they
tick once at a capture and never at a replay: each graph keeps its counts
at capture (``launches``) and its replays, and :func:`launched` turns the
counters' ticks over a run into the launches the card made.

On the CPU (the tests) the same bodies run uncaptured, step by step.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    conv_chw,
    conv_nl,
    conv_s2,
    percentile_mask,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    METRIC_KEYS,
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    StagedStep,
    StepDraws,
    views_into,
)

# the wrappers a train step launches through, by counter name
STEP_WRAPPERS = {
    "conv3x3_chw": (conv_chw, "conv3x3_chw"),
    "conv3x3_chw_dx": (conv_chw, "conv3x3_chw_dx"),
    "conv3x3_chw_dw": (conv_chw, "conv3x3_chw_dw"),
    "percentile_mask": (percentile_mask, "percentile_mask"),
    "conv3x3s2": (conv_s2, "conv3x3s2"),
    "conv3x3s2_dx": (conv_s2, "conv3x3s2_dx"),
    "conv3x3s2_dw": (conv_s2, "conv3x3s2_dw"),
    "conv3x3_nl": (conv_nl, "conv3x3_nl"),
    "conv3x3_nl_dx": (conv_nl, "conv3x3_nl_dx"),
    "conv3x3_nl_dw": (conv_nl, "conv3x3_nl_dw"),
}


def launch_counts() -> Dict[str, int]:
    """The step's kernel wrappers' launch counters, by name."""
    return {name: getattr(mod, fn).launches for name, (mod, fn) in STEP_WRAPPERS.items()}


def launched(ticks: Dict[str, int], steps: Sequence["StepGraphs"] = (),
             validations: Sequence["ValidationGraph"] = ()) -> Dict[str, int]:
    """The kernels the card launched over a run whose counters ticked
    ``ticks`` (by name) and whose graphs were ``steps`` and
    ``validations``, each with all of its captures and replays inside the
    run: the ticks less the captures' counts (a capture launches nothing)
    plus each graph's counts once a replay."""
    out = dict(ticks)
    graphs = [(c.launches, steps_.replays[key]) for steps_ in steps
              for key, c in steps_.graphs.items()]
    graphs += [(v.launches, v.replays) for v in validations if v.graph is not None]
    for counts, replays in graphs:
        for k, n in counts.items():
            out[k] = out.get(k, 0) + (replays - 1) * n
    return out


def pool_bytes(pool) -> Tuple[int, int]:
    """(reserved, allocated) bytes of the CUDA graph memory pool ``pool``
    (a ``torch.cuda.graph_pool_handle()``): the sums over its segments in
    the caching allocator's snapshot, so apart from the process's other
    caches."""
    reserved = allocated = 0
    for seg in torch.cuda.memory._snapshot()["segments"]:
        if tuple(seg.get("segment_pool_id", ())) == tuple(pool):
            reserved += seg["total_size"]
            allocated += seg["allocated_size"]
    return reserved, allocated


def branch_key(draws: StepDraws) -> Tuple:
    """What selects a step's graph: the image and shape codes' branches
    (None where latent DA leaves a code alone) and the number of dropout
    keep masks (``forward_plan``'s count, 0 without layer dropout)."""
    return (None if draws.image is None else draws.image.branch,
            None if draws.shape is None else draws.shape.branch,
            len(draws.dropout or ()))


class _Captured:
    """One captured graph, its static inputs and output, and what its
    capture cost and launched."""

    def __init__(self, graph, idx, flats, out, launches, seconds):
        self.graph = graph
        self.idx = idx
        self.flats = flats
        self.out = out
        self.launches = launches
        self.seconds = seconds

    def replay(self, idx: torch.Tensor, staged: StagedStep, out: torch.Tensor) -> None:
        self.idx.copy_(idx)
        for dt, flat in self.flats.items():
            flat.copy_(staged.flats[dt])
        self.graph.replay()
        out.copy_(self.out)


def _side_stream_call(stream, fn):
    """Run ``fn()`` on ``stream``, ordered after the current stream's work
    and before its later work."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        fn()
    current.wait_stream(stream)


class StepGraphs:
    """The train step of ``trainer`` on batches that ``pipeline``
    (``ops/augment.py:make_batch_train_pipeline_indexed``) gathers from
    ``images`` and ``labels`` (the dataset on the device) and augments, one
    CUDA graph per :func:`branch_key`, captured on first use (see the
    module docstring).  On the card the trainer must be ``capturable``; on
    the CPU every step runs uncaptured."""

    def __init__(self, trainer: CooperativeTrainer, pipeline: Callable,
                 images: torch.Tensor, labels: torch.Tensor):
        self.trainer = trainer
        self.pipeline = pipeline
        self.images, self.labels = images, labels
        self.graphed = images.device.type == "cuda"
        if self.graphed and not trainer.capturable:
            raise ValueError("a graphed train step needs CooperativeTrainer(capturable=True): "
                             "Adam's step count must live on the device")
        self.pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self.stream = torch.cuda.Stream(images.device) if self.graphed else None
        self.graphs: Dict[Tuple, _Captured] = {}
        self.replays: Counter = Counter()
        self.eager_steps = 0

    def body(self, idx: torch.Tensor, augment, step: StepDraws) -> torch.Tensor:
        """Gather, augment, one train step: the step's metrics stacked in
        ``METRIC_KEYS`` order, (10,) float32."""
        batch = self.pipeline(augment, self.images, self.labels, idx)
        metrics = self.trainer.train_step(batch["image"], batch["label"], step)
        return torch.stack([metrics[k] for k in METRIC_KEYS])

    def run(self, idx: torch.Tensor, staged: StagedStep, out: torch.Tensor) -> None:
        """One step on the raw samples ``idx`` with the staged draws
        ``staged``; its metrics go to ``out`` (10,).  Eager (and then
        captured) for a new branch tuple, replayed for a known one."""
        if not self.graphed:
            out.copy_(self.body(idx, staged.augment, staged.step))
            self.eager_steps += 1
            return
        key = branch_key(staged.step)
        captured = self.graphs.get(key)
        if captured is not None:
            captured.replay(idx, staged, out)
            self.replays[key] += 1
            return
        _side_stream_call(self.stream, lambda: out.copy_(
            self.body(idx, staged.augment, staged.step)))
        self.eager_steps += 1
        self.graphs[key] = self._capture(idx, staged)

    def run_epoch(self, idx_mat: np.ndarray, steps: Sequence[StagedStep],
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One fused epoch: a step (:meth:`run`) for each row of ``idx_mat``
        ((K, raw_bs) indices) with the staged draws ``steps[k]``; returns
        the (K, 10) float32 metrics on the device (into ``out`` if given),
        without reading anything back."""
        if len(steps) != len(idx_mat):
            raise ValueError(f"fused epoch: {len(idx_mat)} batches, {len(steps)} staged steps")
        device = self.images.device
        idx = torch.from_numpy(np.ascontiguousarray(idx_mat))
        # from pinned memory, so the copy does not block the host
        idx = idx.pin_memory().to(device, non_blocking=True) if self.graphed else idx.to(device)
        if out is None:
            out = torch.empty((len(idx_mat), len(METRIC_KEYS)), dtype=torch.float32,
                              device=device)
        for k, staged in enumerate(steps):
            self.run(idx[k], staged, out[k])
        return out

    def _capture(self, idx: torch.Tensor, staged: StagedStep) -> _Captured:
        s_idx = torch.empty_like(idx)
        flats = {dt: torch.empty_like(flat) for dt, flat in staged.flats.items()}
        augment, step = views_into((staged.augment, staged.step), flats)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = self.body(s_idx, augment, step)
        torch.cuda.synchronize(idx.device)
        seconds = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        return _Captured(graph, s_idx, flats, out, launches, seconds)


class ValidationGraph:
    """Validation of ``model`` over a stacked evaluation epoch
    (``data/loader.py:EvalBatcher.stacked_epoch``: images (Nb, B, h, w, C),
    labels (Nb, B, h, w) int32, real counts (Nb,)), by
    ``CooperativePredictor.validation_confusion``: (C, C) int64.  On the card the
    whole epoch is one CUDA graph in ``pool``, captured on the first call
    after an eager run on ``stream`` (which gives that call's result), and
    replayed after; on the CPU it runs uncaptured.  It reads the model's
    parameters and running statistics where they live, so it follows the
    training that updates them in place."""

    def __init__(self, model, images: torch.Tensor, labels: torch.Tensor,
                 real: torch.Tensor, n_iter: int = 2, pool=None,
                 stream: Optional[torch.cuda.Stream] = None):
        self.model = model
        self.images, self.labels, self.real = images, labels, real
        self.n_iter = n_iter
        self.graphed = images.device.type == "cuda"
        if self.graphed:
            self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
            self.stream = stream if stream is not None else torch.cuda.Stream(images.device)
        self.graph = None
        self.out: Optional[torch.Tensor] = None
        self.replays = 0
        self.launches: Dict[str, int] = {}  # the kernels' counts at its capture

    def body(self) -> torch.Tensor:
        return self.model.validation_confusion(self.images, self.labels, self.real, self.n_iter)

    def __call__(self, out: torch.Tensor) -> torch.Tensor:
        """Validate into ``out`` (C, C) int64; returns ``out``."""
        if not self.graphed:
            return out.copy_(self.body())
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            return out.copy_(self.out)
        _side_stream_call(self.stream, lambda: out.copy_(self.body()))
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            self.out = self.body()
        self.launches = {k: v - before[k] for k, v in launch_counts().items()}
        self.graph = graph
        return out
