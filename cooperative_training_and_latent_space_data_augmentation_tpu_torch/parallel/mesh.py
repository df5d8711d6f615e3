"""Data-parallel training over ranks: the batch sharded, the parameters
replicated, the gradients all-reduced.

Counterpart of the JAX package's ``parallel/mesh.py`` (``make_mesh``,
``batch_sharding``, ``shard_batch``, ``replicate``, ``shard_train_step``,
``pad_batch_to_multiple``).  Under ``pjit`` XLA inserts the collectives;
here a rank is a process (:func:`launch` starts them) and the port calls
them itself, so that W ranks on a global batch compute what one process
computes on the whole batch:

* every train-mode :class:`..models.blocks.BatchNorm` normalises with the
  global batch's statistics (:meth:`Mesh.batch_moments`: the mean as the
  all-reduced ``sum(x) / N``, the variance as the all-reduced
  ``sum((x - mean)^2) / N``, the JAX package's two-pass formula, through a
  differentiable all-reduce whose backward all-reduces the gradient), and
  moves its running statistics by the global batch's;
* ``CooperativeTrainer.train_step`` all-reduces the gradients (their mean
  over ranks, one flat buffer a dtype) before Adam, and returns each
  metric's mean over ranks.  Each rank's loss is its shard's mean, so
  with BatchNorm's cross-rank backward a rank's latent-code gradient,
  the saliency of targeted masking, is W times the one-process one: the
  percentile mask is invariant to that positive scale (exact in floats
  for W a power of two);
* every rank draws the global step's draws from the same generator and
  takes its rows (``train/draws.py:shard_draws``); batches are the global
  batch's rows ``[r * b, (r + 1) * b)``, JAX's order.

The model is not wrapped in ``DistributedDataParallel``: the step calls
the five subnetworks many times and takes ``torch.autograd.grad`` with
respect to the latent codes inside its forward, which DDP's reducer hooks
do not follow.

Backend rule: NCCL when every rank has a card of its own (device "cuda"
and at least ``n_devices`` cards); gloo when ranks share one card or run
on the CPU.  :func:`launch` prints the choice.  Only ``all_reduce``,
``broadcast`` and ``barrier`` are called, the collectives gloo runs on
CUDA tensors (staged through host memory by gloo itself), so two ranks
can share one card.

CUDA graphs.  NCCL's collectives can be captured into a CUDA graph (each
runs on NCCL's own stream, joined to the capture by events), gloo's
cannot (:func:`collectives_capturable`, :attr:`Mesh.capturable`): the
fused epoch on the card captures the sharded step, collectives and all,
only under NCCL, and refuses a mesh whose collectives cannot be captured
(``data/loader.py:CooperativeBatcher.fused_epoch_runner``).  Under
capture a collective allocates only in the graph's pool (the copies of
``_AllReduceSum``, the flat buffers of ``Mesh.average_``) and reads
nothing back; ``Mesh.calls`` ticks once a collective at capture, as the
kernels' launch counters do, and ``train/graphs.py:launched`` adds each
graph's collectives once a replay.
"""

from __future__ import annotations

import io
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (  # noqa: F401
    pad_batch_to_multiple,
)

RANK_TIMEOUT_S = 600  # a collective that waits longer fails the run


def collectives_capturable(backend: str) -> bool:
    """Whether a CUDA graph can capture the collectives of ``backend``:
    NCCL's yes, gloo's no."""
    return backend == "nccl"


@dataclass(eq=False)
class Mesh:
    """One rank's view of a 1-D data mesh: ``size`` ranks, this one's
    ``rank``, its ``device``, the process ``group`` (None: the default
    one), the ``backend`` and the ``axis_name``.  ``calls`` and
    ``seconds`` count the collectives this rank called (one at a capture
    too, which runs nothing) and the host seconds inside them; with
    ``timed`` each first waits for the device, so that ``seconds`` holds
    the communication alone (refused during a capture, where nothing may
    wait for the device)."""

    size: int
    rank: int
    device: torch.device
    group: Any = None
    backend: str = "gloo"
    axis_name: str = "data"
    timed: bool = False
    calls: int = 0
    seconds: float = 0.0

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this mesh's collectives."""
        return collectives_capturable(self.backend)

    # ------------------------------------------------------- collectives
    def _run(self, fn: Callable[[], None], t: torch.Tensor) -> None:
        cuda = t.is_cuda and self.timed
        if cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("Mesh.timed synchronizes the device around each collective, "
                               "which a CUDA graph capture forbids: time replays instead")
        if cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(t.device)
        self.seconds += time.perf_counter() - t0
        self.calls += 1

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place."""
        self._run(lambda: dist.all_reduce(t, group=self.group), t)
        return t

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of rank ``src`` on every rank, in place."""
        self._run(lambda: dist.broadcast(t, src, group=self.group), t)
        return t

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable: the backward
        sums the gradient over the ranks too."""
        return _AllReduceSum.apply(t, self)

    def average_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Replace each tensor by its mean over the ranks: one all-reduce
        over a flat buffer a dtype, then a division by ``size``."""
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            self.all_reduce_(flat).div_(self.size)
            at = 0
            for t in group:
                t.copy_(flat[at:at + t.numel()].view_as(t))
                at += t.numel()

    # ------------------------------------------------------------ shards
    def rows(self, t):
        """This rank's rows ``[r * b, (r + 1) * b)`` of the global axis 0
        of ``t`` (a tensor or numpy array), which must divide evenly."""
        return t[batch_sharding(self, t.shape[0])]

    def local_count(self, real_count: int, n: int) -> int:
        """How many of this rank's rows of a global batch of ``n`` lie below
        the batch's ``real_count`` (the rest are wrap-padding)."""
        b = n // self.size
        return max(0, min(b, real_count - self.rank * b))

    def batch_moments(self, x: torch.Tensor, axes: Sequence[int]):
        """(mean, biased variance, count) of ``x`` over ``axes`` of the
        global batch (the ranks' shards together), keeping the reduced
        axes as size 1: the JAX package's BatchNorm under ``pjit``."""
        local = 1
        for a in axes:
            local *= x.shape[a]
        n = local * self.size
        mean = self.reduce_sum(x.sum(axes, keepdim=True)) / n
        var = self.reduce_sum((x - mean).square().sum(axes, keepdim=True)) / n
        return mean, var, n


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the incoming gradient over
    the ranks (each rank's loss depends on every rank's input through the
    sum)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.all_reduce_(grad.clone(memory_format=torch.contiguous_format)), None


# ------------------------------------------------------------------ mesh
def backend_for(n_devices: int, device: Union[str, torch.device]) -> str:
    """The module docstring's rule: NCCL when each of the ``n_devices``
    ranks has a card of its own, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n_devices:
        return "nccl"
    return "gloo"


def rank_device(rank: int, backend: str, device: Union[str, torch.device]) -> torch.device:
    """A rank's device: card ``rank`` under NCCL, the one card shared
    under gloo, or the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank if backend == "nccl" else (device.index or 0))


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The 1-D data mesh of the initialised process group (:func:`launch`
    initialises it) over its first ``n_devices`` ranks (default: all),
    with this rank's device (default: the backend rule's device for
    ``"cuda"`` when a card is present, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks with "
                           "parallel.mesh.launch")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh({n_devices}): the process group has {world} ranks")
    if len(axis_names) != 1:
        raise ValueError(f"a 1-D data mesh has one axis name, got {tuple(axis_names)}")
    backend = dist.get_backend()
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    rank = dist.get_rank()
    return Mesh(size=world, rank=rank, device=rank_device(rank, backend, device),
                backend=backend, axis_name=axis_names[0])


def batch_sharding(mesh: Mesh, n: int) -> slice:
    """The rows ``[r * b, (r + 1) * b)`` of a global batch of ``n`` that
    this rank holds; ``n`` must divide over the ranks."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over {mesh.size} ranks")
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def replicate_sharding(mesh: Mesh) -> slice:
    """The rows every rank holds of a replicated array (the JAX package's
    ``NamedSharding(mesh, P())``): all of them, ``t[replicate_sharding(mesh)]``
    is ``t``.  What rides in replicated: the parameters and optimizer state,
    the dataset on the device, an epoch's index matrix and its augmentation
    draws (each rank augments the global batch, then keeps its rows)."""
    return slice(None)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows (axis 0) of a tensor, or of every tensor of a dict."""
    if isinstance(batch, dict):
        return {k: mesh.rows(v) for k, v in batch.items()}
    return mesh.rows(batch)


def replicate(mesh: Mesh, module_or_tensors):
    """Rank 0's values on every rank: the parameters and buffers of a
    module, or a list of tensors, broadcast in place."""
    tensors = (list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
               if isinstance(module_or_tensors, torch.nn.Module) else list(module_or_tensors))
    with torch.no_grad():
        for t in tensors:
            mesh.broadcast_(t)
    return module_or_tensors


def shard_train_step(trainer, mesh: Mesh):
    """Put a ``CooperativeTrainer`` into data-parallel mode over ``mesh``
    (see the module docstring): BatchNorm on the global batch, its state
    replicated from rank 0, its ``train_step`` taking this rank's rows of
    the batch and of the draws (``shard_batch``, ``draws.shard_draws``).
    Returns the trainer."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
        BatchNorm,
    )

    for m in trainer.model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
    replicate(mesh, trainer.model)
    trainer.mesh = mesh
    return trainer


# ---------------------------------------------------------------- ranks
def _dumps(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _loads(data: bytes):
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=False)


def _rank_main(rank: int, n: int, backend: str, device: str, init_file: str,
               threads: int, payload: bytes, results) -> None:
    try:
        fn, args = _loads(payload)
        dev = rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{init_file}", world_size=n,
                                rank=rank, timeout=timedelta(seconds=RANK_TIMEOUT_S))
        try:
            mesh = make_mesh(n, device=device)
            out = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, _dumps(out)))
    except BaseException:  # handed to the parent, which raises it, and raised here too
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, n_devices: int, device: Union[str, torch.device] = "cuda",
           init_file: Optional[str] = None, args: Sequence = ()) -> List[Any]:
    """Run ``fn(mesh, *args)`` on ``n_devices`` ranks, one process each
    (``torch.multiprocessing``, start method ``spawn``), joined by a
    ``file://`` store at ``init_file`` (default: a new temporary file; a
    file store needs no port, so runs side by side cannot collide).
    ``fn`` must be importable by name; ``args`` and the results are
    passed by ``torch.save``, tensors on the host.  Ranks on the CPU split
    this process's torch threads between them.  Returns each rank's
    result in rank order; if a rank fails, stops the others and raises
    with its traceback."""
    import torch.multiprocessing as mp

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"launch: {n_devices} ranks on {device}, but there is no CUDA device")
    backend = backend_for(n_devices, device)
    own_dir = None
    if init_file is None:
        own_dir = tempfile.mkdtemp(prefix="mesh-")
        init_file = os.path.join(own_dir, "store")
    if os.path.exists(init_file):
        raise FileExistsError(f"launch: the store file {init_file} exists already")
    print(f"parallel.mesh: {n_devices} ranks on {device.type}, backend {backend}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    payload = _dumps((fn, tuple(args)))
    threads = max(1, torch.get_num_threads() // n_devices)
    procs = [ctx.Process(target=_rank_main, args=(r, n_devices, backend, str(device), init_file,
                                                  threads, payload, results), daemon=False)
             for r in range(n_devices)]
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < n_devices:
            try:
                rank, ok, data = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before its result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{data}")
            out[rank] = _loads(data)
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        results.close()
        if own_dir is not None:
            shutil.rmtree(own_dir, ignore_errors=True)
    return [out[r] for r in range(n_devices)]
