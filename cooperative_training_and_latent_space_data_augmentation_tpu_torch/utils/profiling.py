"""Tracing and profiling utilities, and the card's data-sheet peaks.

Counterpart of the JAX package's ``utils/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler`` that writes a
  trace directory TensorBoard's profiler plugin loads;
* :func:`time_fn`: the first call's seconds and the steady-state seconds a
  call, each ending in a ``torch.cuda.synchronize`` when the call returns
  CUDA tensors (PyTorch returns before the card finishes);
* :func:`serialize_scan` and :func:`fused_scan_marginal`: K iterations of an
  op chained by a scalar dependency and read back once, and the marginal
  seconds an iteration from a small and a large K;
* :func:`cost_summary`: the operations and bytes of a call, with ratios to
  the card's peaks when a measured time is given;
* :func:`device_time` and :func:`_group`: the device time of a profiler
  trace by kernel row, as ``profile_predict.py``, ``profile_train.py`` and
  ``chip_smoke.py`` read it;
* :data:`HBM_BYTES_PER_S`, :data:`PEAK_FLOPS` and :func:`bound`: the one
  home of the H100's data-sheet rates and of the least time they allow.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, Optional

import torch
from torch.autograd import DeviceType
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # f32 off the tensor cores


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _tensors(obj) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(obj) if isinstance(t, torch.Tensor))


def _sync(out) -> None:
    """Wait for the card when ``out`` holds a CUDA tensor."""
    if any(t.is_cuda for t in _tensors(out)):
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region, ``with trace('/tmp/tb'): step(...)``, into
    ``log_dir`` (one ``*.pt.trace.json`` a run, which TensorBoard's profiler
    plugin and Perfetto load).  The card's activity is traced when there is
    one; the region ends in a synchronize so its kernels are inside."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 10,
            **kwargs) -> Dict[str, float]:
    """Time ``fn(*args, **kwargs)``: ``compile_s``, the first call (on the
    card it builds the kernels and picks cuDNN's algorithms), and
    ``steady_s``, seconds a call over ``iters`` calls after ``warmup`` in
    all, each span ending in a synchronize on CUDA outputs."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync(out)
    compile_s = time.perf_counter() - t0
    for _ in range(max(0, warmup - 1)):
        out = fn(*args, **kwargs)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _sync(out)
    return {"compile_s": compile_s, "steady_s": (time.perf_counter() - t0) / iters}


def serialize_scan(op: Callable[[torch.Tensor], Any], K: int,
                   device: str = "cpu") -> Callable[[], torch.Tensor]:
    """A zero-argument function applying ``op`` K times in a chain.

    ``op`` maps a 0-d float32 perturbation to a tensor (typically ``lambda
    c: f(x + c.to(x.dtype))``); each iteration's input depends on the mean
    of the previous output, so no call can be skipped or overlapped with
    the next.  The result is the last 0-d tensor on ``device``'s side;
    :func:`fused_scan_marginal` reads it back once."""
    def run() -> torch.Tensor:
        c = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(K):
            c = op(c).float().mean() * 1e-12
        return c

    return run


def fused_scan_marginal(make_scalar_fn: Callable[[int], Callable[[], Any]],
                        k_small: int = 10, k_large: int = 40, reps: int = 3) -> float:
    """Marginal seconds an iteration: ``make_scalar_fn(K)()`` (a
    zero-argument function returning a 0-d tensor, such as
    :func:`serialize_scan`'s) is read back with ``float`` once a run, the
    best of ``reps`` runs is kept for K = ``k_small`` and ``k_large``, and
    the difference over the difference of K is returned: the launch and
    read-back latency and one-time stalls cancel."""
    times = {}
    for K in (k_small, k_large):
        f = make_scalar_fn(K)
        float(f())  # first call: kernel builds, cuDNN's choices
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            float(f())
            best = min(best, time.perf_counter() - t0)
        times[K] = best
    return (times[k_large] - times[k_small]) / (k_large - k_small)


class _ByteCounter(TorchDispatchMode):
    """Bytes of every tensor an aten op reads (its tensor arguments) and
    writes (its tensor results), summed over the ops of a region; views
    (an op whose result aliases its input) move nothing and are left out."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(r.alias_info is not None for r in func._schema.returns):
            return out
        self.nbytes += sum(t.nbytes for t in _tensors((args, kwargs or {})))
        self.nbytes += sum(t.nbytes for t in _tensors(out))
        return out


def cost_summary(fn: Callable, *args, peak_flops: float = PEAK_FLOPS["bfloat16"],
                 peak_bytes: float = HBM_BYTES_PER_S,
                 measured_s: Optional[float] = None) -> Dict[str, float]:
    """The operations and bytes of ``fn(*args)``, run once on the CPU.

    ``torch.utils.flop_counter.FlopCounterMode`` counts the aten ops it
    sees; the port's kernels are ctypes calls it cannot see, so the call
    must be a CPU twin of the card's call (its tensors, and the modules it
    closes over, on the CPU), where every kernel wrapper runs its plain
    PyTorch version: K1's matmul of the tap matrix counts the conv's
    ``2 N H W C_in C_out 9`` operations.  A CUDA argument is refused.

    Returns ``flops``, ``bytes_accessed`` (every counted op's tensor
    arguments read once and its results written once: an upper bound of
    the traffic, since a fused kernel keeps its intermediates on chip) and
    ``argument_bytes``; with ``measured_s``, the card's time of the call,
    also ``achieved_flops_per_s`` and the shares of the card's data-sheet
    peaks, ``flops_utilization_upper_bound`` (of ``peak_flops``, bf16's by
    default) and ``hbm_utilization_upper_bound`` (of ``peak_bytes``)."""
    from torch.utils.flop_counter import FlopCounterMode

    if any(t.is_cuda for t in _tensors(args)):
        raise ValueError("cost_summary: pass the call's CPU twin; the card's kernels are "
                         "invisible to the flop counter")
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args)
    out = {"flops": float(flops.get_total_flops()), "bytes_accessed": float(counter.nbytes),
           "argument_bytes": float(sum(t.nbytes for t in _tensors(args)))}
    if measured_s:
        out["achieved_flops_per_s"] = out["flops"] / measured_s
        out["flops_utilization_upper_bound"] = out["achieved_flops_per_s"] / peak_flops
        out["hbm_utilization_upper_bound"] = out["bytes_accessed"] / measured_s / peak_bytes
    return out


# ---------------------------------------------------------- profiler traces
NCCL_GROUP = "NCCL collectives"


def _group(name: str) -> str:
    """The row of a kernel name in the device-time tables: the port's
    kernels by their ``csrc`` names, NCCL's collectives, cuDNN and cuBLAS,
    copies, the rest."""
    low = name.lower()
    if "nccl" in low:
        return NCCL_GROUP
    if "conv3x3_nl_dw" in name:
        return "K5dw conv3x3_nl_dw"
    if "conv3x3_nl" in name:
        return "K5 conv3x3_nl (forward and dx)"
    if "conv3x3_b8_dw" in name:
        return "K6dw conv3x3_b8_dw"
    if "conv3x3_b8" in name:
        return "K6 conv3x3_b8 (forward and dx)"
    if "conv3x3s2_dw" in name:
        return "K4dw conv3x3s2_dw"
    if "conv3x3s2_dx" in name:
        return "K4dx conv3x3s2_dx"
    if "conv3x3s2" in name:
        return "K4 conv3x3s2"
    if any(k in name for k in ("conv3x3_chw_kernel", "conv3x3_chw_mma_kernel")):
        return "K1 conv3x3_chw (forward and dx)"
    if any(k in name for k in ("dw_partial_kernel", "dw_mma_partial_kernel",
                               "dw_reduce_kernel")):
        return "K2 conv3x3_chw_dw"
    if "percentile_mask_kernel" in name:
        return "K3 percentile_mask"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("cudnn", "conv", "xmma", "implicit", "sm90_")):
        return "cuDNN/cuBLAS convs and matmuls"
    return "other kernels (elementwise, BN, casts, upsample)"


def device_time(events):
    """Device time of a trace's ``key_averages()`` entries, in microseconds:
    ``(by_group, ranges, kernels)``.  Only device-side entries count (a CPU
    op's entry repeats its kernels' time).  A ``record_function`` range
    (``is_user_annotation``) also shows on the device's timeline, as a span
    over kernels counted on their own, idle gaps included: ranges are
    summed apart into ``ranges`` and left out of ``by_group``, so that
    busy, ``sum(by_group.values())``, counts each kernel once.  ``kernels``
    lists (device time, launches, name) of every kernel and copy.  The
    attribute is read directly, so a torch without it raises."""
    by_group = defaultdict(float)
    kernels = []
    ranges = 0.0
    for evt in events:
        annotation = evt.is_user_annotation
        if evt.device_type != DeviceType.CUDA:
            continue
        if annotation:
            ranges += evt.self_device_time_total
            continue
        by_group[_group(evt.key)] += evt.self_device_time_total
        kernels.append((evt.self_device_time_total, evt.count, evt.key))
    return by_group, ranges, kernels
