"""Model introspection: parameter counts, memory size of a call, and
intermediate features.

Counterpart of the JAX package's ``utils/estimate.py``, its functional
answers to the reference's ``SizeEstimator`` and
``HookBasedFeatureExtractor`` (``medseg/models/model_util.py:454-530,
674-727``):

* :func:`count_params` and :func:`param_bytes` of a module (its
  parameters) or of a state dict (every tensor in it, buffers included;
  nested ``{module: state_dict}`` mappings too);
* :func:`estimate_size`: on the card, the caching allocator's peak around
  one call; on the CPU, the JAX package's own answer for a backend without
  memory analysis, the argument bytes and NaN for the rest;
* :func:`extract_features`: forward hooks on the named submodules, the
  reference's ``HookBasedFeatureExtractor`` (flax's
  ``capture_intermediates`` in the JAX package).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn
from torch.utils._pytree import tree_leaves

MB = 2 ** 20


def _leaves(obj: Union[nn.Module, Mapping]) -> Iterable[torch.Tensor]:
    if isinstance(obj, nn.Module):
        return list(obj.parameters())
    out = []
    for v in obj.values():
        if isinstance(v, Mapping):
            out.extend(_leaves(v))
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


def count_params(obj: Union[nn.Module, Mapping]) -> int:
    """Elements of a module's parameters, or of every tensor of a state
    dict."""
    return sum(t.numel() for t in _leaves(obj))


def param_bytes(obj: Union[nn.Module, Mapping]) -> int:
    """Bytes of a module's parameters, or of every tensor of a state dict."""
    return sum(t.numel() * t.element_size() for t in _leaves(obj))


def _nbytes(obj) -> int:
    return sum(t.nbytes for t in tree_leaves(obj) if isinstance(t, torch.Tensor))


def estimate_size(fn: Callable, *example_args) -> Dict[str, float]:
    """The memory of one call ``fn(*example_args)``, in MiB.

    ``params_mb`` is the arguments' bytes (the JAX package's
    ``argument_size_in_bytes``; state a call closes over, such as a
    module's parameters, is not an argument).  On the card (a CUDA
    argument) the call runs once between two synchronizes with the
    allocator's peak reset before it: ``total_mb`` is the arguments plus
    the most the call held above what was allocated when it started,
    ``output_mb`` its outputs' bytes and ``temp_mb`` the rest, the peak less
    the argument and output bytes.  On the CPU nothing is measured: the
    argument bytes and NaN for the other three, as the JAX package returns
    on a backend without memory analysis.  Nothing falls back to the CPU:
    the CPU answer is for CPU arguments."""
    arg_bytes = _nbytes(example_args)
    on_card = any(t.is_cuda for t in tree_leaves(example_args) if isinstance(t, torch.Tensor))
    if not on_card:
        nan = float("nan")
        return {"params_mb": arg_bytes / MB, "output_mb": nan, "temp_mb": nan,
                "total_mb": nan}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn(*example_args)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - before
    out_bytes = _nbytes(out)
    total = arg_bytes + held
    return {"params_mb": arg_bytes / MB, "output_mb": out_bytes / MB,
            "temp_mb": (total - arg_bytes - out_bytes) / MB, "total_mb": total / MB}


def extract_features(module: nn.Module, x: Any, layer_filter: Optional[str] = None
                     ) -> Tuple[Any, Dict[str, Any]]:
    """Run ``module(x)`` with a forward hook on every named submodule whose
    qualified name holds ``layer_filter`` (all of them for None), in the
    module's own mode: returns ``(output, {qualified_name: activation})``
    in the order the submodules finished.  A submodule called more than
    once keeps its last activation; the hooks are removed afterwards."""
    features: Dict[str, Any] = {}
    handles = []
    for name, sub in module.named_modules():
        if not name or (layer_filter is not None and layer_filter not in name):
            continue
        handles.append(sub.register_forward_hook(
            lambda m, args, out, name=name: features.__setitem__(name, out)))
    try:
        out = module(x)
    finally:
        for h in handles:
            h.remove()
    return out, features

