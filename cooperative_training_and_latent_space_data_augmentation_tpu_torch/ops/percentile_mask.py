"""The percentile-threshold mask of targeted latent masking (kernel K3).

Counterpart of ``cooperative_training_and_latent_space_data_augmentation_tpu/
ops/pallas_kernels.py:fused_percentile_mask`` and of the sort-based
``ops/masking.py:_threshold_mask`` it replaces on the TPU.

:func:`percentile_mask` is the wrapper of K3 (``csrc/percentile_mask.cu``):
on a CUDA tensor it launches the kernel (or raises) and adds one to
``percentile_mask.launches``; on a CPU tensor it runs
:func:`percentile_mask_plain`, the JAX package's sort-based formulation in
plain PyTorch (the CPU tests' path and the reference the kernel is held
against on the card).  The soft values come in as an operand, as the TPU
kernel takes them, so both see the same random numbers.
"""

from __future__ import annotations

import ctypes

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels

MAX_D = 4096  # K3 stages one row of at most this many saliencies


def _threshold_index(p: torch.Tensor, d: int) -> torch.Tensor:
    """``clip(floor(f32(d) * p), 0, d - 1)`` as a 1-element int64 tensor on
    p's device (no host sync)."""
    return torch.floor(p.float().reshape(1) * d).clamp(0, d - 1).long()


def percentile_mask_plain(saliency: torch.Tensor, p: torch.Tensor,
                          soft_vals: torch.Tensor) -> torch.Tensor:
    """K3's function in plain PyTorch, the sort-based ``_threshold_mask``:
    the elements of each row strictly greater than the value at index
    ``clip(floor(D * p), 0, D - 1)`` of the row sorted in descending order
    take ``soft_vals``, the others 1.  (N, D) float32."""
    sal = saliency.float()
    idx = _threshold_index(p, sal.shape[1])
    thresh = torch.sort(sal, dim=1, descending=True).values.index_select(1, idx)
    return torch.where(sal > thresh, soft_vals.float(), torch.ones_like(sal))


def _check_args(saliency: torch.Tensor, p: torch.Tensor, soft_vals: torch.Tensor):
    if saliency.dim() != 2 or soft_vals.shape != saliency.shape or p.numel() != 1:
        raise ValueError(f"percentile_mask: needs saliency (N, D), soft_vals of the "
                         f"same shape and one p, got {tuple(saliency.shape)}, "
                         f"{tuple(soft_vals.shape)}, p of {p.numel()} elements")
    if not 1 <= saliency.shape[1] <= MAX_D or saliency.shape[0] < 1:
        raise ValueError(f"percentile_mask: needs N >= 1 and 1 <= D <= {MAX_D}, "
                         f"got {tuple(saliency.shape)}")
    for t in (saliency, p, soft_vals):
        if t.dtype != torch.float32:
            raise TypeError(f"percentile_mask: needs float32 tensors, got {t.dtype}")
        if t.device != saliency.device:
            raise ValueError(f"percentile_mask: tensors on {t.device} and "
                             f"{saliency.device}")


_SIGNATURES = {  # C function -> argtypes; pointers and the stream as c_void_p
    "percentile_mask": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def percentile_mask(saliency: torch.Tensor, p: torch.Tensor,
                    soft_vals: torch.Tensor) -> torch.Tensor:
    """Percentile-threshold mask over per-row saliency.

    saliency (N, D) float32, p a 1-element float32 tensor (the percentile,
    threshold index ``int(D * p)``), soft_vals (N, D) float32 (the values
    written at masked positions: ``0.5 * U(0, 1)`` for soft masks, zeros
    for hard ones) -> (N, D) float32 mask.

    On a CUDA tensor this launches K3 and adds one to
    ``percentile_mask.launches``; on a CPU tensor it runs the plain version.
    """
    _check_args(saliency, p, soft_vals)
    if saliency.device.type == "cpu":
        return percentile_mask_plain(saliency, p, soft_vals)
    if saliency.device.type != "cuda":
        raise ValueError(f"percentile_mask: no kernel for device {saliency.device}")
    sal, pc, soft = saliency.contiguous(), p.contiguous(), soft_vals.contiguous()
    n, d = sal.shape
    out = torch.empty_like(sal)
    kernels.launch("percentile_mask", "percentile_mask", _SIGNATURES["percentile_mask"],
                   f"saliency {tuple(sal.shape)}", sal, sal.data_ptr(), pc.data_ptr(),
                   soft.data_ptr(), out.data_ptr(), n, d)
    percentile_mask.launches += 1
    return out


percentile_mask.launches = 0
