"""Latent-space masking: the hard-example generation ops.

Counterpart of the JAX package's ``ops/masking.py`` (itself a re-design of
the reference's ``model_util.py:180-318`` and ``perturb_latent_code``):

* :func:`dropout_mask`: random channel dropout with survivors scaled by
  1 / (1 - p);
* :func:`mask_latent_code_channel_wise` and
  :func:`mask_latent_code_spatial_wise`: targeted masking, with the
  saliency the gradient of a task loss through a frozen decoder with
  respect to the code (``torch.autograd.grad``), thresholded by
  :func:`..ops.percentile_mask.percentile_mask` (kernel K3 on the card);
* :func:`perturb_latent_code`: the dispatcher.

Draws are operands, not keys: the branch, the dropout keep mask, the
percentile p and the soft values come in a :class:`..train.draws.CodeDraws`
(``soft`` is zeros for hard masks).  Codes are NCHW (N, C, h, w): channel
saliency is the gradient's mean over (h, w), (N, C); spatial saliency its
mean over C flattened in (h, w) order, (N, h*w), as in the JAX package's
NHWC layout.  Masks are (N, C, 1, 1) and (N, 1, h, w) before the
dispatcher broadcasts them to the code's shape.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import MaskConfig
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import full_f32
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.image import one_hot
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.losses import (
    cross_entropy_2d,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.percentile_mask import (
    percentile_mask,
)

BRANCHES = ("dropout", "spatial", "channel")  # index = the JAX package's branch id


def task_loss(decoder_fn: Callable, code: torch.Tensor, target: torch.Tensor,
              loss_name: str, num_classes: int) -> torch.Tensor:
    """Task loss whose code gradient drives targeted masking: ``mse`` or
    ``corr`` against an NCHW image (or one-hot labels), ``ce`` against
    (N, H, W) labels."""
    out = decoder_fn(code)
    if loss_name == "ce":
        return cross_entropy_2d(out, target)
    gt = target if target.dim() == out.dim() else one_hot(target, num_classes).to(out.dtype)
    if loss_name == "corr":
        return torch.mean(out * gt)
    if loss_name == "mse":
        return torch.mean((out - gt) ** 2)
    raise NotImplementedError(loss_name)


def _code_grad(code: torch.Tensor, decoder_fn: Callable, target: torch.Tensor,
               loss_name: str, num_classes: int) -> torch.Tensor:
    z = code.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = task_loss(decoder_fn, z, target, loss_name, num_classes)
        with full_f32(torch.float32):  # the backward of the f32 cuDNN convs, too
            (grad,) = torch.autograd.grad(loss, z)
    return grad


def mask_latent_code_channel_wise(code: torch.Tensor, decoder_fn: Callable,
                                  target: torch.Tensor, p: torch.Tensor,
                                  soft_vals: torch.Tensor, loss_name: str = "corr",
                                  num_classes: int = 2):
    """Targeted channel masking: the channels whose mean code gradient lies
    above the top-p percentile value take ``soft_vals`` (N, C), the others
    keep 1.  Returns (masked_code, mask (N, C, 1, 1), saliency (N, C))."""
    code = code.detach()
    grad = _code_grad(code, decoder_fn, target, loss_name, num_classes)
    n, c = code.shape[:2]
    saliency = grad.mean((2, 3))
    mask = percentile_mask(saliency, p, soft_vals).to(code.dtype).reshape(n, c, 1, 1)
    return code * mask, mask, saliency


def mask_latent_code_spatial_wise(code: torch.Tensor, decoder_fn: Callable,
                                  target: torch.Tensor, p: torch.Tensor,
                                  soft_vals: torch.Tensor, loss_name: str = "corr",
                                  num_classes: int = 2):
    """Targeted spatial masking: saliency is the code gradient's channel
    mean, (N, h*w) in (h, w) order; locations above the top-p percentile
    value take ``soft_vals`` (N, h*w).  Returns (masked_code, mask (N, 1,
    h, w), saliency (N, h*w))."""
    code = code.detach()
    grad = _code_grad(code, decoder_fn, target, loss_name, num_classes)
    n, _, h, w = code.shape
    saliency = grad.mean(1).reshape(n, h * w)
    mask = percentile_mask(saliency, p, soft_vals).to(code.dtype).reshape(n, 1, h, w)
    return code * mask, mask, saliency


def dropout_mask(code: torch.Tensor, keep: torch.Tensor, p: float = 0.5):
    """Random channel dropout (torch dropout2d semantics) with the keep
    mask ``keep`` (N, C) of 0s and 1s drawn with probability 1 - p:
    survivors are scaled by 1 / (1 - p).  Returns (masked_code, keep mask
    broadcast over (h, w))."""
    n, c = code.shape[:2]
    keep = keep.to(code.dtype).reshape(n, c, 1, 1)
    scale = 1.0 / (1.0 - p) if p < 1.0 else 0.0
    return code * keep * scale, keep.expand_as(code)


def perturb_latent_code(code: torch.Tensor, decoder_fn: Callable, target: torch.Tensor,
                        settings: MaskConfig, draws, num_classes: int = 4
                        ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Latent-code perturbation with the branch ``draws.branch`` (0
    dropout, 1 spatial, 2 channel; under ``mask_type="random"`` the draw
    picks it, else it must be the configured one).

    ``decoder_fn`` must run the decoder with detached parameters and frozen
    BN statistics.  Returns (masked_code, mask broadcast to the code's
    shape, saliency or None for dropout), detached."""
    branch = draws.branch
    if settings.mask_type != "random" and BRANCHES[branch] != settings.mask_type:
        raise ValueError(f"perturb_latent_code: branch {BRANCHES[branch]!r} drawn for "
                         f"mask_type {settings.mask_type!r}")
    saliency = None
    if branch == 0:
        masked, mask = dropout_mask(code.detach(), draws.keep, settings.max_threshold)
    else:
        fn = mask_latent_code_spatial_wise if branch == 1 else mask_latent_code_channel_wise
        masked, mask, saliency = fn(code, decoder_fn, target, draws.p, draws.soft,
                                    settings.loss_name, num_classes)
        mask = mask.expand_as(code)
    return masked.detach(), mask.detach(), saliency
