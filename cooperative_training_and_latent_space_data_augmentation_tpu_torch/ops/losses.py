"""The segmentation loss library, NCHW (class axis 1).

Counterpart of the JAX package's ``ops/losses.py`` (the reference's
``custom_loss.py``), function by function, with the same arithmetic: the
cooperative step's ``cross_entropy_2d`` and the baselines' loss zoo behind
:func:`basic_loss_fn`.  Logits are (N, C, H, W) (or (N, C, D, H, W) for the
3-D losses); a target is either (N, H, W) integer labels or the (N, C, H, W)
logits of a soft reference (softmaxed inside), as there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.image import one_hot

Weights = Optional[Union[Sequence[float], torch.Tensor]]


def _spatial(x: torch.Tensor):
    return tuple(range(2, x.dim()))


def cross_entropy_2d(logits: torch.Tensor, target: torch.Tensor, weight: Weights = None,
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


def cross_entropy_3d(logits: torch.Tensor, target: torch.Tensor, weight: Weights = None,
                     size_average: bool = True) -> torch.Tensor:
    """NCDHW cross entropy (``custom_loss.cross_entropy_3D``): raw class
    weights (not normalised) on each voxel's term, the sum divided by the
    voxel count."""
    log_p = torch.log_softmax(logits, dim=1)
    nll = -log_p.gather(1, target.long().unsqueeze(1)).squeeze(1)
    if weight is not None:
        nll = nll * torch.as_tensor(weight, dtype=log_p.dtype, device=log_p.device)[target.long()]
    loss = nll.sum()
    return loss / target.numel() if size_average else loss


def soft_dice_loss(logits: torch.Tensor, target: torch.Tensor, num_classes: Optional[int] = None,
                   weight: Weights = None, smooth: float = 0.01, square_denom: bool = False,
                   target_is_soft_logits: bool = False) -> torch.Tensor:
    """Soft Dice over the softmax, ``1 - mean(2 (inter + smooth) / (union +
    smooth))`` per sample and class, reduced over every spatial axis.
    ``target``: integer labels, an (N, C, ...) one-hot or probability map,
    or (``target_is_soft_logits``) logits.  ``weight`` multiplies each
    class's Dice (an extension the reference's 'weighted dice' never uses;
    ``num_classes`` is accepted and unused, as there)."""
    c = logits.shape[1]
    probs = torch.softmax(logits, dim=1)
    if target.dim() == logits.dim() - 1:
        tgt = one_hot(target, c, probs.dtype)
    elif target_is_soft_logits:
        tgt = torch.softmax(target, dim=1)
    else:
        tgt = target
    axes = _spatial(logits)
    inter = (probs * tgt).sum(axes) + smooth
    if square_denom:
        denom = (probs * probs).sum(axes) + (tgt * tgt).sum(axes) + smooth
    else:
        denom = probs.sum(axes) + tgt.sum(axes) + smooth
    dice = 2.0 * inter / denom
    if weight is not None:
        dice = dice * torch.as_tensor(weight, dtype=dice.dtype, device=dice.device)
    return 1.0 - dice.mean()


def soft_dice_loss_3d(logits: torch.Tensor, target: torch.Tensor, weight: Weights = None,
                      smooth: float = 0.01) -> torch.Tensor:
    """3-D soft Dice on NCDHW logits: :func:`soft_dice_loss` at rank 5."""
    if logits.dim() != 5:
        raise ValueError(f"soft_dice_loss_3d: expects NCDHW logits, got {tuple(logits.shape)}")
    return soft_dice_loss(logits, target, weight=weight, smooth=smooth)


def selective_soft_dice_loss(logits: torch.Tensor, target: torch.Tensor,
                             class_ids: Sequence[int], smooth: float = 0.01) -> torch.Tensor:
    """Dice over ``class_ids`` only, ``1 - mean((2 inter + smooth) / (union
    + smooth))``; 'foreground dice' is class_ids 1..C-1."""
    c = logits.shape[1]
    probs = torch.softmax(logits, dim=1)
    tgt = one_hot(target, c, probs.dtype) if target.dim() == logits.dim() - 1 else target
    idx = torch.as_tensor(list(class_ids), device=logits.device)
    probs, tgt = probs.index_select(1, idx), tgt.index_select(1, idx)
    axes = _spatial(logits)
    inter = (probs * tgt).sum(axes)
    denom = probs.sum(axes) + tgt.sum(axes)
    return 1.0 - ((2.0 * inter + smooth) / (denom + smooth)).mean()


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
               alpha: Weights = None) -> torch.Tensor:
    """Focal loss ``-mean((1 - p_t)^gamma a_t log p_t)``."""
    log_p = torch.log_softmax(logits, dim=1)
    log_pt = log_p.gather(1, target.long().unsqueeze(1)).squeeze(1)
    w = (1.0 - torch.exp(log_pt)) ** gamma
    if alpha is not None:
        w = w * torch.as_tensor(alpha, dtype=log_p.dtype, device=log_p.device)[target.long()]
    return -(w * log_pt).mean()


def entropy_loss(logits: torch.Tensor, normalize: bool = False) -> torch.Tensor:
    """Mean per-pixel predictive entropy in nats (over log C with
    ``normalize``)."""
    ent = -(torch.softmax(logits, dim=1) * torch.log_softmax(logits, dim=1)).sum(1)
    out = ent.mean()
    return out / torch.log(torch.tensor(float(logits.shape[1]))) if normalize else out


def kl_divergence(p_logit: torch.Tensor, q_logit: torch.Tensor) -> torch.Tensor:
    """KL(softmax(p) || softmax(q)), summed over classes, mean over pixels."""
    log_p = torch.log_softmax(p_logit, dim=1)
    kl = torch.softmax(p_logit, dim=1) * (log_p - torch.log_softmax(q_logit, dim=1))
    return kl.sum(1).mean()


def brier_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Brier score: the squared error of the softmax against the one-hot,
    summed and divided by batch x classes."""
    n, c = logits.shape[:2]
    p = torch.softmax(logits, dim=1)
    return ((p - one_hot(target, c, p.dtype)) ** 2).sum() / (float(n) * float(c))


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                   beta: float = 1.0 / 9.0) -> torch.Tensor:
    """Huber / smooth-L1, mean (reference default beta 1/9)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta).mean()


def _pairwise_spatial_cosine(a: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    n, c = a.shape[:2]
    av, bv = a.reshape(n, c, -1), b.reshape(n, c, -1)
    return (av * bv).sum(-1) / (av.norm(dim=-1) * bv.norm(dim=-1) + eps)


def calc_angular_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean of 1 - cosine similarity per (sample, channel) spatial vector."""
    return (1.0 - _pairwise_spatial_cosine(a, b, eps)).mean()


def calc_correlation_loss(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Mean cosine similarity per (sample, channel) spatial vector (no
    absolute value, as in the reference)."""
    return _pairwise_spatial_cosine(a, b, eps).mean()


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """Channel Gram matrix, NCHW -> (N, C, C), over H W C."""
    n, c, h, w = x.shape
    f = x.reshape(n, c, h * w)
    return torch.einsum("ncp,ndp->ncd", f, f) / (h * w * c)


def style_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MSE between Gram matrices."""
    return ((gram_matrix(a) - gram_matrix(b)) ** 2).mean()


def _conv_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """3x3 SAME cross-correlation of NCHW ``x`` with an OIHW ``kernel``."""
    return F.conv2d(x, kernel.to(x.dtype), padding=1)


def contour_loss(probs: torch.Tensor, target: torch.Tensor, num_classes: int,
                 foreground_only: bool = True, one_hot_target: bool = True) -> torch.Tensor:
    """Sobel-gradient MSE between the class probabilities' and the
    target's summed (foreground) maps, halved: the reference's dense Sobel
    conv, computed on the class sum as the JAX package does.  ``probs``:
    NCHW probabilities; ``target``: integer labels (``one_hot_target``) or
    an NCHW map."""
    tgt = one_hot(target, num_classes, probs.dtype) if one_hot_target else target
    sobel_x = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]], device=probs.device)
    sobel_y = torch.tensor([[1., 2., 1.], [0., 0., 0.], [-1., -2., -1.]], device=probs.device)
    lo = 1 if foreground_only else 0
    p = probs[:, lo:num_classes].sum(1, keepdim=True)
    t = tgt[:, lo:num_classes].sum(1, keepdim=True)
    loss = 0.0
    for k in (sobel_x, sobel_y):
        k = k.view(1, 1, 3, 3)
        loss = loss + ((_conv_same(p, k) - _conv_same(t, k)) ** 2).mean()
    return 0.5 * loss


def calc_triplet_loss(anchor: torch.Tensor, positive: torch.Tensor, negative: torch.Tensor,
                      margin: float = 1.0) -> torch.Tensor:
    """Triplet margin loss on flattened embeddings."""
    n = anchor.shape[0]
    d_ap = (anchor - positive).reshape(n, -1).norm(dim=1)
    d_an = (anchor - negative).reshape(n, -1).norm(dim=1)
    return torch.clamp(d_ap - d_an + margin, min=0.0).mean()


def contrastive_loss(a: torch.Tensor, b: torch.Tensor, label: torch.Tensor, margin: float = 2.0,
                     eps: float = 1e-9) -> torch.Tensor:
    """Pairwise contrastive loss: label 1 pulls by the squared distance,
    label 0 pushes to ``margin``; half the mean."""
    d2 = ((b - a).reshape(a.shape[0], -1) ** 2).sum(1)
    push = torch.clamp(margin - torch.sqrt(d2 + eps), min=0.0) ** 2
    return (0.5 * (label * d2 + (1.0 - label) * push)).mean()


def nt_xent_loss(z1: torch.Tensor, z2: torch.Tensor, temperature: float = 0.5) -> torch.Tensor:
    """NT-Xent over two views of n samples."""
    n = z1.shape[0]
    z = torch.cat([z1.reshape(n, -1), z2.reshape(n, -1)], dim=0)
    z = z / (z.norm(dim=1, keepdim=True) + 1e-8)
    sim = z @ z.t() / temperature
    eye = torch.eye(2 * n, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    pos = torch.cat([torch.arange(n) + n, torch.arange(n)]).to(z.device)
    rows = torch.arange(2 * n, device=z.device)
    return (-sim[rows, pos] + torch.logsumexp(sim, dim=1)).mean()


def mse_segmentation_consistency(pred_logit: torch.Tensor, ref_logit: torch.Tensor) -> torch.Tensor:
    """Summed squared error of the softmaxed maps over N H W (the 'mse'
    branch of :func:`calc_segmentation_consistency`)."""
    return calc_segmentation_consistency(pred_logit, ref_logit, divergence_types=("mse",),
                                         divergence_weights=(1.0,))


def calc_segmentation_consistency(pred_logit: torch.Tensor, ref_logit: torch.Tensor,
                                  divergence_types=("kl", "contour"),
                                  divergence_weights=(1.0, 0.5), num_classes: int = 4,
                                  scales=(0,)) -> torch.Tensor:
    """Multi-scale multi-divergence consistency: at each scale s (2^s
    average pooling) the weighted divergences kl | ce | mse | Dice |
    contour, weighted by 2^s, averaged over the scales."""
    total = 0.0
    for scale in scales:
        p, r = pred_logit, ref_logit
        if scale > 0:
            k = 2 ** scale
            p, r = F.avg_pool2d(p, k), F.avg_pool2d(r, k)
        for name, w in zip(divergence_types, divergence_weights):
            if name == "kl":
                loss = kl_divergence(r, p)
            elif name == "ce":
                loss = cross_entropy_2d(p, r)
            elif name == "mse":
                n, _, h, wd = p.shape
                loss = ((torch.softmax(p, 1) - torch.softmax(r, 1)) ** 2).sum() / (n * h * wd)
            elif name == "Dice":
                loss = soft_dice_loss(p, r, target_is_soft_logits=True)
            elif name == "contour":
                sp, sr = torch.softmax(p, 1), torch.softmax(r, 1)
                loss = 0.0
                for i in range(1, num_classes):
                    loss = loss + contour_loss(sp[:, i:i + 1], sr[:, i:i + 1], num_classes=1,
                                               foreground_only=False, one_hot_target=False)
                loss = loss / max(num_classes - 1, 1)
            else:
                raise NotImplementedError(name)
            total = total + (2 ** scale) * w * loss
    return total / len(scales)


def hierarchical_loss(multi_preds: Sequence[torch.Tensor], target: torch.Tensor,
                      weights=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """3-level hierarchical cross entropy with the reference's remaps:
    level 1 sends classes > 1 to 0; level 2 sends classes <= 2 to 1 and 3
    to 2; level 3 is the full labels with class weights (0.2, 0.25, 0.3,
    0.25)."""
    if len(multi_preds) != len(weights):
        raise ValueError(f"{len(multi_preds)} predictions, {len(weights)} weights")
    binary = torch.where(target > 1, torch.zeros_like(target), target)
    biv = torch.where(target <= 2, torch.ones_like(target), torch.full_like(target, 2))
    return (weights[0] * cross_entropy_2d(multi_preds[0], binary)
            + weights[1] * cross_entropy_2d(multi_preds[1], biv)
            + weights[2] * cross_entropy_2d(multi_preds[2], target,
                                            weight=[0.2, 0.25, 0.3, 0.25]))


def intra_subject_latent_consistency_loss(latents: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean squared spread of k views' latents around their mean."""
    n = latents[0].shape[0]
    stack = torch.stack([z.reshape(n, -1) for z in latents], dim=0)
    bias = stack - stack.mean(0, keepdim=True)
    return (bias * bias).mean()


def inter_template_consistency_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Mean squared spread of per-sample templates around the batch mean."""
    bias = x - x.mean(0, keepdim=True)
    return weight * (bias * bias).mean()


def laplacian_smoothness_loss(probs: torch.Tensor, target: torch.Tensor, num_classes: int,
                              size_average: bool = True) -> torch.Tensor:
    """MSE between the Laplacian responses of the foreground probabilities
    and one-hot labels: the reference's dense (fg x fg) conv with the
    kernel [[1, 0, 1], [1, -8, 1], [1, 0, 1]] in every tap."""
    fg = num_classes - 1
    tgt = one_hot(target, num_classes, probs.dtype)[:, 1:]
    k = torch.tensor([[1., 0., 1.], [1., -8., 1.], [1., 0., 1.]], device=probs.device)
    kernel = k.view(1, 1, 3, 3).expand(fg, fg, 3, 3)
    diff = _conv_same(probs[:, 1:], kernel) - _conv_same(tgt, kernel)
    loss = diff * diff
    return loss.mean() if size_average else loss


def zncc_loss(template: torch.Tensor, image: torch.Tensor, zero_mean: bool = False,
              eps: float = 1e-6) -> torch.Tensor:
    """Mean over the batch of 1 - (zero-)normalised cross-correlation of the
    (1, C, H, W) ``template`` against each (N, C, H, W) ``image``."""
    if zero_mean:
        template = template - template.mean((2, 3), keepdim=True)
        image = image - image.mean((2, 3), keepdim=True)
    n = image.shape[0]
    t = template.expand_as(image).reshape(n, -1)
    im = image.reshape(n, -1)
    t = t / (t.norm(dim=1, keepdim=True) + eps)
    im = im / (im.norm(dim=1, keepdim=True) + eps)
    return (1.0 - (t * im).sum(1)).mean()


LOSS_TYPES = ("cross entropy", "weighted cross entropy", "dice", "weighted dice",
              "foreground dice", "focal", "contour_smooth")


def basic_loss_fn(pred: torch.Tensor, target: torch.Tensor, loss_type: str = "cross entropy",
                  class_weights: Weights = None) -> torch.Tensor:
    """The supervised-loss dispatcher (``custom_loss.basic_loss_fn``) over
    :data:`LOSS_TYPES`.  'weighted cross entropy' weights each class
    1/num_classes unless ``class_weights`` are given; 'weighted dice' trains
    exactly like 'dice' (the reference's Dice accepts a weight and never
    uses it)."""
    num_classes = pred.shape[1]
    if class_weights is None:
        class_weights = [1.0 / num_classes] * num_classes
    if loss_type == "cross entropy":
        return cross_entropy_2d(pred, target)
    if loss_type == "weighted cross entropy":
        return cross_entropy_2d(pred, target, weight=class_weights)
    if loss_type in ("dice", "weighted dice"):
        return soft_dice_loss(pred, target)
    if loss_type == "foreground dice":
        return selective_soft_dice_loss(pred, target, list(range(1, num_classes)))
    if loss_type == "focal":
        return focal_loss(pred, target, gamma=2.0)
    if loss_type == "contour_smooth":
        return contour_loss(torch.softmax(pred, 1), target, num_classes)
    raise NotImplementedError(loss_type)
