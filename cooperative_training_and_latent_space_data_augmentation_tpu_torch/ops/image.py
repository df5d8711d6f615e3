"""Input construction for the STN (shape autoencoder) and the tensor and
image utilities.

Counterpart of the JAX package's ``ops/image.py`` (the re-design of
``medseg/common_utils/basic_operations.py`` and of helpers of
``model_util.py``): ``construct_input`` (the logits branch, a temperature
softmax; the label-map branch, one-hot with optional label smoothing; the
concatenation of the image), ``rescale_intensity``, ``z_score_intensity``,
``center_crop_or_pad`` (and its NHWC form), ``recover_image``,
``shuffle_tensor``, ``random_inpainting``, ``random_outpainting``,
``sharpen_predictions``, ``filter_unlabelled_predictions`` and
``unit_norm``.  ``construct_input`` takes NCHW like the port's modules;
the utilities keep the JAX package's layouts (batch first, channels last
where a channel axis matters), so a JAX array's numpy copy goes in as it
is.

Every random draw is an operand, as everywhere in the port, with a
``draw_*`` function beside it that makes it from a CPU
``torch.Generator``: label smoothing's strength
(:func:`draw_smooth_alpha`), the batch roll's shift
(:func:`draw_shuffle_shift`) and the in/outpainting's block boxes and
noise (:func:`draw_inpainting`, :func:`draw_outpainting`).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


def one_hot(labels: torch.Tensor, num_classes: int, dtype=torch.float32) -> torch.Tensor:
    """(N, *S) integer labels -> (N, num_classes, *S) one-hot in ``dtype``:
    the label-map branch of ``construct_input`` (and the loss library's)."""
    return F.one_hot(labels.long(), num_classes).to(dtype).movedim(-1, 1)


def draw_smooth_alpha(generator: torch.Generator) -> torch.Tensor:
    """Label smoothing's strength, ``U(0, 1) * 0.1`` as the JAX package
    draws it, a 0-d float32 tensor from a CPU ``generator``."""
    return torch.rand((), generator=generator) * 0.1


def construct_input(segmentation: torch.Tensor, temperature: float = 2.0,
                    num_classes: Optional[int] = None, image: Optional[torch.Tensor] = None,
                    apply_softmax: bool = True, is_labelmap: bool = False,
                    smooth_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The STN's input, NCHW.

    * logits (N, C, H, W): ``softmax(logits / temperature)`` over the class
      axis (or the logits as they are without ``apply_softmax``);
    * a label map (N, H, W) integer (``is_labelmap``): one-hot over
      ``num_classes``, smoothed toward uniform as ``(1 - a) y + a / C`` with
      ``smooth_alpha`` a (:func:`draw_smooth_alpha`) when given;
    * then ``image`` (N, C_img, H, W), if given, concatenated after the
      classes."""
    if apply_softmax and is_labelmap:
        raise ValueError("construct_input: a label map takes no softmax")
    if not is_labelmap:
        seg = torch.softmax(segmentation / temperature, dim=1) if apply_softmax else segmentation
    else:
        if num_classes is None:
            raise ValueError("construct_input: a label map needs num_classes")
        seg = one_hot(segmentation, num_classes)
        if smooth_alpha is not None:
            a = smooth_alpha.to(seg.device)
            seg = (1.0 - a) * seg + a / num_classes
    if image is not None:
        return torch.cat([seg, image.to(seg.dtype)], dim=1)
    return seg


def _per_sample(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N,) -> broadcastable against ``x`` (N, ...)."""
    return v.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def rescale_intensity(x: torch.Tensor, new_min: float = 0.0, new_max: float = 1.0,
                      eps: float = 1e-20) -> torch.Tensor:
    """Per-sample min-max rescale over all non-batch dims
    (basic_operations.rescale_intensity:242-254)."""
    flat = x.reshape(x.shape[0], -1)
    mn, mx = _per_sample(flat.amin(1), x), _per_sample(flat.amax(1), x)
    return (x - mn) / (mx - mn + eps) * (new_max - new_min) + new_min


def z_score_intensity(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Per-sample z-score normalization, population std
    (basic_operations:257-272)."""
    flat = x.reshape(x.shape[0], -1)
    mean = _per_sample(flat.mean(1), x)
    std = _per_sample(flat.std(1, correction=0), x)
    return (x - mean) / (std + eps)


def center_crop_or_pad(image: torch.Tensor, crop_hw: Tuple[int, int],
                       pad_value: float = 0.0) -> torch.Tensor:
    """Center crop or pad the last two axes (..., H, W) to ``crop_hw``
    (basic_operations.crop_or_pad:173-219): pad first, the odd pixel
    before, then crop from the centre."""
    h, w = image.shape[-2], image.shape[-1]
    new_h, new_w = crop_hw
    pad_h, pad_w = max(0, new_h - h), max(0, new_w - w)
    if pad_h or pad_w:
        image = F.pad(image, (pad_w // 2 + pad_w % 2, pad_w // 2,
                              pad_h // 2 + pad_h % 2, pad_h // 2), value=pad_value)
        h, w = image.shape[-2], image.shape[-1]
    h_s, w_s = (h - new_h) // 2, (w - new_w) // 2
    return image[..., h_s:h_s + new_h, w_s:w_s + new_w]


def center_crop_or_pad_nhwc(image: torch.Tensor, crop_hw: Tuple[int, int],
                            pad_value: float = 0.0, channel_last: bool = True
                            ) -> torch.Tensor:
    """Center crop or pad along H, W: axes -3, -2 of an NHWC or HWC input
    (``channel_last``), else the last two of an NHW or HW one."""
    if not channel_last:
        return center_crop_or_pad(image, crop_hw, pad_value)
    out = center_crop_or_pad(torch.movedim(image, -1, 0), crop_hw, pad_value)
    return torch.movedim(out, 0, -1)


def recover_image(image: torch.Tensor, h_s: int, w_s: int, origin_h: int,
                  origin_w: int) -> torch.Tensor:
    """Paste a cropped (N, H, W) image back at (h_s, w_s) of a zero canvas
    (N, origin_h, origin_w) (basic_operations.recover_image:161-170)."""
    n, h, w = image.shape
    canvas = image.new_zeros((n, origin_h, origin_w))
    canvas[:, h_s:h_s + h, w_s:w_s + w] = image
    return canvas


def draw_shuffle_shift(generator: torch.Generator, n: int) -> int:
    """The batch roll's shift, uniform in [1, n), from a CPU ``generator``."""
    return int(torch.randint(1, n, (), generator=generator))


def shuffle_tensor(x: torch.Tensor, shift: Union[int, torch.Tensor]) -> torch.Tensor:
    """Roll the batch by ``shift`` (basic_operations.shuffle_tensor:87-107)."""
    return torch.roll(x, int(shift), dims=0)


def _draw_boxes(generator: torch.Generator, n: int, hw: Tuple[int, int], n_blocks: int,
                min_frac: float, max_frac: float) -> torch.Tensor:
    """(n, n_blocks, 4) int64 boxes (height, width, top, left), each bound
    uniform in the JAX package's ranges: sides in [min_frac, max_frac) of
    the image's, corners 3 pixels from its top-left and max_frac + 3 from
    its bottom-right."""
    h, w = hw
    ranges = ((int(h * min_frac), max(int(h * max_frac), int(h * min_frac) + 1)),
              (int(w * min_frac), max(int(w * max_frac), int(w * min_frac) + 1)),
              (3, h - int(h * max_frac) - 3), (3, w - int(w * max_frac) - 3))
    boxes = torch.empty((n, n_blocks, 4), dtype=torch.int64)
    for i in range(n):
        for b in range(n_blocks):
            for k, (lo, hi) in enumerate(ranges):
                boxes[i, b, k] = torch.randint(lo, hi, (), generator=generator)
    return boxes


def draw_inpainting(generator: torch.Generator, shape, n_blocks: int = 5,
                    min_frac: float = 0.1, max_frac: float = 0.25, dtype=torch.float32):
    """(boxes, noise) of :func:`random_inpainting` for an NHWC ``shape``:
    the block boxes, then ``U(0, 1)`` noise of ``shape``."""
    boxes = _draw_boxes(generator, shape[0], tuple(shape[1:3]), n_blocks, min_frac,
                        max_frac)
    return boxes, torch.rand(tuple(shape), generator=generator, dtype=dtype)


def draw_outpainting(generator: torch.Generator, shape, n_blocks: int = 5,
                     min_frac: float = 0.25, max_frac: float = 0.4, dtype=torch.float32):
    """(boxes, noise) of :func:`random_outpainting`, as
    :func:`draw_inpainting` draws them with the outpainting's block sizes."""
    return draw_inpainting(generator, shape, n_blocks, min_frac, max_frac, dtype)


def block_mask(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(N, H, W) float32 union of each sample's boxes, {0, 1}."""
    h, w = hw
    ys = torch.arange(h, device=boxes.device).view(1, 1, h, 1)
    xs = torch.arange(w, device=boxes.device).view(1, 1, 1, w)
    bh, bw, y0, x0 = (boxes[..., k, None, None] for k in range(4))
    inside = (ys >= y0) & (ys < y0 + bh) & (xs >= x0) & (xs < x0 + bw)
    return inside.any(dim=1).to(torch.float32)


def random_inpainting(image: torch.Tensor, boxes: torch.Tensor,
                      noise: torch.Tensor) -> torch.Tensor:
    """Replace the boxes of each NHWC sample with ``noise``
    (basic_operations.random_inpainting:275-305); draws from
    :func:`draw_inpainting`."""
    masks = block_mask(boxes.to(image.device), tuple(image.shape[1:3]))[..., None]
    masks = masks.to(image.dtype)
    return image * (1 - masks) + noise.to(image.device) * masks


def random_outpainting(image: torch.Tensor, boxes: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    """Keep the boxes of each NHWC sample, ``noise`` everywhere else
    (basic_operations.random_outpainting:307-334); draws from
    :func:`draw_outpainting`."""
    masks = block_mask(boxes.to(image.device), tuple(image.shape[1:3]))[..., None]
    masks = masks.to(image.dtype)
    return image * masks + noise.to(image.device) * (1 - masks)


def sharpen_predictions(logits_or_probs: torch.Tensor, temperature: float = 0.5,
                        apply_softmax: bool = True) -> torch.Tensor:
    """MixMatch-style sharpening over the last (class) axis
    (model_util.py:361-368)."""
    p = torch.softmax(logits_or_probs, dim=-1) if apply_softmax else logits_or_probs
    cal = p ** (1.0 / temperature)
    return cal / cal.sum(dim=-1, keepdim=True)


def filter_unlabelled_predictions(probs: torch.Tensor, threshold: float = 0.8
                                  ) -> torch.Tensor:
    """1 where the largest class probability (last axis) exceeds
    ``threshold``, else 0, broadcast over the class axis, with no gradient
    (model_util.py:343-358; the JAX package's reading of its intent)."""
    probs = probs.detach()
    conf = (probs.amax(dim=-1, keepdim=True) > threshold).to(probs.dtype)
    return conf.expand_as(probs)


def unit_norm(x: torch.Tensor, use_p_norm: bool = False, eps: float = 1e-10) -> torch.Tensor:
    """Per-sample abs-max rescale, then optionally an l2 normalisation
    (model_util.py:396-411)."""
    x = x / (eps + _per_sample(x.reshape(x.shape[0], -1).abs().amax(1), x))
    if use_p_norm:
        norm = torch.sqrt((x.reshape(x.shape[0], -1) ** 2).sum(1))
        x = x / (eps + _per_sample(norm, x))
    return x
