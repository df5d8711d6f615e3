"""Input construction for the STN (shape autoencoder).

Counterpart of the JAX package's ``ops/image.py:construct_input``: the
logits branch (temperature softmax), the label-map branch (one-hot, with
optional label smoothing) and the concatenation of the image.  Label
smoothing's random strength is an operand (:func:`draw_smooth_alpha`), as
every draw of the port is.
"""

from __future__ import annotations

from typing import Optional

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
