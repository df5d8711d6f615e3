"""Host-side (numpy/scipy) helper transforms.

A copy of the JAX package's ``data/host_transforms.py`` (the port imports
nothing of the JAX package): the reference's standalone transform helpers
in ``medseg/dataset_loader/_utils/affine_transform.py`` that sit outside
the device-side training pipeline (``ops/augment.py`` covers that); they
serve offline tooling, notebooks and test-time glue.

  * ``crop_pad`` / ``reverse_crop_pad``  <- CropPad/ReverseCropPad
    (affine_transform.py:561-757): center crop-or-zero-pad to a target H x W
    and the inverse restore to the original H x W, with the reference's exact
    mixed-axis (crop one axis, pad the other) offset arithmetic.
  * ``my_resize``  <- MyResize (:459-492): skimage-convention resize
    (order-3 spline for 'bilinear', order-0 for labels, symmetric boundary).
  * ``my_rotate``  <- MyRotate (:371-457): center rotation (bilinear or
    nearest) padded to an output size, with the optional
    ``largest_rotated_rect`` crop-then-resize that removes border artifacts.
  * ``largest_rotated_rect``  <- (:525-558).

All functions take/return plain numpy arrays (HW, or HWC/CHW where noted).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage


def _crop_pad_2d(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """Center crop-or-pad one HW array (CropPad.__call__ 2-D arm)."""
    x, y = img.shape
    x_s = (x - th) // 2
    y_s = (y - tw) // 2
    x_c = (th - x) // 2
    y_c = (tw - y) // 2
    if x > th and y > tw:
        return img[x_s:x_s + th, y_s:y_s + tw]
    out = np.zeros((th, tw), dtype=img.dtype)
    if x <= th and y > tw:
        out[x_c:x_c + x, :] = img[:, y_s:y_s + tw]
    elif x > th and y <= tw:
        out[:, y_c:y_c + y] = img[x_s:x_s + th, :]
    else:
        out[x_c:x_c + x, y_c:y_c + y] = img
    return out


def crop_pad(img: np.ndarray, h: int, w: int, chw: bool = False) -> np.ndarray:
    """Center crop (if larger) or zero-pad (if smaller) to (h, w)
    (affine_transform.CropPad:561-630).  2-D HW, or 3-D HWC (default) /
    CHW (``chw=True``)."""
    if img.ndim == 2:
        return _crop_pad_2d(img, h, w)
    if img.ndim == 3:
        if chw:
            return np.stack([_crop_pad_2d(img[c], h, w)
                             for c in range(img.shape[0])], axis=0)
        return np.stack([_crop_pad_2d(img[..., c], h, w)
                         for c in range(img.shape[-1])], axis=-1)
    raise ValueError(f"crop_pad expects 2-D/3-D input, got shape {img.shape}")


def _reverse_crop_pad_2d(sl: np.ndarray, h: int, w: int) -> np.ndarray:
    """Restore one cropped HW slice to the original (h, w)
    (ReverseCropPad.__call__ 2-D arm: re-center, zero background)."""
    th, tw = sl.shape
    x_s = (h - th) // 2
    y_s = (w - tw) // 2
    x_c = (th - h) // 2
    y_c = (tw - w) // 2
    if h > th and w > tw:
        out = np.zeros((h, w), dtype=sl.dtype)
        out[x_s:x_s + th, y_s:y_s + tw] = sl
        return out
    if h <= th and w > tw:
        out = np.zeros((h, w), dtype=sl.dtype)
        out[:, y_s:y_s + tw] = sl[x_c:x_c + h, :]
        return out
    if h > th and w <= tw:
        out = np.zeros((h, w), dtype=sl.dtype)
        out[x_s:x_s + th, :] = sl[:, y_c:y_c + w]
        return out
    return sl[x_c:x_c + h, y_c:y_c + w]


def reverse_crop_pad(slices_cropped: np.ndarray, h: int, w: int) -> np.ndarray:
    """Inverse of :func:`crop_pad`: restore to the ORIGINAL (h, w)
    (affine_transform.ReverseCropPad:634-757).  Accepts HW, NHW, or NCHW."""
    if slices_cropped.ndim == 2:
        return _reverse_crop_pad_2d(slices_cropped, h, w)
    if slices_cropped.ndim == 3:
        return np.stack([_reverse_crop_pad_2d(s, h, w) for s in slices_cropped],
                        axis=0)
    if slices_cropped.ndim == 4:
        return np.stack([
            np.stack([_reverse_crop_pad_2d(c, h, w) for c in s], axis=0)
            for s in slices_cropped], axis=0)
    raise ValueError(
        f"reverse_crop_pad expects 2-4-D input, got shape {slices_cropped.shape}")


def my_resize(x: np.ndarray, size: Tuple[int, int],
              interp: str = "bilinear") -> np.ndarray:
    """Resize one HW array to ``size`` with skimage's coordinate convention
    (MyResize:459-492: order-3 spline for 'bilinear', order 0 otherwise,
    symmetric boundary, preserve_range).  Implemented on
    scipy.ndimage.map_coordinates (mode='reflect' == skimage 'symmetric')."""
    order = 3 if interp == "bilinear" else 0
    in_h, in_w = x.shape
    out_h, out_w = int(size[0]), int(size[1])
    # skimage resize samples input at (out_idx + 0.5) * scale - 0.5
    rows = (np.arange(out_h) + 0.5) * (in_h / out_h) - 0.5
    cols = (np.arange(out_w) + 0.5) * (in_w / out_w) - 0.5
    grid = np.meshgrid(rows, cols, indexing="ij")
    out = ndimage.map_coordinates(x.astype(np.float64), grid, order=order,
                                  mode="reflect")
    # skimage resize(clip=True): bound the spline overshoot to the input range
    out = np.clip(out, float(x.min()), float(x.max()))
    return out.astype(x.dtype if np.issubdtype(x.dtype, np.floating)
                      else np.float64)


def largest_rotated_rect(w: float, h: float, angle: float
                         ) -> Tuple[float, float]:
    """(width, height) of the largest axis-aligned rectangle inside a
    w x h rectangle rotated by ``angle`` radians
    (affine_transform.largest_rotated_rect:525-558)."""
    quadrant = int(math.floor(angle / (math.pi / 2))) & 3
    sign_alpha = angle if (quadrant & 1) == 0 else math.pi - angle
    alpha = (sign_alpha % math.pi + math.pi) % math.pi
    bb_w = w * math.cos(alpha) + h * math.sin(alpha)
    bb_h = w * math.sin(alpha) + h * math.cos(alpha)
    gamma = math.atan2(bb_w, bb_w)  # reference quirk: both branches identical
    delta = math.pi - alpha - gamma
    length = h if w < h else w
    d = length * math.cos(alpha)
    a = d * math.sin(alpha) / math.sin(delta)
    y = a * math.cos(gamma)
    x = y * math.tan(gamma)
    return bb_w - 2 * x, bb_h - 2 * y


def _rotate_2d(x: np.ndarray, theta: float, order: int) -> np.ndarray:
    """Rotate one HW array by ``theta`` radians about its center
    (torchsample th_affine2d(center=True) semantics: output pixel o samples
    input at R @ (o - c) + c)."""
    h, w = x.shape
    c = np.array([(h - 1) / 2.0, (w - 1) / 2.0])
    rot = np.array([[math.cos(theta), -math.sin(theta)],
                    [math.sin(theta), math.cos(theta)]])
    offset = c - rot @ c
    return ndimage.affine_transform(x.astype(np.float64), rot, offset=offset,
                                    order=order, mode="constant", cval=0.0)


def _pad_center(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """Zero-pad to at least (h, w), centered (MyPad: ceil/floor split)."""
    dh = max(h - x.shape[0], 0)
    dw = max(w - x.shape[1], 0)
    return np.pad(x, ((int(np.ceil(dh / 2)), dh // 2),
                      (int(np.ceil(dw / 2)), dw // 2)), mode="constant")


def my_rotate(x: np.ndarray, degrees: float, output_size: Tuple[int, int],
              interp: str = "bilinear", crop: bool = False) -> np.ndarray:
    """Rotate one HW array about its center and pad to ``output_size``
    (MyRotate:371-457).  ``crop=True`` removes the black rotation borders:
    center-crop to the largest inscribed rectangle (square side = min(w, h))
    then resize back to ``output_size``."""
    theta = math.radians(degrees)
    order = 1 if interp == "bilinear" else 0
    if theta == 0.0:
        return _pad_center(x, output_size[0], output_size[1])
    rotated = _rotate_2d(x, theta, order)
    if crop:
        new_w, new_h = largest_rotated_rect(x.shape[0], x.shape[1], theta)
        edge = max(int(min(new_w, new_h)), 1)
        cropped = _crop_pad_2d(rotated, edge, edge)
        return my_resize(cropped, output_size, interp=interp)
    return _pad_center(rotated, output_size[0], output_size[1])
