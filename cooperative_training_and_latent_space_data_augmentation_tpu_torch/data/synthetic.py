"""Synthetic cardiac-like phantoms, made from a seed with numpy.

A copy of the JAX package's ``data/synthetic.py:make_phantom`` and the
``data/base.py:pad_or_crop_to`` helper it needs (the port imports nothing of
the JAX package), plus :func:`phantom_batch`, a batch of test slices
normalised as the JAX package's ``SyntheticSegDataset.
get_patient_data_for_testing`` prepares them: realistic serving requests for
``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_or_crop_to(image: np.ndarray, hw: Tuple[int, int],
                   pad_value: float = 0.0) -> np.ndarray:
    """Center pad/crop of (H, W) or (H, W, C) arrays to hw."""
    h, w = image.shape[0], image.shape[1]
    th, tw = hw
    ph, pw = max(0, th - h), max(0, tw - w)
    if ph or pw:
        pads = [(ph // 2 + ph % 2, ph // 2), (pw // 2 + pw % 2, pw // 2)]
        pads += [(0, 0)] * (image.ndim - 2)
        image = np.pad(image, pads, constant_values=pad_value)
        h, w = image.shape[0], image.shape[1]
    hs, ws = (h - th) // 2, (w - tw) // 2
    return image[hs:hs + th, ws:ws + tw]


def make_phantom(rng: np.random.RandomState, hw: Tuple[int, int] = (224, 224),
                 num_classes: int = 4):
    """One cardiac-like phantom: returns (image HWC float [0,1], label HW int)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cy = h / 2 + rng.uniform(-h * 0.1, h * 0.1)
    cx = w / 2 + rng.uniform(-w * 0.1, w * 0.1)
    r_lv = rng.uniform(h * 0.05, h * 0.09)
    r_myo = r_lv + rng.uniform(h * 0.02, h * 0.05)
    d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    label = np.zeros(hw, np.int32)
    if num_classes > 2:
        label[d < r_myo] = 2  # MYO ring
    label[d < r_lv] = 1      # LV pool
    if num_classes > 3:
        # RV crescent to the side
        rv_cx = cx - r_myo * rng.uniform(1.5, 2.0)
        d_rv = np.sqrt(((yy - cy) / 1.4) ** 2 + (xx - rv_cx) ** 2)
        label[(d_rv < r_myo * rng.uniform(0.9, 1.2)) & (label == 0)] = 3
    intensities = rng.uniform(0.2, 0.9, size=num_classes)
    image = intensities[label].astype(np.float32)
    image += rng.normal(0, 0.05, hw).astype(np.float32)
    image = np.clip(image, 0, 1)[:, :, None]
    return image, label


def phantom_batch(seed: int, n: int, crop_size: Tuple[int, int] = (192, 192),
                  pad_size: Tuple[int, int] = (224, 224), num_classes: int = 4):
    """``n`` phantom slices drawn at ``pad_size``, center-cropped to
    ``crop_size`` and min-max normalised per slice: ((n, H, W, 1) float32,
    (n, H, W) int32)."""
    imgs, lbls = [], []
    for s in range(n):
        rng = np.random.RandomState(seed * 100003 + s)
        img, lbl = make_phantom(rng, pad_size, num_classes)
        img = pad_or_crop_to(img, crop_size)
        lbl = pad_or_crop_to(lbl, crop_size)
        lo, hi = img.min(), img.max()
        imgs.append((img - lo) / (hi - lo + 1e-8))
        lbls.append(lbl)
    return np.stack(imgs).astype(np.float32), np.stack(lbls).astype(np.int32)
