"""Synthetic cardiac-like phantoms, made from a seed with numpy.

A copy of the JAX package's ``data/synthetic.py`` (the port imports nothing
of the JAX package): :func:`make_phantom` and :class:`SyntheticSegDataset`,
the phantom dataset of the ``--synthetic`` protocol, plus
:func:`phantom_batch`, a batch of test slices normalised as
``SyntheticSegDataset.get_patient_data_for_testing`` prepares them:
realistic serving requests for ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.base import (
    SegDatasetBase,
    pad_or_crop_to,
)


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


def _test_slices(seeds, crop_size, pad_size, num_classes):
    """Phantoms drawn at ``pad_size`` from ``RandomState(s)`` for each seed,
    center-cropped to ``crop_size`` and min-max normalised per slice."""
    imgs, lbls = [], []
    for s in seeds:
        img, lbl = make_phantom(np.random.RandomState(s), pad_size, num_classes)
        img = pad_or_crop_to(img, crop_size)
        lbl = pad_or_crop_to(lbl, crop_size)
        lo, hi = img.min(), img.max()
        imgs.append((img - lo) / (hi - lo + 1e-8))
        lbls.append(lbl)
    return np.stack(imgs).astype(np.float32), np.stack(lbls).astype(np.int32)


class SyntheticSegDataset(SegDatasetBase):
    """Phantom slices, ``length`` 30 by default like the reference's dummy
    dataset (base_segmentation_dataset.py:104-105); slice ``index`` is drawn
    from ``RandomState(seed * 100003 + index)``."""

    def __init__(self, length: int = 30, pad_size=(224, 224), num_classes: int = 4,
                 seed: int = 0, n_patients: int = 3, slices_per_patient: int = 10,
                 use_cache: bool = True):
        super().__init__(dataset_name="synthetic", pad_size=pad_size,
                         num_classes=num_classes, use_cache=use_cache,
                         length=length)
        self.seed = seed
        self.n_patients = n_patients
        self.slices_per_patient = slices_per_patient
        self.voxelspacing = [1.36719, 1.36719, -1.0]

    def load_data(self, index: int):
        rng = np.random.RandomState(self.seed * 100003 + index)
        return make_phantom(rng, self.pad_size, self.num_classes)

    def get_patient_num(self) -> int:
        return self.n_patients

    def get_id(self, pid_index: int) -> str:
        return f"synthetic_{pid_index:03d}"

    def get_patient_data_for_testing(self, pid_index: int, crop_size=(192, 192)):
        """One patient's volume, slice ``s`` from ``RandomState(seed *
        100003 + pid_index * 1000 + s)`` (cardiac_ACDC_dataset.
        get_patient_data_for_testing:204-232): ((S, H, W, 1) float32,
        (S, H, W) int32)."""
        base = self.seed * 100003 + pid_index * 1000
        return _test_slices(range(base, base + self.slices_per_patient), crop_size,
                            self.pad_size, self.num_classes)


def phantom_batch(seed: int, n: int, crop_size: Tuple[int, int] = (192, 192),
                  pad_size: Tuple[int, int] = (224, 224), num_classes: int = 4):
    """``n`` phantom slices drawn at ``pad_size``, center-cropped to
    ``crop_size`` and min-max normalised per slice: ((n, H, W, 1) float32,
    (n, H, W) int32)."""
    return _test_slices(range(seed * 100003, seed * 100003 + n), crop_size, pad_size,
                        num_classes)
