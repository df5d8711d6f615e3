"""Offline preprocessing (host-side numpy and scipy).

A copy of the JAX package's ``data/preprocess.py`` (the port imports
nothing of the JAX package), the re-design of
``medseg/dataset_loader/acdc_preprocess.py`` and the helpers duplicated in
``dataset_utils.py``:

  * ``normalize_minmax_data``  <- :16-36 (2-98 percentile min-max to [0,1])
  * ``resample_by_spacing``    <- :83-91 / dataset_utils.py:39-63 (in-plane
    resample to 1.36719 mm keeping z when target z <= 0), and
    ``resample_by_shape``/``resample_by_ref`` (affine_transform.py:83-106)
  * ``swap_labels_acdc``       <- :135-137 (RV<->LV, 3<->1)
  * ``preprocess_acdc_patient``/``preprocess_acdc_dataset`` <- the per-patient
    driver (:97-149) writing {pid}/{frame}_img.nrrd and _seg.nrrd with the
    corrected spacing.  (The reference's N4 bias correction is commented
    out there, :71-80,117-119, and is likewise omitted.)
"""

from __future__ import annotations

import os
from os.path import join
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

DEFAULT_TARGET_SPACING = (1.36719, 1.36719, -1.0)


def normalize_minmax_data(image: np.ndarray, min_val: float = 2.0,
                          max_val: float = 98.0) -> np.ndarray:
    """Percentile min-max normalization to [0, 1]
    (acdc_preprocess.normalize_minmax_data:16-36)."""
    lo = np.percentile(image, min_val)
    hi = np.percentile(image, max_val)
    out = (image.astype(np.float32) - lo) / (hi - lo + 1e-10)
    return np.clip(out, 0.0, 1.0)


def resample_by_spacing(array_zyx: np.ndarray, spacing_xyz: Sequence[float],
                        new_spacing_xyz: Sequence[float] = DEFAULT_TARGET_SPACING,
                        order: int = 1) -> np.ndarray:
    """Resample a (z, y, x) volume to new (x, y, z) spacing; any target
    component <= 0 keeps the original spacing along that axis
    (acdc_preprocess.resample_np_array:83-91)."""
    sx, sy, sz = [float(s) for s in spacing_xyz[:3]]
    tx, ty, tz = [float(s) for s in new_spacing_xyz[:3]]
    zoom_x = sx / tx if tx > 0 else 1.0
    zoom_y = sy / ty if ty > 0 else 1.0
    zoom_z = sz / tz if tz > 0 else 1.0
    if abs(zoom_x - 1) < 1e-6 and abs(zoom_y - 1) < 1e-6 and abs(zoom_z - 1) < 1e-6:
        return array_zyx
    return ndimage.zoom(array_zyx, (zoom_z, zoom_y, zoom_x), order=order,
                        mode="nearest", grid_mode=False)


def resample_by_shape(array_zyx: np.ndarray, spacing_xyz: Sequence[float],
                      new_shape_zyx: Sequence[int],
                      new_spacing_xyz: Sequence[float],
                      order: int = 1) -> np.ndarray:
    """Resample onto an explicit (shape, spacing) output grid
    (affine_transform.resample_by_shape:83-94: sitk.Resample with an identity
    affine — output index i samples input at i * new_spacing / old_spacing,
    corner-aligned at the shared origin)."""
    scale = [float(new_spacing_xyz[2 - a]) / float(spacing_xyz[2 - a])
             for a in range(3)]  # zyx axis a <- xyz component 2-a
    return ndimage.affine_transform(
        array_zyx, np.diag(scale), output_shape=tuple(int(s) for s in new_shape_zyx),
        order=order, mode="constant", cval=0.0)


def resample_by_ref(array_zyx: np.ndarray, spacing_xyz: Sequence[float],
                    ref_shape_zyx: Sequence[int],
                    ref_spacing_xyz: Sequence[float],
                    order: int = 1) -> np.ndarray:
    """Resample onto a reference volume's grid
    (affine_transform.resample_by_ref:96-106)."""
    return resample_by_shape(array_zyx, spacing_xyz, ref_shape_zyx,
                             ref_spacing_xyz, order=order)


def swap_labels_acdc(label: np.ndarray) -> np.ndarray:
    """Swap RV<->LV labels 3<->1 (acdc_preprocess.py:135-137); raw ACDC has
    {1: RV, 2: MYO, 3: LV}, the pipeline standardizes to {1: LV, 3: RV}."""
    out = label.copy()
    out[label == 1] = 3
    out[label == 3] = 1
    return out


def preprocess_acdc_patient(img_path: str, seg_path: str, out_dir: str,
                            pid: str, frame: str,
                            target_spacing=DEFAULT_TARGET_SPACING,
                            if_swap_labels: bool = True) -> Tuple[str, str]:
    """Preprocess one ACDC frame: percentile-normalize, resample in-plane,
    swap labels, write NRRDs (acdc_preprocess.py:97-149)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
        read_nifti,
        write_nrrd,
    )

    img, spacing = read_nifti(img_path)
    seg, _ = read_nifti(seg_path)
    img = normalize_minmax_data(img.astype(np.float32))
    img = resample_by_spacing(img, spacing, target_spacing, order=1)
    seg = resample_by_spacing(seg.astype(np.int16), spacing, target_spacing,
                              order=0)
    if if_swap_labels:
        seg = swap_labels_acdc(seg)
    new_spacing = tuple(t if t > 0 else s for s, t in zip(spacing, target_spacing))
    patient_dir = join(out_dir, pid)
    os.makedirs(patient_dir, exist_ok=True)
    img_out = join(patient_dir, f"{frame}_img.nrrd")
    seg_out = join(patient_dir, f"{frame}_seg.nrrd")
    write_nrrd(img_out, img.astype(np.float32), new_spacing)
    write_nrrd(seg_out, seg.astype(np.int16), new_spacing)
    return img_out, seg_out


def preprocess_acdc_dataset(root_dir: str, out_dir: str,
                            frames: Sequence[str] = ("ED", "ES"),
                            target_spacing=DEFAULT_TARGET_SPACING) -> int:
    """Batch driver over raw ACDC layout patient{pid}/Info.cfg; returns number
    of frames processed.  Raw layout: patient001/patient001_frame01.nii.gz."""
    count = 0
    for name in sorted(os.listdir(root_dir)):
        pdir = join(root_dir, name)
        info = join(pdir, "Info.cfg")
        if not os.path.isdir(pdir) or not os.path.exists(info):
            continue
        cfg = {}
        with open(info) as f:
            for line in f:
                if ":" in line:
                    k, v = line.split(":", 1)
                    cfg[k.strip()] = v.strip()
        pid = name.replace("patient", "")
        for frame_name in frames:
            frame_no = int(cfg[frame_name])
            img_path = join(pdir, f"{name}_frame{frame_no:02d}.nii.gz")
            seg_path = join(pdir, f"{name}_frame{frame_no:02d}_gt.nii.gz")
            if os.path.exists(img_path) and os.path.exists(seg_path):
                preprocess_acdc_patient(img_path, seg_path, out_dir, pid,
                                        frame_name, target_spacing)
                count += 1
    return count
