"""The ACDC cardiac dataset: slice-level training and volume-level testing.

A copy of the JAX package's ``data/acdc.py`` (numpy and scipy; the port
imports nothing of the JAX package), the re-design of
``medseg/dataset_loader/cardiac_ACDC_dataset.py``: it scans
``root_dir/{p_id}/{frame}_img.nii.gz`` (or ``.nrrd``, see
:func:`probe_format_names`) per split policy, builds the global slice index
-> (pid, slice) map from each volume's z extent (scan_dataset:176-202),
loads whole volumes with an optional in-plane resample to 1.36719 mm and
2-98 percentile normalisation (load_data:117-161), and re-samples away
empty-label slices.  Volume-wise test access center-crops to 192x192 with
a per-slice 0-1 rescale (get_patient_data_for_testing:204-232).
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.base import (
    SegDatasetBase,
    formulate_labels,
    label_remap_dict,
    pad_or_crop_to,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    read_nifti,
    read_nrrd,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.preprocess import (
    normalize_minmax_data,
    resample_by_spacing,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
    get_ACDC_split_policy,
)

IDX2CLS = {0: "BG", 1: "LV", 2: "MYO", 3: "RV"}  # test_ACDC...py:25-30
DEFAULT_SPACING = [1.36719, 1.36719, -1.0]  # cardiac_ACDC_dataset.py:98-101


def _read_volume(path: str):
    if path.endswith(".nrrd"):
        return read_nrrd(path)
    return read_nifti(path)


_PROBE_EXTS = (".nii.gz", ".nrrd", ".nii")


def probe_format_names(root_dir: str, frame: str = "ED",
                       img_stem: str = "img",
                       label_stems: Sequence[str] = ("seg", "label")):
    """Detect a tree's file naming and return ``(image_format_name,
    label_format_name)``.

    The reference's configs expect ``.nii.gz`` (config/ACDC/...json:30-31)
    but its own offline preprocessor writes ``.nrrd`` (acdc_preprocess.py:
    139-149) — as does ``cli/preprocess.py`` here — so drivers probe the
    patient dirs and accept either.  Labels additionally probe multiple
    stems (and their own extension, which can differ from the image's: the
    ACDC-C generator symlinks the SOURCE label, generate_artefacted_data.py:
    104-110, so an ``.nrrd`` image can sit beside an ``.nii.gz`` label):
    the reference's distributed test sets use ``{frame}_seg``, its ACDC-C
    generator writes ``{frame}_label``.  Defaults to ``.nii.gz``/``seg``
    when the tree is empty/undecidable.  Probing continues past dirs
    without a match (stray/partial dirs don't poison the result)."""
    try:
        entries = sorted(os.listdir(root_dir))
    except OSError:
        entries = []
    for name in entries:
        pdir = join(root_dir, name)
        if not os.path.isdir(pdir):
            continue
        for ext in _PROBE_EXTS:
            if not os.path.exists(join(pdir, f"{frame}_{img_stem}{ext}")):
                continue
            img_fmt = "{p_id}/{frame}_" + img_stem + ext
            for stem in label_stems:
                for lext in (ext,) + tuple(e for e in _PROBE_EXTS if e != ext):
                    if os.path.exists(join(pdir, f"{frame}_{stem}{lext}")):
                        return img_fmt, "{p_id}/{frame}_" + stem + lext
            return img_fmt, "{p_id}/{frame}_" + label_stems[0] + ext
    return ("{p_id}/{frame}_" + img_stem + ".nii.gz",
            "{p_id}/{frame}_" + label_stems[0] + ".nii.gz")


class CardiacACDCDataset(SegDatasetBase):
    def __init__(self, root_dir: str, frame: str = "ED", split: str = "train",
                 data_setting: str = "10", cval: int = 0,
                 image_format_name: str = "{p_id}/{frame}_img.nii.gz",
                 label_format_name: str = "{p_id}/{frame}_seg.nii.gz",
                 pad_size: Tuple[int, int] = (224, 224), num_classes: int = 4,
                 myocardium_only: bool = False, right_ventricle_only: bool = False,
                 if_resample: bool = True, new_spacing=DEFAULT_SPACING,
                 normalize: bool = True, use_cache: bool = True, seed: int = 0,
                 scan: bool = True):
        idx2cls = label_remap_dict(num_classes, myocardium_only, right_ventricle_only)
        if myocardium_only or right_ventricle_only:
            num_classes = 2
        super().__init__(dataset_name="ACDC", pad_size=pad_size,
                         num_classes=num_classes, idx2cls=idx2cls,
                         use_cache=use_cache, length=0)
        self.root_dir = root_dir
        self.frame = frame
        self.split = split
        self.image_format_name = image_format_name
        self.label_format_name = label_format_name
        self.if_resample = if_resample
        self.new_spacing = new_spacing
        self.normalize = normalize
        self.voxelspacing = list(new_spacing) if if_resample else [1.0, 1.0, 1.0]
        self._rng = np.random.RandomState(seed)
        policy = get_ACDC_split_policy(data_setting, cval)
        self.patient_ids = [pid for pid in policy[split]
                            if os.path.exists(self._img_path(pid))]
        self._volume_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self.index_map: List[Tuple[str, int]] = []
        if scan:  # subclasses that replace patient_ids pass scan=False
            self.scan_dataset()

    # ---------------------------------------------------------------- paths
    def _img_path(self, pid: str) -> str:
        return join(self.root_dir, self.image_format_name.format(
            p_id=pid, frame=self.frame))

    def _label_path(self, pid: str) -> str:
        return join(self.root_dir, self.label_format_name.format(
            p_id=pid, frame=self.frame))

    # ----------------------------------------------------------------- scan
    def scan_dataset(self):
        """Global-slice-index map (cardiac_ACDC_dataset.scan_dataset:176-202)."""
        self.index_map = []
        for pid in self.patient_ids:
            vol, _ = _read_volume(self._img_path(pid))
            for s in range(vol.shape[0]):
                self.index_map.append((pid, s))
        self._length = len(self.index_map)

    def _load_volume(self, pid: str):
        if self.use_cache and pid in self._volume_cache:
            return self._volume_cache[pid]
        img, spacing = _read_volume(self._img_path(pid))
        lbl, _ = _read_volume(self._label_path(pid))
        img = img.astype(np.float32)
        lbl = lbl.astype(np.int32)
        if self.if_resample and self.new_spacing is not None:
            img = resample_by_spacing(img, spacing, self.new_spacing, order=1)
            lbl = resample_by_spacing(lbl, spacing, self.new_spacing, order=0)
        if self.normalize:
            img = normalize_minmax_data(img)
        pair = (img, lbl)
        if self.use_cache:
            self._volume_cache[pid] = pair
        return pair

    # ----------------------------------------------------------------- item
    def load_data(self, index: int):
        """Slice fetch with empty-label-slice rejection
        (cardiac_ACDC_dataset.load_data:117-161)."""
        pid, slice_id = self.index_map[index]
        img, lbl = self._load_volume(pid)
        slice_id = min(slice_id, img.shape[0] - 1)
        if lbl[slice_id].sum() == 0:
            nonempty = np.where(lbl.reshape(lbl.shape[0], -1).sum(axis=1) > 0)[0]
            if len(nonempty) > 0:
                slice_id = int(self._rng.choice(nonempty))
        return img[slice_id][:, :, None], lbl[slice_id]

    # -------------------------------------------------------------- volumes
    def get_patient_num(self) -> int:
        return len(self.patient_ids)

    def get_id(self, pid_index: int) -> str:
        return f"{self.patient_ids[pid_index]}_{self.frame}"

    def get_patient_data_for_testing(self, pid_index: int,
                                     crop_size: Tuple[int, int] = (192, 192),
                                     normalize_2D: bool = True):
        """Full volume, center crop/pad, per-slice 0-1 rescale
        (cardiac_ACDC_dataset.get_patient_data_for_testing:204-232)."""
        pid = self.patient_ids[pid_index]
        img, lbl = self._load_volume(pid)
        img = np.stack([pad_or_crop_to(s, crop_size) for s in img])
        lbl = np.stack([pad_or_crop_to(s, crop_size) for s in lbl])
        lbl = formulate_labels(lbl, self.idx2cls)
        if normalize_2D:
            flat = img.reshape(img.shape[0], -1)
            lo = flat.min(axis=1)[:, None, None]
            hi = flat.max(axis=1)[:, None, None]
            img = (img - lo) / (hi - lo + 1e-8)
        return img[..., None].astype(np.float32), lbl.astype(np.int32)
