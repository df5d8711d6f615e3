"""The dataset base: slice-indexed segmentation datasets and their
concatenation.

A copy of the JAX package's ``data/base.py`` (numpy only; the port imports
nothing of the JAX package): ``formulate_labels``, ``label_remap_dict``,
``pad_or_crop_to``, ``SegDatasetBase``, ``ConcatDataset``,
``get_all_image_array_from_dataset``, ``get_mean_image`` and
``CombinedDataset``, the re-design of the reference's ``BaseSegDataset``,
``ConcatDataSet``, ``CombinedDataSet`` and its dataset utilities
(``medseg/dataset_loader/base_segmentation_dataset.py:24-228,230-307``,
``dataset_utils.py:72-91``).
Datasets return raw fixed-shape samples (an HWC float image at the pad
size, HW int32 labels); the augmentation runs on the device
(:mod:`..ops.augment`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def formulate_labels(label: np.ndarray, idx2cls_dict: Optional[Dict[int, int]]
                     ) -> np.ndarray:
    """Remap raw label ids through a {raw_id: train_id} dict
    (base_segmentation_dataset.formulate_labels:190-202)."""
    if idx2cls_dict is None:
        return label
    out = np.zeros_like(label)
    for raw_id, train_id in idx2cls_dict.items():
        out[label == raw_id] = train_id
    return out


def label_remap_dict(num_raw_classes: int = 4, myocardium_only: bool = False,
                     right_ventricle_only: bool = False) -> Optional[Dict[int, int]]:
    """{raw: train} maps for the binarization modes (cardiac_ACDC_dataset.py:60-75);
    standard class map {0:BG, 1:LV, 2:MYO, 3:RV}."""
    if myocardium_only:
        return {0: 0, 1: 0, 2: 1, 3: 0}
    if right_ventricle_only:
        return {0: 0, 1: 0, 2: 0, 3: 1}
    return None


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


class SegDatasetBase:
    """Slice-level dataset interface.

    ``__getitem__(i)`` -> {'image': HWC float32 at pad_size, 'label': HW
    int32}.  Subclasses implement ``load_data(index)`` returning the raw
    (image HWC, label HW); the default gives random data "for sanity
    check" (base_segmentation_dataset.load_data:87-102).
    """

    def __init__(self, dataset_name: str = "dummy",
                 pad_size: Tuple[int, int] = (224, 224),
                 num_classes: int = 4,
                 idx2cls: Optional[Dict[int, int]] = None,
                 use_cache: bool = True,
                 length: int = 30):
        self.dataset_name = dataset_name
        self.pad_size = tuple(pad_size)
        self.num_classes = num_classes
        self.idx2cls = idx2cls
        self.use_cache = use_cache
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._length = length
        self.voxelspacing = [1.0, 1.0, 1.0]

    def __len__(self) -> int:
        return self._length

    def load_data(self, index: int):
        rng = np.random.RandomState(index)
        image = rng.rand(*self.pad_size, 1).astype(np.float32)
        label = rng.randint(0, self.num_classes, self.pad_size).astype(np.int32)
        return image, label

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.use_cache and index in self._cache:
            return self._cache[index]
        image, label = self.load_data(index)
        image = pad_or_crop_to(np.asarray(image, np.float32), self.pad_size)
        label = pad_or_crop_to(np.asarray(label), self.pad_size).astype(np.int32)
        label = formulate_labels(label, self.idx2cls)
        if image.ndim == 2:
            image = image[:, :, None]
        sample = {"image": image, "label": label}
        if self.use_cache:
            self._cache[index] = sample
        return sample

    # volume access for testing (overridden by real datasets)
    def get_patient_num(self) -> int:
        return 1

    def get_id(self, pid_index: int) -> str:
        return str(pid_index)

    def get_voxel_spacing(self, pid_index: int = 0) -> List[float]:
        return list(self.voxelspacing)

    def get_patient_data_for_testing(self, pid_index: int,
                                     crop_size: Tuple[int, int] = (192, 192)):
        raise NotImplementedError


class ConcatDataset(SegDatasetBase):
    """Slice- and patient-level index arithmetic over several datasets
    (base_segmentation_dataset.ConcatDataSet:250-307)."""

    def __init__(self, datasets: Sequence[SegDatasetBase]):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.dataset_name = "+".join(d.dataset_name for d in datasets)
        self.num_classes = datasets[0].num_classes
        self.pad_size = datasets[0].pad_size

    def __len__(self) -> int:
        return sum(len(d) for d in self.datasets)

    def __getitem__(self, index: int):
        for d in self.datasets:
            if index < len(d):
                return d[index]
            index -= len(d)
        raise IndexError(index)

    def get_patient_num(self) -> int:
        return sum(d.get_patient_num() for d in self.datasets)

    def _locate_patient(self, pid_index: int):
        for d in self.datasets:
            n = d.get_patient_num()
            if pid_index < n:
                return d, pid_index
            pid_index -= n
        raise IndexError(pid_index)

    def get_id(self, pid_index: int) -> str:
        d, local = self._locate_patient(pid_index)
        return d.get_id(local)

    def get_voxel_spacing(self, pid_index: int = 0):
        d, local = self._locate_patient(pid_index)
        return d.get_voxel_spacing(local)

    def get_patient_data_for_testing(self, pid_index: int,
                                     crop_size: Tuple[int, int] = (192, 192)):
        d, local = self._locate_patient(pid_index)
        return d.get_patient_data_for_testing(local, crop_size)


def get_all_image_array_from_dataset(dataset) -> "np.ndarray":
    """Stack every slice image in a dataset
    (dataset_utils.get_all_image_array_from_datastet:72-84).

    Goes through ``dataset[i]`` (padded, uniform shape) — ``load_data`` is
    raw/per-dataset and ConcatDataset doesn't define it."""
    arrays = [np.asarray(dataset[i]["image"]) for i in range(len(dataset))]
    return np.stack(arrays)


def get_mean_image(dataset) -> "np.ndarray":
    """Pixelwise mean image over a dataset (dataset_utils.get_mean_image:86-91)."""
    if len(dataset) == 0:
        raise ValueError("get_mean_image: dataset is empty")
    total = None
    for i in range(len(dataset)):
        img = np.asarray(dataset[i]["image"], np.float64)
        total = img if total is None else total + img
    return (total / len(dataset)).astype(np.float32)


class CombinedDataset:
    """Paired source/target sampling (CombinedDataSet:230-247)."""

    def __init__(self, source_dataset: SegDatasetBase, target_dataset: SegDatasetBase):
        self.source = source_dataset
        self.target = target_dataset

    def __len__(self) -> int:
        return max(len(self.source), len(self.target))

    def __getitem__(self, index: int):
        return (self.source[index % len(self.source)],
                self.target[index % len(self.target)])
