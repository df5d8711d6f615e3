"""Medical-Decathlon prostate T2 dataset (Task05).

A copy of the JAX package's ``data/prostate.py`` (the port imports nothing
of the JAX package), itself a re-design of
``medseg/dataset_loader/prostate_Decathlon_dataset.py``: it scans
``{root}/{p_id}/t2_img.nrrd`` volumes, splits patients by the reference's
fixed 7-patient test hold-out and scikit-learn's ``train_test_split``
(prostate_Decathlon_dataset.py:173-228), drawn here with numpy
(:func:`.splits.train_test_split`, the same permutations: scikit-learn is
not on the card's machine), and exposes the slice-indexed surface of the
cardiac datasets.  3 classes {0: BG, 1: PZ, 2: CZ}; voxel spacing
[0.625, 0.625, 3.6] (prostate_Decathlon_dataset.py:22-31,91).
"""

from __future__ import annotations

import os
from os.path import join
from typing import Dict, List, Tuple

import numpy as np

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.acdc import (
    CardiacACDCDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.base import (
    SegDatasetBase,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
    train_test_split,
)

PROSTATE_TEST_IDS = ["patient_37", "patient_35", "patient_40", "patient_43",
                     "patient_13", "patient_29", "patient_04"]
PROSTATE_VOXELSPACING = (0.625, 0.625, 3.6)


def get_prostate_split_policy(root_dir: str, identifier: str, cval: int
                              ) -> Dict[str, List[str]]:
    """Reference split policy (prostate_Decathlon_dataset.get_pid_list:173-228):
    fixed test hold-out, 10% val via train_test_split(random_state=cval-1),
    labelled = first half of train, few-shot subsets via
    train_test_split(random_state=cval).

    Deviation: the reference feeds raw ``sorted(os.listdir)`` (:175) into
    train_test_split; only directories are taken here.  On the preprocessed
    per-patient-dir roots the reference ran on, the two agree exactly; on a
    root containing stray files (e.g. a Decathlon dataset.json) the raw
    listing would silently perturb every split, so the filter is kept."""
    if cval < 1:
        raise ValueError("cval must be >= 1")
    all_ids = sorted(d for d in os.listdir(root_dir)
                     if os.path.isdir(join(root_dir, d)))
    train_val = [p for p in all_ids if p not in PROSTATE_TEST_IDS]
    train_ids, val_ids = train_test_split(train_val, test_size=0.1,
                                          random_state=cval - 1)
    half = len(train_ids) // 2
    labelled, unlabelled = train_ids[:half], train_ids[half:]
    if identifier == "all":
        chosen = train_ids
    elif identifier == "three_shot":
        chosen, _ = train_test_split(labelled, train_size=3, random_state=cval)
    elif identifier == "three_shot_upperbound":
        chosen, _ = train_test_split(labelled, train_size=3, random_state=cval)
        chosen = chosen + unlabelled
    elif identifier == "full":
        chosen = labelled
    else:
        value = float(identifier)
        if 0 < value < 1:
            chosen, _ = train_test_split(labelled, train_size=value,
                                         random_state=cval)
        elif value >= 1:
            n = int(value)
            if 0 < n < len(labelled):
                chosen, _ = train_test_split(labelled, train_size=n,
                                             random_state=cval)
            elif n == len(labelled):
                chosen = labelled
            else:
                raise ValueError(f"bad identifier {identifier}")
        else:
            raise NotImplementedError(identifier)
    return {
        "name": f"{identifier}_cv_{cval}",
        "train": chosen,
        "validate": val_ids,
        "test": list(PROSTATE_TEST_IDS),
        "test+unlabelled": list(PROSTATE_TEST_IDS) + unlabelled,
        "unlabelled": unlabelled,
    }


class ProstateDecathlonDataset(CardiacACDCDataset):
    """Slice-indexed prostate dataset with the cardiac dataset surface
    (__getitem__/get_patient_data_for_testing/voxelspacing).

    Reuses the cardiac volume/scan machinery but swaps in the prostate
    split policy and label map; ``binary_segmentation`` folds PZ+CZ into
    one foreground class (prostate_Decathlon_dataset.py:125-126).
    """

    def __init__(self, root_dir: str, split: str = "train",
                 data_setting: str = "three_shot", cval: int = 1,
                 image_format_name: str = "{p_id}/t2_img.nrrd",
                 label_format_name: str = "{p_id}/label.nrrd",
                 pad_size: Tuple[int, int] = (320, 320), num_classes: int = 3,
                 binary_segmentation: bool = False,
                 normalize: bool = True, use_cache: bool = True, seed: int = 0):
        policy = get_prostate_split_policy(root_dir, data_setting, cval)
        idx2cls = {i: i for i in range(num_classes)}
        if binary_segmentation:
            idx2cls = {0: 0, 1: 1, 2: 1}
            num_classes = 2
        # bypass the cardiac constructor (its ACDC split policy); set up
        # SegDatasetBase and the fields CardiacACDCDataset's methods use
        SegDatasetBase.__init__(
            self, dataset_name=f"Prostate_{data_setting}_{split}"
            + (str(cval) if split == "train" else ""),
            pad_size=pad_size, num_classes=num_classes, idx2cls=idx2cls,
            use_cache=use_cache, length=0)
        self.root_dir = root_dir
        self.frame = ""
        self.split = split
        self.image_format_name = image_format_name
        self.label_format_name = label_format_name
        self.if_resample = False  # decathlon volumes are used as stored
        self.new_spacing = None
        self.normalize = normalize
        self.binary_segmentation = binary_segmentation
        self.voxelspacing = list(PROSTATE_VOXELSPACING)
        self._rng = np.random.RandomState(seed)
        self.patient_ids = [pid for pid in policy[split]
                            if os.path.exists(self._img_path(pid))]
        self._volume_cache = {}
        self.index_map = []
        self.scan_dataset()

    def get_id(self, pid_index: int) -> str:
        return self.patient_ids[pid_index]
