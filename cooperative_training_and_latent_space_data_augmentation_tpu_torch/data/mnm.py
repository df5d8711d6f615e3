"""M&Ms and ACDC-C style test datasets: every patient directory under a root.

A copy of the JAX package's ``data/mnm.py`` (the port imports nothing of
the JAX package), the re-design of
``medseg/dataset_loader/cardiac_MM_dataset.py``: the ACDC dataset's surface
without a split policy, a test set of every ``{root}/{p_id}/{frame}_img.*``
found (scan_dataset:127-154); used for M&Ms and the four ACDC-C corruption
subsets (test_ACDC_triplet_segmentation.py:51-68).
"""

from __future__ import annotations

import glob
import os
from os.path import basename, join
from typing import List, Tuple

import numpy as np

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.acdc import (
    CardiacACDCDataset,
    DEFAULT_SPACING,
)


class CardiacMMDataset(CardiacACDCDataset):
    def __init__(self, root_dir: str, frame: str = "ED",
                 image_format_name: str = "{p_id}/{frame}_img.nii.gz",
                 label_format_name: str = "{p_id}/{frame}_seg.nii.gz",
                 pad_size: Tuple[int, int] = (224, 224), num_classes: int = 4,
                 myocardium_only: bool = False, right_ventricle_only: bool = False,
                 if_resample: bool = True, new_spacing=DEFAULT_SPACING,
                 normalize: bool = True, use_cache: bool = True, seed: int = 0,
                 dataset_name: str = "MM"):
        # bypass the split-policy constructor: enumerate all patient dirs;
        # scan=False skips the ACDC-policy scan whose results we'd discard
        # (it would gzip-read every overlapping volume a second time).
        self._all_ids = self._scan_ids(root_dir, image_format_name, frame)
        super().__init__(
            root_dir=root_dir, frame=frame, split="test", data_setting="standard",
            cval=0, image_format_name=image_format_name,
            label_format_name=label_format_name, pad_size=pad_size,
            num_classes=num_classes, myocardium_only=myocardium_only,
            right_ventricle_only=right_ventricle_only, if_resample=if_resample,
            new_spacing=new_spacing, normalize=normalize, use_cache=use_cache,
            seed=seed, scan=False)
        self.dataset_name = dataset_name
        self.patient_ids = self._all_ids
        self.scan_dataset()

    @staticmethod
    def _scan_ids(root_dir: str, image_format_name: str, frame: str) -> List[str]:
        pattern = join(root_dir, image_format_name.format(p_id="*", frame=frame))
        ids = []
        for path in sorted(glob.glob(pattern)):
            rel = os.path.relpath(path, root_dir)
            ids.append(rel.split(os.sep)[0])
        return sorted(set(ids))
