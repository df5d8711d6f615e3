"""Write a synthetic ACDC-layout NRRD tree of cardiac phantoms.

Counterpart of the JAX package's ``cli/make_synthetic_acdc.py``, which
imports the JAX package; this one uses the port's own ``make_phantom``,
``write_nrrd`` and split policies, with the same per-slice seeds, spacing
and defaults, so it writes the same bytes.  It writes
``{out_root}/{pid}/{frame}_{img,seg}.nrrd`` for the requested patient ids
(default: every id the ACDC split policies reference for data_setting 10,
cvals 0-2), each slice a phantom of the synthetic training dataset's
generator under a held-out, pid-derived seed, so a model trained with
``cli.train --synthetic`` is evaluated patient-wise through the file-based
pipeline (``cli.test --acdc_root``)::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.make_synthetic_acdc \\
        --out_root /tmp/synthetic_ACDC
"""

from __future__ import annotations

import argparse
import os
import zlib
from os.path import join
from typing import List, Optional, Sequence, Tuple

import numpy as np

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    write_nrrd,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
    TEST_LIST,
    get_ACDC_split_policy,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    make_phantom,
)

SPACING = (1.36719, 1.36719, 10.0)


def write_patient(out_root: str, pid: str, frame: str, n_slices: int,
                  hw: Tuple[int, int], num_classes: int) -> None:
    imgs, lbls = [], []
    for s in range(n_slices):
        # held-out stream: disjoint from SyntheticSegDataset's
        # seed*100003+index keys by construction (crc32 tag)
        tag = f"synthetic_acdc/{pid}/{frame}/{s}".encode()
        rng = np.random.RandomState(zlib.crc32(tag) & 0x7FFFFFFF)
        img, lbl = make_phantom(rng, tuple(hw), num_classes)
        imgs.append(img[..., 0])
        lbls.append(lbl)
    pdir = join(out_root, pid)
    os.makedirs(pdir, exist_ok=True)
    write_nrrd(join(pdir, f"{frame}_img.nrrd"),
               np.stack(imgs).astype(np.float32), spacing=SPACING)
    write_nrrd(join(pdir, f"{frame}_seg.nrrd"),
               np.stack(lbls).astype(np.int16), spacing=SPACING)


def default_pids() -> List[str]:
    """Every pid a split policy of data_setting 10 references for cvals 0-2
    (patient content is pid-derived, so a subset never changes other pids)."""
    need = set(TEST_LIST)
    for cval in (0, 1, 2):
        for ids in get_ACDC_split_policy("10", cval).values():
            if isinstance(ids, (list, tuple)):
                need.update(ids)
    return sorted(need)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out_root", type=str, required=True)
    p.add_argument("--pids", nargs="+", default=None,
                   help="patient ids (default: every id the ACDC split "
                        "policies reference for data_setting=10, cvals 0-2; "
                        "pass explicit ids, e.g. the test list, to narrow)")
    p.add_argument("--frames", nargs="+", default=["ED", "ES"])
    p.add_argument("--n_slices", type=int, default=10)
    p.add_argument("--hw", nargs=2, type=int, default=[224, 224])
    p.add_argument("--num_classes", type=int, default=4)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Write the tree; returns the pids written."""
    args = parse_args(argv)
    pids = args.pids or default_pids()
    for pid in pids:
        for frame in args.frames:
            write_patient(args.out_root, pid, frame, args.n_slices, args.hw,
                          args.num_classes)
    print(f"wrote {len(pids)} patients x {args.frames} -> {args.out_root}")
    return pids


if __name__ == "__main__":
    main()
