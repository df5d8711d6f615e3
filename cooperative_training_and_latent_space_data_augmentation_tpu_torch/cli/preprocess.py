"""Offline ACDC preprocessing entry of the port (host-only: numpy and
scipy, no card).

The port's counterpart of the JAX package's ``cli/preprocess.py``, on the
port's own ``data/preprocess.py`` and ``data/nifti.py``; the JAX entry's
re-design of ``medseg/dataset_loader/acdc_preprocess.py`` (:16-149) as a
one-command CLI: for every raw ACDC patient dir (``patient001/Info.cfg`` +
``patient001_frame{XX}.nii.gz``), per ED/ES frame it

  1. 2-98-percentile min-max normalizes intensities to [0, 1]
     (normalize_minmax_data, acdc_preprocess.py:16-36),
  2. resamples in-plane to 1.36719 mm keeping the z spacing
     (resample_np_array, :83-91,127-133),
  3. swaps the RV<->LV labels 3<->1 (:135-137), and
  4. writes ``{out_root}/{pid}/{frame}_{img,seg}.nrrd`` with the corrected
     spacing (:139-149) — the layout ``data/acdc.py`` scans at train time.

Pure numpy/scipy (no SimpleITK; see data/nifti.py).

Usage:
    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.preprocess \\
        --raw_root /data/ACDC_raw --out_root /data/ACDC
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.preprocess import (
    DEFAULT_TARGET_SPACING,
    preprocess_acdc_dataset,
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--raw_root", type=str, required=True,
                   help="raw ACDC root (patientXXX dirs with Info.cfg)")
    p.add_argument("--out_root", type=str, required=True,
                   help="output root (per-patient NRRD dirs)")
    p.add_argument("--frames", nargs="+", default=["ED", "ES"])
    p.add_argument("--target_spacing", nargs=3, type=float,
                   default=list(DEFAULT_TARGET_SPACING),
                   help="x y z target spacing; z<=0 keeps the source z")
    args = p.parse_args(argv)

    count = preprocess_acdc_dataset(args.raw_root, args.out_root,
                                    frames=tuple(args.frames),
                                    target_spacing=tuple(args.target_spacing))
    print(f"preprocessed {count} frames -> {args.out_root}")
    return count


if __name__ == "__main__":
    main()
