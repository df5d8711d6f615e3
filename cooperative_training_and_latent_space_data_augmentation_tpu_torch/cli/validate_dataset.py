"""Go/no-go validator for a user's real ACDC / M&Ms / ACDC-C data tree
(host-only: numpy, no card).

The port's counterpart of the JAX package's ``cli/validate_dataset.py``,
on the port's own ``data/{nifti,acdc,mnm,splits}.py``, so a tree it
accepts is one the port's training and evaluation read.  The JAX entry's
description follows.

VERDICT r4 #3: the real (license-gated) datasets are absent from this
environment, so Dice parity on them is run by whoever holds the licenses —
this tool makes that turnkey.  It walks a data tree with the framework's own
pure-numpy readers (`data/nifti.py`), so anything it accepts, the training
and eval pipelines will read identically; it checks exactly the invariants
those pipelines rely on and prints a PASS/WARN/FAIL report with a final
GO / NO-GO verdict (exit code 0 / 1).

Checks per volume (reference invariants cited):
  * image+label headers parse and shapes match
    (`medseg/common_utils/basic_operations.py:337-365` reads both with
    SimpleITK and assumes alignment);
  * label values are integers in [0, num_classes)
    (`medseg/test_ACDC_triplet_segmentation.py:25-30` class map);
  * at least one non-empty label slice exists (the datasets RESAMPLE away
    empty slices, `medseg/dataset_loader/cardiac_ACDC_dataset.py:138-149` —
    an all-empty volume would loop);
  * in-plane spacing vs the 1.36719 mm protocol value
    (`medseg/dataset_loader/acdc_preprocess.py:97,127-133`): WARN when the
    tree looks unpreprocessed (datasets resample on the fly, but
    `cli/preprocess.py` is the offline protocol);
  * finite intensities; WARN on constant images.

Checks per tree:
  * every patient id demanded by the split policies (`--data_setting` x
    `--cvals`, `medseg/dataset_loader/ACDC_few_shot_cv_settings.py:10-159`)
    is present with every `--frames` volume;
  * naming matches a probeable `{p_id}/{frame}_{img,seg|label}.{nii.gz,nrrd}`
    scheme (the reference's configs use .nii.gz, its preprocessor writes
    .nrrd — both accepted, `data/acdc.py:probe_format_names`);
  * ACDC-C trees additionally need the `{attack}/{pid}_{seed}` layout of
    `medseg/dataset_loader/generate_artefacted_data.py:66-110`.

Usage:
    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.validate_dataset --acdc_root /data/ACDC [--mm_root /data/MM]
        [--acdc_c_root /data/ACDC_C] [--data_setting 10] [--cvals 0 1 2]
        [--frames ED ES] [--num_classes 4] [--max_patients N]

See RUNBOOK.md for where this sits in the full real-data parity protocol.
"""

from __future__ import annotations

import argparse
import os
from os.path import join

import numpy as np

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.acdc import (
    DEFAULT_SPACING,
    _read_volume,
    probe_format_names,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.mnm import (
    CardiacMMDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
    get_ACDC_split_policy,
)

ATTACKS = ("RandomBias", "RandomSpike", "RandomGhosting", "RandomMotion")


class Report:
    """Collects PASS/WARN/FAIL lines; FAIL anywhere => NO-GO."""

    def __init__(self):
        self.lines = []
        self.counts = {"PASS": 0, "WARN": 0, "FAIL": 0}

    def add(self, level: str, msg: str):
        self.counts[level] += 1
        self.lines.append((level, msg))
        print(f"[{level}] {msg}", flush=True)

    def ok(self, msg):
        self.add("PASS", msg)

    def warn(self, msg):
        self.add("WARN", msg)

    def fail(self, msg):
        self.add("FAIL", msg)

    @property
    def go(self) -> bool:
        return self.counts["FAIL"] == 0


def check_volume_pair(rep: Report, tag: str, img_path: str, lbl_path: str,
                      num_classes: int, spacing_tol: float = 1e-3):
    """Validate one image+label volume pair; True if readable at all."""
    try:
        img, spacing = _read_volume(img_path)
    except Exception as e:  # noqa: BLE001 — report ANY parse failure
        rep.fail(f"{tag}: image unreadable ({type(e).__name__}: {e})")
        return False
    try:
        lbl, _ = _read_volume(lbl_path)
    except Exception as e:  # noqa: BLE001
        rep.fail(f"{tag}: label unreadable ({type(e).__name__}: {e})")
        return False

    if img.shape != lbl.shape:
        rep.fail(f"{tag}: image shape {img.shape} != label shape {lbl.shape}")
        return True
    if img.ndim != 3:
        rep.fail(f"{tag}: expected 3-D (z, y, x) volume, got {img.shape}")
        return True
    if not np.isfinite(img).all():
        rep.fail(f"{tag}: image contains NaN/Inf")
    if float(img.max()) == float(img.min()):
        rep.warn(f"{tag}: image is constant (value {float(img.min()):g})")

    vals = np.unique(lbl)
    if not np.allclose(vals, np.round(vals)):
        rep.fail(f"{tag}: non-integer label values {vals[:8]}")
    else:
        bad = [int(v) for v in vals if not 0 <= v < num_classes]
        if bad:
            rep.fail(f"{tag}: label values {bad} outside [0, {num_classes}) "
                     "— check class remapping / run cli/preprocess.py")
    if not (lbl > 0).any():
        rep.fail(f"{tag}: label volume entirely background (empty-slice "
                 "resampling would loop)")

    inplane = spacing[:2] if len(spacing) >= 2 else spacing
    want = DEFAULT_SPACING[0]
    if any(abs(float(s) - want) > spacing_tol for s in inplane):
        rep.warn(f"{tag}: in-plane spacing {tuple(round(float(s), 4) for s in inplane)}"
                 f" != protocol {want} mm — fine (datasets resample on the "
                 "fly) but cli/preprocess.py is the offline protocol")
    return True


def validate_acdc(rep: Report, root: str, data_setting: str, cvals, frames,
                  num_classes: int, max_patients: int | None):
    if not os.path.isdir(root):
        rep.fail(f"ACDC root {root} is not a directory")
        return
    img_fmt, lbl_fmt = probe_format_names(root, frame=frames[0])
    rep.ok(f"ACDC naming probe: image='{img_fmt}' label='{lbl_fmt}'")

    needed = []
    for cval in cvals:
        pol = get_ACDC_split_policy(data_setting, cval)
        for split in ("train", "validate", "test"):
            for pid in pol[split]:
                if pid not in needed:
                    needed.append(pid)
    missing = [pid for pid in needed if not os.path.isdir(join(root, pid))]
    if missing:
        rep.fail(f"ACDC: {len(missing)}/{len(needed)} split-policy patients "
                 f"missing (data_setting={data_setting}, cvals={list(cvals)}):"
                 f" {missing[:10]}{'...' if len(missing) > 10 else ''}")
    else:
        rep.ok(f"ACDC: all {len(needed)} patients required by "
               f"data_setting={data_setting} x cvals={list(cvals)} present")

    present = [pid for pid in needed if os.path.isdir(join(root, pid))]
    if max_patients:
        present = present[:max_patients]
    n_pairs = 0
    for pid in present:
        for frame in frames:
            ip = join(root, img_fmt.format(p_id=pid, frame=frame))
            lp = join(root, lbl_fmt.format(p_id=pid, frame=frame))
            for path, what in ((ip, "image"), (lp, "label")):
                if not os.path.exists(path):
                    rep.fail(f"ACDC {pid}/{frame}: {what} file missing "
                             f"({path})")
                    break
            else:
                check_volume_pair(rep, f"ACDC {pid}/{frame}", ip, lp,
                                  num_classes)
                n_pairs += 1
    rep.ok(f"ACDC: parsed {n_pairs} image+label volume pairs with "
           "data/nifti.py")


def validate_mm(rep: Report, root: str, frames, num_classes: int,
                max_patients: int | None):
    if not os.path.isdir(root):
        rep.fail(f"M&Ms root {root} is not a directory")
        return
    img_fmt, lbl_fmt = probe_format_names(root, frame=frames[0])
    ids = CardiacMMDataset._scan_ids(root, img_fmt, frames[0])
    if not ids:
        rep.fail(f"M&Ms: no patient dirs matching {img_fmt} under {root}")
        return
    rep.ok(f"M&Ms: {len(ids)} patients (naming '{img_fmt}')")
    if max_patients:
        ids = ids[:max_patients]
    for pid in ids:
        for frame in frames:
            ip = join(root, img_fmt.format(p_id=pid, frame=frame))
            lp = join(root, lbl_fmt.format(p_id=pid, frame=frame))
            if not os.path.exists(ip):
                rep.warn(f"M&Ms {pid}: no {frame} image — patient skipped "
                         "by the scanner")
                continue
            if not os.path.exists(lp):
                rep.fail(f"M&Ms {pid}/{frame}: label missing ({lp})")
                continue
            check_volume_pair(rep, f"MM {pid}/{frame}", ip, lp, num_classes)


def validate_acdc_c(rep: Report, root: str, frames, num_classes: int,
                    max_patients: int | None):
    if not os.path.isdir(root):
        rep.fail(f"ACDC-C root {root} is not a directory")
        return
    found_any = False
    for attack in ATTACKS:
        adir = join(root, attack)
        if not os.path.isdir(adir):
            rep.warn(f"ACDC-C: corruption subset '{attack}' missing "
                     f"(generate with cli/generate_acdc_c.py)")
            continue
        found_any = True
        img_fmt, lbl_fmt = probe_format_names(adir, frame=frames[0])
        ids = CardiacMMDataset._scan_ids(adir, img_fmt, frames[0])
        if not ids:
            rep.fail(f"ACDC-C/{attack}: no '{{pid}}_{{seed}}' patient dirs")
            continue
        seeds = {pid.rsplit("_", 1)[-1] for pid in ids if "_" in pid}
        rep.ok(f"ACDC-C/{attack}: {len(ids)} cases, seeds={sorted(seeds)}")
        subset = ids[:max_patients] if max_patients else ids
        for pid in subset:
            for frame in frames:
                ip = join(adir, img_fmt.format(p_id=pid, frame=frame))
                lp = join(adir, lbl_fmt.format(p_id=pid, frame=frame))
                if not os.path.exists(ip) or not os.path.exists(lp):
                    rep.fail(f"ACDC-C/{attack} {pid}/{frame}: missing "
                             "image or label")
                    continue
                check_volume_pair(rep, f"ACDC-C/{attack} {pid}/{frame}",
                                  ip, lp, num_classes)
    if not found_any:
        rep.fail(f"ACDC-C: none of {ATTACKS} present under {root}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Validate a real ACDC/M&Ms/ACDC-C tree for the parity "
                    "protocol (RUNBOOK.md)")
    ap.add_argument("--acdc_root", default=None)
    ap.add_argument("--mm_root", default=None)
    ap.add_argument("--acdc_c_root", default=None)
    ap.add_argument("--data_setting", default="10")
    ap.add_argument("--cvals", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--frames", nargs="+", default=["ED", "ES"])
    ap.add_argument("--num_classes", type=int, default=4)
    ap.add_argument("--max_patients", type=int, default=None,
                    help="cap deep-checked patients per tree (default: all)")
    args = ap.parse_args(argv)

    if not (args.acdc_root or args.mm_root or args.acdc_c_root):
        ap.error("give at least one of --acdc_root / --mm_root / --acdc_c_root")

    rep = Report()
    if args.acdc_root:
        validate_acdc(rep, args.acdc_root, args.data_setting, args.cvals,
                      args.frames, args.num_classes, args.max_patients)
    if args.mm_root:
        validate_mm(rep, args.mm_root, args.frames, args.num_classes,
                    args.max_patients)
    if args.acdc_c_root:
        validate_acdc_c(rep, args.acdc_c_root, args.frames, args.num_classes,
                        args.max_patients)

    print(f"\n{rep.counts['PASS']} pass, {rep.counts['WARN']} warn, "
          f"{rep.counts['FAIL']} fail")
    print("VERDICT: GO — tree is ready for the RUNBOOK.md protocol"
          if rep.go else
          "VERDICT: NO-GO — fix the FAIL lines above before training")
    return 0 if rep.go else 1


if __name__ == "__main__":
    raise SystemExit(main())
