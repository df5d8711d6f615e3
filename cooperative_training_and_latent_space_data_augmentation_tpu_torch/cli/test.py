"""Evaluation entry point of the port: held-out per-volume metrics of one
checkpoint, or the methods x cvals x datasets table of many.

Counterpart of the JAX package's ``cli/test.py``, which mirrors
``medseg/test_ACDC_triplet_segmentation.py`` (:80-158): it evaluates
patient-wise Dice (and optionally HD, ASD, VolError, VolSim) on the ACDC
test split, M&Ms and the ACDC-C corruption subsets, and writes
``summary.csv`` and ``detail.csv`` per dataset.  One checkpoint::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.test \\
        --checkpoint /tmp/runs/.../model/best/checkpoints \\
        --acdc_root /tmp/synthetic_ACDC --save_dir /tmp/eval

The reference's full results table from one command
(test_ACDC_triplet_segmentation.py:115-158), ``{method}`` and ``{cval}``
filled in from ``--methods`` and ``--cvals``::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.test \\
        --checkpoint_template '/tmp/runs/train_ACDC_10_n_cls_4/{method}/{cval}/model/best/checkpoints' \\
        --cvals 0 --acdc_root /tmp/synthetic_ACDC --acdc_c_root /tmp/ACDC-C --save_dir /tmp/eval

writes each run's CSVs under ``{save_dir}/{method}/cv{cval}/{dataset}/``
and the mean and std across cvals per dataset x method x metric to
``{save_dir}/aggregated.csv``, and prints that table as CSV; a missing
checkpoint directory is reported and skipped.

A checkpoint is a directory of the port's per-module ``.pth`` files
(:func:`..train.checkpoint.save_model`) or of the JAX package's
``.msgpack`` files (:func:`..convert.load_jax_checkpoint`), told apart by
the files present.  Prediction is float32 (the JAX entry builds its
solver without a compute dtype), ``predict(n_iter=--n_iter)``, on the card
(``--device cuda``, the default; it raises if there is none) unless
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Dict, Optional, Sequence

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.convert import (
    load_jax_checkpoint,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.acdc import (
    CardiacACDCDataset,
    probe_format_names,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.base import (
    ConcatDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.mnm import (
    CardiacMMDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.metrics import (
    write_csv_rows,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.tester import (
    AGG_COLUMNS,
    evaluate_cross_domain,
    evaluate_methods_across_cvals,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
    load_model,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    NETWORK_TYPES,
    CooperativePredictor,
)

CORRUPTION_NAMES = ("RandomBias", "RandomSpike", "RandomGhosting", "RandomMotion")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("cross-domain segmentation evaluation (PyTorch port)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a directory of per-module .pth (the port's) or .msgpack "
                        "(the JAX package's) files; without it, weights from seed 0")
    p.add_argument("--checkpoint_template", type=str, default=None,
                   help="a checkpoint path with {method} and {cval} placeholders: "
                        "evaluate --methods x --cvals and aggregate across cvals")
    p.add_argument("--methods", nargs="+",
                   default=["standard_training", "cooperative_training"])
    p.add_argument("--cvals", nargs="+", type=int, default=[0, 1, 2])
    p.add_argument("--network_type", type=str, default="FCN_16_standard")
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--n_iter", type=int, default=2,
                   help="1: FTN only; >=2: FTN + STN refinement")
    p.add_argument("--cval", type=int, default=0)
    p.add_argument("--data_setting", type=str, default="10")
    p.add_argument("--acdc_root", type=str, default=None)
    p.add_argument("--mm_root", type=str, default=None)
    p.add_argument("--acdc_c_root", type=str, default=None,
                   help="root with {corruption}/{pid}_{seed}/ subdirs")
    p.add_argument("--frames", nargs="+", default=["ED", "ES"])
    p.add_argument("--metrics", nargs="+", default=["Dice"],
                   choices=["Dice", "HD", "ASD", "VolError", "VolSim"])
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_datasets(args: argparse.Namespace, cval: int) -> Dict[str, object]:
    """{name: test dataset} of the data roots given (cli/test.py:build_datasets)."""
    datasets = {}
    if args.synthetic:
        datasets["synthetic"] = SyntheticSegDataset(length=10)
        return datasets
    if args.acdc_root:
        per_frame = []
        for f in args.frames:
            # accept .nii.gz (reference layout) or .nrrd (preprocessed)
            img_fmt, label_fmt = probe_format_names(args.acdc_root, f)
            per_frame.append(CardiacACDCDataset(
                root_dir=args.acdc_root, frame=f, split="test",
                data_setting=args.data_setting, cval=cval,
                image_format_name=img_fmt, label_format_name=label_fmt))
        datasets["ACDC"] = ConcatDataset(per_frame)
    if args.mm_root:
        per_frame = []
        for f in args.frames:
            img_fmt, label_fmt = probe_format_names(args.mm_root, f)
            per_frame.append(CardiacMMDataset(
                root_dir=args.mm_root, frame=f,
                image_format_name=img_fmt, label_format_name=label_fmt))
        datasets["MM"] = ConcatDataset(per_frame)
    if args.acdc_c_root:
        for name in CORRUPTION_NAMES:
            root = os.path.join(args.acdc_c_root, name)
            if os.path.isdir(root):
                # ACDC-C volumes ({attack}/{pid}_{seed}/{frame}_img.*) are
                # already preprocessed: no resample or normalisation on
                # load; naming is probed ({frame}_label beside the image,
                # or the reference's {frame}_seg.nii.gz)
                per_frame = []
                for f in args.frames:
                    img_fmt, label_fmt = probe_format_names(root, f)
                    ds = CardiacMMDataset(
                        root_dir=root, frame=f, dataset_name=name,
                        image_format_name=img_fmt, label_format_name=label_fmt,
                        if_resample=False, normalize=False)
                    # they ARE on the 1.36719 mm in-plane grid: HD/ASD in mm,
                    # comparable with the ACDC/MM rows
                    ds.voxelspacing = [1.36719, 1.36719, -1.0]
                    per_frame.append(ds)
                datasets[name] = ConcatDataset(per_frame)
    return datasets


def load_predictor(args: argparse.Namespace,
                   checkpoint: Optional[str] = None) -> CooperativePredictor:
    """The float32 predictor on ``args.device``, with the weights of
    ``checkpoint`` (default ``--checkpoint``; ``.pth`` or ``.msgpack``
    files, by what the directory holds)."""
    if args.network_type not in NETWORK_TYPES:
        raise NotImplementedError(f"network_type {args.network_type!r}: the port has "
                                  f"{NETWORK_TYPES}")
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           f"evaluate on the CPU")
    predictor = CooperativePredictor(num_classes=args.num_classes, n_iter=args.n_iter,
                                     device=args.device, seed=0,
                                     network_type=args.network_type)
    ckpt = checkpoint or args.checkpoint
    if ckpt is None:
        return predictor
    if os.path.exists(os.path.join(ckpt, "image_encoder.pth")):
        return load_model(predictor, ckpt)
    if os.path.exists(os.path.join(ckpt, "image_encoder.msgpack")):
        predictor.load_state_dicts(load_jax_checkpoint(ckpt))
        return predictor
    raise FileNotFoundError(f"{ckpt}: neither image_encoder.pth nor image_encoder.msgpack")


def run(args: argparse.Namespace, predictor: CooperativePredictor) -> Dict[str, Dict]:
    """Evaluate ``predictor`` on ``args``' datasets: {dataset: summary}."""
    datasets = build_datasets(args, args.cval)
    if not datasets:
        raise SystemExit("no datasets specified; pass --acdc_root/--mm_root/"
                         "--acdc_c_root or --synthetic")

    def predict_fn(images: torch.Tensor) -> torch.Tensor:
        return predictor.predict(images, n_iter=args.n_iter)

    return evaluate_cross_domain(predict_fn, datasets, save_dir=args.save_dir,
                                 num_classes=args.num_classes, metrics_list=args.metrics,
                                 device=args.device)


def print_summary(results: Dict[str, Dict]) -> None:
    """One row per dataset of its ``*_mean`` metrics, as CSV on stdout."""
    keys = sorted({k for s in results.values() for k in s if k.endswith("_mean")})
    w = csv.writer(sys.stdout, lineterminator="\n")
    w.writerow(["dataset"] + keys)
    for name, summary in results.items():
        w.writerow([name] + [summary.get(k, "") for k in keys])


def run_template(args: argparse.Namespace):
    """``--checkpoint_template`` over ``--methods`` x ``--cvals``:
    ``(per_run, aggregated)`` of :func:`..eval.tester.evaluate_methods_across_cvals`."""

    def make_predict_fn(method: str, cval: int):
        ckpt = args.checkpoint_template.format(method=method, cval=cval)
        if not os.path.isdir(ckpt):
            print(f"{method}:{ckpt} not found. ")  # the reference prints and skips
            return None
        predictor = load_predictor(args, ckpt)
        return lambda images: predictor.predict(images, n_iter=args.n_iter)

    per_run, aggregated = evaluate_methods_across_cvals(
        make_predict_fn, lambda cval: build_datasets(args, cval), methods=args.methods,
        cvals=args.cvals, save_dir=args.save_dir, num_classes=args.num_classes,
        metrics_list=args.metrics, device=args.device)
    if aggregated is None:
        raise SystemExit("no (method, cval) runs were evaluated; check "
                         "--checkpoint_template and the data roots")
    return per_run, aggregated


def main(argv: Optional[Sequence[str]] = None):
    """One checkpoint: {dataset: summary}.  ``--checkpoint_template``:
    ``(per_run, aggregated)``, the table printed as CSV."""
    args = parse_args(argv)
    if args.checkpoint_template:
        per_run, aggregated = run_template(args)
        write_csv_rows(sys.stdout, AGG_COLUMNS, aggregated)
        return per_run, aggregated
    results = run(args, load_predictor(args))
    print_summary(results)
    return results


if __name__ == "__main__":
    main()
