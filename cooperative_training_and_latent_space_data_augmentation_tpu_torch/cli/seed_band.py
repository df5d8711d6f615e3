"""The seed band: train the ``--synthetic`` protocol at several seeds and
score each best checkpoint on the synthetic ACDC tree's test list.

For each seed it runs the port's own entries, as a user would type them::

    cli.train --synthetic --bf16 --max_epochs 300 --seed s --save_dir {work}/seed{s} [--log]
    cli.test --checkpoint {best}/checkpoints --acdc_root {tree} --save_dir {work}/eval{s}

on a tree that ``cli.make_synthetic_acdc --pids`` of the test list writes
once, and appends one JSON line per seed to ``--out`` (best validation
Mean IoU, its epoch, the per-class held-out Dice and their mean, seconds
of training and of evaluation, the card).  At the end it prints the mean
and the population std (``ddof=0``) over the seeds in ``--out``, the
statistic the JAX package's ``cli/aggregate_seed_sweep.py`` reports::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.seed_band \\
        --seeds 40 41 42 --work_dir /tmp/band --out band.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    make_synthetic_acdc,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import test as cli_test
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli_train
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
    TEST_LIST,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.driver import (
    experiment_dirs,
)

CLASSES = ("LV_Dice", "MYO_Dice", "RV_Dice")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("seed band of the --synthetic protocol (PyTorch port)")
    p.add_argument("--seeds", nargs="+", type=int, default=[40, 41, 42, 43, 44, 45])
    p.add_argument("--max_epochs", type=int, default=300)
    p.add_argument("--work_dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True, help="JSON lines, one per seed")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--log", action="store_true",
                   help="cli.train's --log: per-epoch scalars under each seed's log dir")
    return p.parse_args(argv)


def run_seed(seed: int, tree: str, args: argparse.Namespace) -> Dict:
    """Train and evaluate one seed through the command lines' ``main``."""
    train_args = cli_train.parse_args([
        "--synthetic", "--bf16", "--max_epochs", str(args.max_epochs), "--seed", str(seed),
        "--save_dir", os.path.join(args.work_dir, f"seed{seed}"), "--device", args.device]
        + (["--log"] if args.log else []))
    cfg, name = cli_train.load_config(train_args)
    t0 = time.perf_counter()
    _, result = cli_train.run(train_args, cfg, name)
    train_sec = time.perf_counter() - t0
    _, model_dir = experiment_dirs(train_args.save_dir, cfg.data.dataset_name,
                                   train_args.data_setting, cfg.data.num_classes, name,
                                   train_args.cval)
    best = os.path.join(model_dir, "best", "checkpoints")
    t0 = time.perf_counter()
    summary = cli_test.main(["--checkpoint", best, "--acdc_root", tree, "--device", args.device,
                             "--save_dir", os.path.join(args.work_dir, f"eval{seed}")])["ACDC"]
    dice = {k: float(summary[f"{k}_mean"]) for k in CLASSES}
    return {"seed": seed, "best_val_iou": float(result.best_score),
            "best_epoch": int(result.best_epoch), "last_epoch": int(result.last_epoch), **dice,
            "mean_dice": float(np.mean(list(dice.values()))), "train_sec": train_sec,
            "eval_sec": time.perf_counter() - t0,
            "device": torch.cuda.get_device_name(0) if args.device != "cpu" else "cpu"}


def band(rows: List[Dict]) -> Dict[str, List[float]]:
    """{metric: [mean, population std]} over the rows."""
    keys = ("best_val_iou",) + CLASSES + ("mean_dice",)
    return {k: [float(np.mean([r[k] for r in rows])), float(np.std([r[k] for r in rows]))]
            for k in keys}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    args = parse_args(argv)
    tree = os.path.join(args.work_dir, "synthetic_ACDC")
    make_synthetic_acdc.main(["--out_root", tree, "--pids", *TEST_LIST])
    for seed in args.seeds:
        row = run_seed(seed, tree, args)
        print(json.dumps(row), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    with open(args.out) as f:
        rows = [json.loads(line) for line in f]
    stats = band(rows)
    print(f"seeds {[r['seed'] for r in rows]}: " + ", ".join(
        f"{k} {m:.4f} +- {s:.4f}" for k, (m, s) in stats.items()), flush=True)
    return stats


if __name__ == "__main__":
    main()
