"""Fingerprints of the start of a ``cli.train --synthetic`` run at a seed.

What a run starts from, in a few numbers that two machines can compare:
the initial weights (per module, the float64 sum and the sum of
magnitudes of every parameter), the loop's first batch (its images' sum
and sum of squares, its label counts by class), that batch's augmentation
draws and the first step's draws (the float64 sum of each field, the
branches), and then the loop's own first epochs (each step's nine losses,
the printed total loss and the validation Mean IoU).  Printed as one JSON
object::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.fingerprint \\
        --seed 40 --epochs 1 [--bf16] [--device cpu]

The first batch and draws are made as ``train/driver.py:train_network``
makes them (its batcher, ``GeneratorDraws(seed + 1)``), without training;
the epochs are then ``cli.train``'s own run on the same trainer.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli_train
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
    CooperativeBatcher,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import driver
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
)


def _sum(t: torch.Tensor) -> float:
    return float(t.detach().double().sum())


def weight_sums(model) -> Dict[str, list]:
    """{module: [sum, sum of magnitudes]} over every parameter, float64."""
    out = {}
    for name in MODULE_NAMES:
        ps = [p.detach().double() for p in getattr(model, name).parameters()]
        out[name] = [sum(float(p.sum()) for p in ps), sum(float(p.abs().sum()) for p in ps)]
    return out


def draw_sums(draws) -> Dict[str, object]:
    """The float64 sum of every tensor field of an ``AugmentDraws`` or a
    ``StepDraws`` (nested ``CodeDraws`` by ``code.field``; branches as
    ints; tuples summed)."""
    out = {}
    for f in dataclasses.fields(draws):
        v = getattr(draws, f.name)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            out[f.name] = _sum(v)
        elif isinstance(v, tuple):
            out[f.name] = sum(_sum(t) for t in v)
        elif isinstance(v, list):
            out[f.name] = [_sum(t) for t in v]
        elif dataclasses.is_dataclass(v):
            for k, sub in draw_sums(v).items():
                out[f"{f.name}.{k}"] = sub
        else:
            out[f.name] = v
    return out


def fingerprint(seed: int = 40, epochs: int = 1, bf16: bool = False, device: str = "cuda",
                extra: Sequence[str] = ()) -> Dict[str, object]:
    """The fingerprint of ``cli.train --synthetic --seed seed`` (``extra``:
    more of its flags) on ``device``."""
    with tempfile.TemporaryDirectory() as save_dir:
        args = cli_train.parse_args(
            ["--synthetic", "--seed", str(seed), "--max_epochs", str(epochs), "--device", device,
             "--save_dir", save_dir] + (["--bf16"] if bf16 else []) + list(extra))
        cfg, name = cli_train.load_config(args)
        train_set, val_set = cli_train.build_datasets(cfg, args)
        trainer = cli_train.build_trainer(cfg, args)
        dev = next(trainer.model.parameters()).device
        out: Dict[str, object] = {"seed": seed, "device": str(dev), "bf16": bf16,
                                  "torch": torch.__version__,
                                  "weights": weight_sums(trainer.model)}
        data = cfg.data
        batcher = CooperativeBatcher(
            train_set, batch_size=cfg.learning.batch_size, policy_name=data.data_aug_policy,
            pad_hw=data.pad_hw, crop_hw=data.crop_hw, num_classes=trainer.num_classes,
            keep_orig=data.keep_orig_image_label_pair_for_training, seed=seed, device=dev)
        source = driver.GeneratorDraws(seed + 1)
        drawn = []

        def augment(policy, n, pad_hw):
            drawn.append(source.augment(0, policy, n, pad_hw))
            return drawn[-1].to(dev)

        batch = next(iter(batcher.epoch(augment)))
        step = source.step(batch["image"].shape[0], data.crop_hw, trainer.latent_da)
        image = batch["image"].double()
        out["batch"] = {"image_sum": _sum(image), "image_sq_sum": _sum(image * image),
                        "label_counts": torch.bincount(batch["label"].flatten().long().cpu(),
                                                       minlength=trainer.num_classes).tolist()}
        out["augment_draws"] = draw_sums(drawn[0])
        out["step_draws"] = draw_sums(step)
        _, result = cli_train.run_trainer(args, cfg, name, trainer, train_set, val_set)
        out["epochs"] = [{"losses": rec.losses.astype(np.float64).tolist(),
                          "total": float(rec.losses[:, driver.LOSS_KEYS.index("loss/standard/total")]
                                         .sum() + rec.losses[:, driver.LOSS_KEYS.index(
                                             "loss/hard/total")].sum()) / rec.steps,
                          "iou": rec.iou} for rec in result.epochs]
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    p = argparse.ArgumentParser("fingerprint of a --synthetic run's start (PyTorch port)")
    p.add_argument("--seed", type=int, default=40)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args, extra = p.parse_known_args(argv)
    out = fingerprint(args.seed, args.epochs, args.bf16, args.device, extra)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
