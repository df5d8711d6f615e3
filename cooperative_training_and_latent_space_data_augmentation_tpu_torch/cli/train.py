"""Training entry point of the port: the synthetic-phantom protocol.

Counterpart of the JAX package's ``cli/train.py`` (``parse_args``,
``build_datasets``, ``main``), which mirrors the reference's
``python medseg/train_adv_supervised_segmentation_triplet.py
--json_config_path ... --cval ... --data_setting ... --log --seed ...``
(argparse at train...py:292-324)::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.train \\
        --json_config_path configs/ACDC/cooperative_training.json --synthetic --bf16 \\
        --max_epochs 5 --save_dir /tmp/runs --log

It trains on the card (``--device cuda``, the default) and raises if there
is none, unless ``--device cpu`` asks for the CPU.  Checkpoints go under
``{save_dir}/train_{dataset}_{data_setting}_n_cls_{k}/{config}/{cval}/model``
(:func:`..train.driver.experiment_dirs`).  ``--conv_s2`` and ``--conv_nl``
stand for the JAX package's ``PALLAS_CONV_S2=1`` and ``PALLAS_CONV_NL=1``.
Only ``--synthetic`` data is supported for training; the port reads ACDC
volumes for the held-out evaluation (:mod:`.test`), but training on their
train and validate splits is not ported yet.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence, Tuple

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    ExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.driver import (
    TrainResult,
    experiment_dirs,
    train_network,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("cooperative training (PyTorch port)")
    p.add_argument("--json_config_path", type=str, default=None)
    p.add_argument("--cval", type=int, default=0)
    p.add_argument("--data_setting", type=str, default="10")
    p.add_argument("--save_dir", type=str, default="saved")
    p.add_argument("--log", action="store_true")
    p.add_argument("--seed", type=int, default=40)
    p.add_argument("--resume_path", type=str, default=None,
                   help="a snapshot ({model_dir}/interrupted/checkpoints/*.pth) to resume")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the synthetic phantom dataset")
    p.add_argument("--synthetic_train_length", type=int, default=20)
    p.add_argument("--synthetic_val_length", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=None,
                   help="override the configuration's batch size")
    p.add_argument("--lr", type=float, default=None,
                   help="override the configuration's learning rate")
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 convs (parameters, norms and losses stay float32)")
    p.add_argument("--conv_s2", action="store_true",
                   help="the encoders' stride-2 downsamples on kernel K4")
    p.add_argument("--conv_nl", action="store_true",
                   help="the residual stages' large-channel convs on kernel K5")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def load_config(args: argparse.Namespace):
    """(configuration, its name): the JSON file's, or the defaults (named
    "default"), with the command line's overrides."""
    path = args.json_config_path
    cfg = ExperimentConfig.from_json(path) if path else ExperimentConfig()
    name = os.path.splitext(os.path.basename(path))[0] if path else "default"
    if args.batch_size is not None:
        cfg.learning.batch_size = args.batch_size
    if args.lr is not None:
        cfg.learning.lr = args.lr
    return cfg, name


def build_datasets(cfg: ExperimentConfig, args: argparse.Namespace):
    """(train, validation) datasets: phantoms from seeds 0 and 1."""
    if not args.synthetic:
        raise NotImplementedError("the port trains on --synthetic data only; training on "
                                  "ACDC volumes is not ported yet")
    train = SyntheticSegDataset(length=args.synthetic_train_length, pad_size=cfg.data.pad_hw,
                                num_classes=cfg.data.num_classes, seed=0)
    val = SyntheticSegDataset(length=args.synthetic_val_length, pad_size=cfg.data.pad_hw,
                              num_classes=cfg.data.num_classes, seed=1)
    return train, val


def build_trainer(cfg: ExperimentConfig, args: argparse.Namespace) -> CooperativeTrainer:
    """The cooperative trainer of the configuration on ``args.device``,
    weights drawn from ``args.seed``."""
    model, learning = cfg.segmentation_model, cfg.learning
    if model.network_type != CooperativePredictor.network_type:
        raise NotImplementedError(f"network_type {model.network_type!r}: the port has "
                                  f"{CooperativePredictor.network_type!r} only")
    if model.encoder_dropout is not None or model.decoder_dropout is not None:
        raise NotImplementedError("layer dropout is not ported")
    if learning.separate_training:
        raise NotImplementedError("separate_training is not ported")
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           f"train on the CPU")
    return CooperativeTrainer(
        cfg.latent_DA if learning.latent_DA else None,
        input_noise_std=learning.input_noise_std, learning_rate=learning.lr,
        compute_dtype=torch.bfloat16 if args.bf16 else None, device=args.device,
        seed=args.seed, image_ch=model.image_ch, num_classes=cfg.data.num_classes,
        conv_s2=args.conv_s2, conv_nl=args.conv_nl)


def run(args: argparse.Namespace, cfg: ExperimentConfig,
        config_name: str) -> Tuple[CooperativeTrainer, TrainResult]:
    """Build the datasets and the trainer and train: (trainer, result)."""
    train_set, val_set = build_datasets(cfg, args)
    trainer = build_trainer(cfg, args)
    log_dir, model_dir = experiment_dirs(args.save_dir, cfg.data.dataset_name,
                                         args.data_setting, cfg.data.num_classes,
                                         config_name, args.cval)
    result = train_network(
        experiment_name=f"{config_name}_cv{args.cval}", train_set=train_set,
        validate_set=val_set, trainer=trainer, cfg=cfg, model_dir=model_dir, log_dir=log_dir,
        log=args.log, seed=args.seed, resume_path=args.resume_path,
        max_epochs=args.max_epochs)
    print(f"done: best val Mean IoU {result.best_score:.4f} at epoch {result.best_epoch} "
          f"(last epoch {result.last_epoch})")
    return trainer, result


def main(argv: Optional[Sequence[str]] = None) -> Tuple[CooperativeTrainer, TrainResult]:
    args = parse_args(argv)
    cfg, name = load_config(args)
    return run(args, cfg, name)


if __name__ == "__main__":
    main()
