"""Training entry point of the port: ACDC-layout volumes or the
synthetic-phantom protocol.

Counterpart of the JAX package's ``cli/train.py`` (``parse_args``,
``build_datasets``, ``main``), which mirrors the reference's
``python medseg/train_adv_supervised_segmentation_triplet.py
--json_config_path ... --cval ... --data_setting ... --log --seed ...``
(argparse at train...py:292-324)::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.train \\
        --json_config_path configs/ACDC/cooperative_training.json \\
        --root_dir /tmp/synthetic_ACDC --bf16 --save_dir /tmp/runs --log

trains on the ACDC train and validate splits of ``--data_setting`` and
``--cval`` under ``data.root_dir`` (``--root_dir`` overrides it), one
``CardiacACDCDataset`` per frame of ``data.frame``, their file names probed
when the configured pattern matches nothing (``.nii.gz`` or ``.nrrd``);
``--synthetic`` trains on phantoms instead.  It trains on the card
(``--device cuda``, the default) and raises if there is none, unless
``--device cpu`` asks for the CPU.  Checkpoints go under
``{save_dir}/train_{dataset}_{data_setting}_n_cls_{k}/{config}/{cval}/model``
(:func:`..train.driver.experiment_dirs`).  ``--conv_s2`` and ``--conv_nl``
stand for the JAX package's ``PALLAS_CONV_S2=1`` and ``PALLAS_CONV_NL=1``,
``--saliency_bn_update`` for its ``SALIENCY_BN_UPDATE=1``; ``--remat`` is
its ``--remat``.  The configuration's ``network_type`` (the three of
``train.predictor.NETWORK_TYPES``), ``encoder_dropout``,
``decoder_dropout`` and ``separate_training`` reach the trainer as they
reach the JAX package's.

``--fused_epoch`` trains each epoch as the fused epoch (the JAX package's
``FUSED_EPOCH=1``: on the card, replays of CUDA graphs of the
augmentation and the train step, with a ``capturable`` Adam), ``--multi_epoch
E`` adds the K-epoch window of E epochs (``MULTI_EPOCH=E``) and
``--pipeline_epoch`` the pipelined fetch (``PIPELINE_EPOCH=1``); see
``train/driver.py``.  ``--fused_stn`` and ``--fused_ftn`` are the step's
fused pass arms (``FUSED_STN=1``, ``FUSED_FTN=1``; off with layer dropout,
``--fused_ftn`` only with latent DA on the image code, as in the JAX
package), ``--warp`` the augmentation's geometric warp arm
(``composed``, the default; ``two_gather``, ``FUSED_WARP=0``;
``sequential``, ``SEQ_WARP=1``).  Every configuration above runs graphed
(each is held to its eager step on the card); a combination of the three
epoch flags that does not exist is refused at start.  Every step on the
card runs on cuDNN's deterministic algorithms, so a seed's run repeats
bit for bit.

``--n_devices N`` (N > 1) trains data-parallel over N ranks
(``parallel/mesh.py``: one process a rank, the batch sharded, BatchNorm on
the global batch, the gradients all-reduced), on the card unless
``--device cpu`` is given; without a card that is an error, never a quiet
CPU run.  The kernels are built once before the ranks start.  Ranks that
share one card run on gloo; the fused epoch modes run on one device and
are refused.  Every periodic save also writes the trainer's whole state
under ``{model_dir}/orbax`` (``utils/checkpoint.py``; ``--no_orbax``
leaves it out) and ``--resume_orbax`` restarts from the latest, as the
JAX package's flags do::

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.train \
        --json_config_path configs/ACDC/cooperative_training.json --synthetic --bf16 \
        --n_devices 2 --max_epochs 2 --save_dir /tmp/runs
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import List, Optional, Sequence, Tuple

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    ExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.acdc import (
    CardiacACDCDataset,
    probe_format_names,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.base import (
    ConcatDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import WARPS
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.driver import (
    TrainResult,
    check_epoch_modes,
    check_mesh_modes,
    experiment_dirs,
    train_network,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    NETWORK_TYPES,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.seed import set_seed


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
    p.add_argument("--resume_orbax", action="store_true",
                   help="resume from the latest orbax step under "
                        "{model_dir}/orbax instead of a snapshot")
    p.add_argument("--no_orbax", action="store_true",
                   help="skip the orbax train-state checkpoint at periodic "
                        "saves (the per-module and snapshot formats still written)")
    p.add_argument("--root_dir", type=str, default=None,
                   help="override the configuration's data.root_dir")
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
    p.add_argument("--remat", action="store_true",
                   help="rematerialise each module forward in the backward")
    p.add_argument("--saliency_bn_update", action="store_true",
                   help="the saliency forwards track BN running statistics (the reference's)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--fused_epoch", action="store_true",
                   help="each epoch as replays of CUDA graphs of the augmentation and the step")
    p.add_argument("--multi_epoch", type=int, default=0,
                   help="with --fused_epoch: K-epoch windows of this many epochs")
    p.add_argument("--pipeline_epoch", action="store_true",
                   help="with --fused_epoch: read each epoch back after the next is dispatched")
    p.add_argument("--fused_stn", action="store_true",
                   help="the STN passes of a step as one stacked batch")
    p.add_argument("--fused_ftn", action="store_true",
                   help="the standard and hard FTN passes of a step as one stacked batch")
    p.add_argument("--warp", choices=WARPS, default="composed",
                   help="the augmentation's geometric warp arm")
    p.add_argument("--n_devices", type=int, default=None,
                   help="shard the batch over a data-parallel mesh")
    return p.parse_args(argv)


def load_config(args: argparse.Namespace):
    """(configuration, its name): the JSON file's, or the defaults (named
    "default"), with the command line's overrides."""
    path = args.json_config_path
    cfg = ExperimentConfig.from_json(path) if path else ExperimentConfig()
    name = os.path.splitext(os.path.basename(path))[0] if path else "default"
    if args.root_dir is not None:
        cfg.data.root_dir = args.root_dir
    if args.batch_size is not None:
        cfg.learning.batch_size = args.batch_size
    if args.lr is not None:
        cfg.learning.lr = args.lr
    return cfg, name


def build_datasets(cfg: ExperimentConfig, args: argparse.Namespace):
    """(train, validation) datasets: the ACDC train and validate splits, a
    ``CardiacACDCDataset`` per frame joined by ``ConcatDataset``, or with
    ``--synthetic`` phantoms from seeds 0 and 1."""
    if args.synthetic:
        train = SyntheticSegDataset(length=args.synthetic_train_length,
                                    pad_size=cfg.data.pad_hw,
                                    num_classes=cfg.data.num_classes, seed=0)
        val = SyntheticSegDataset(length=args.synthetic_val_length, pad_size=cfg.data.pad_hw,
                                  num_classes=cfg.data.num_classes, seed=1)
        return train, val
    data = cfg.data
    img_fmt, lbl_fmt = data.image_format_name, data.label_format_name
    # the reference's configs say .nii.gz, its own preprocessor writes
    # .nrrd: probe the tree when the configured pattern matches nothing
    if not glob.glob(os.path.join(data.root_dir,
                                  img_fmt.format(p_id="*", frame=data.frame[0]))):
        img_fmt, lbl_fmt = probe_format_names(data.root_dir, frame=data.frame[0])
    sets = {"train": [], "validate": []}
    for split, per_frame in sets.items():
        for frame in data.frame:
            per_frame.append(CardiacACDCDataset(
                root_dir=data.root_dir, frame=frame, split=split,
                data_setting=args.data_setting, cval=args.cval, image_format_name=img_fmt,
                label_format_name=lbl_fmt, pad_size=data.pad_hw, num_classes=data.num_classes,
                myocardium_only=data.myocardium_only,
                right_ventricle_only=data.right_ventricle_only, use_cache=data.use_cache,
                seed=args.seed))
    train, val = ConcatDataset(sets["train"]), ConcatDataset(sets["validate"])
    if len(train) == 0:
        raise FileNotFoundError(f"no ACDC training volumes of data_setting {args.data_setting} "
                                f"cval {args.cval} under {data.root_dir!r}; pass --root_dir "
                                f"or --synthetic")
    return train, val


def _check_device(args: argparse.Namespace) -> None:
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device; pass --device cpu to "
                           f"train on the CPU")


def build_trainer(cfg: ExperimentConfig, args: argparse.Namespace,
                  device=None) -> CooperativeTrainer:
    """The cooperative trainer of the configuration on ``device`` (default
    ``args.device``), weights drawn from ``args.seed``."""
    model, learning = cfg.segmentation_model, cfg.learning
    if model.network_type not in NETWORK_TYPES:
        raise ValueError(f"network_type {model.network_type!r}: not one of {NETWORK_TYPES}")
    _check_device(args)
    return CooperativeTrainer(
        cfg.latent_DA if learning.latent_DA else None,
        input_noise_std=learning.input_noise_std, learning_rate=learning.lr,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        device=args.device if device is None else device,
        seed=args.seed, image_ch=model.image_ch, num_classes=cfg.data.num_classes,
        conv_s2=args.conv_s2, conv_nl=args.conv_nl, network_type=model.network_type,
        encoder_dropout=model.encoder_dropout, decoder_dropout=model.decoder_dropout,
        separate_training=learning.separate_training, remat=args.remat,
        saliency_bn_update=args.saliency_bn_update,
        capturable=args.fused_epoch and args.device != "cpu", fused_stn=args.fused_stn,
        fused_ftn=args.fused_ftn)


def n_ranks(args: argparse.Namespace) -> int:
    return max(1, args.n_devices or 1)


def run(args: argparse.Namespace, cfg: ExperimentConfig,
        config_name: str) -> Tuple[Optional[CooperativeTrainer], TrainResult]:
    """Build the datasets and the trainer and train: (trainer, result);
    an epoch-mode combination that does not exist is refused first.  Over
    ``--n_devices`` ranks: (None, rank 0's result), see :func:`run_ranks`."""
    check_epoch_modes(args.fused_epoch, args.multi_epoch, args.pipeline_epoch)
    check_mesh_modes(n_ranks(args), args.fused_epoch)
    if n_ranks(args) > 1:
        return None, run_ranks(args, cfg, config_name)[0]
    train_set, val_set = build_datasets(cfg, args)
    return run_trainer(args, cfg, config_name, build_trainer(cfg, args), train_set, val_set)


def run_ranks(args: argparse.Namespace, cfg: ExperimentConfig,
              config_name: str) -> List[TrainResult]:
    """Train over ``--n_devices`` ranks on ``args.device`` (the kernels
    built first, once, on the card): each rank's result, in rank order."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel.mesh import (
        launch,
    )

    check_epoch_modes(args.fused_epoch, args.multi_epoch, args.pipeline_epoch)
    check_mesh_modes(n_ranks(args), args.fused_epoch)
    _check_device(args)
    if args.device != "cpu":
        from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels

        kernels.build()
    return launch(train_rank, n_ranks(args), args.device, args=(args, cfg, config_name))


def train_rank(mesh, args: argparse.Namespace, cfg: ExperimentConfig,
               config_name: str) -> TrainResult:
    """One rank of :func:`run_ranks`: its trainer on its device, trained
    over ``mesh``."""
    set_seed(args.seed)
    train_set, val_set = build_datasets(cfg, args)
    trainer = build_trainer(cfg, args, device=mesh.device)
    return run_trainer(args, cfg, config_name, trainer, train_set, val_set, mesh=mesh)[1]


def run_trainer(args: argparse.Namespace, cfg: ExperimentConfig, config_name: str,
                trainer: CooperativeTrainer, train_set, val_set,
                mesh=None) -> Tuple[CooperativeTrainer, TrainResult]:
    """Train ``trainer`` on the datasets as :func:`run` does (over
    ``mesh``, one rank's part)."""
    log_dir, model_dir = experiment_dirs(args.save_dir, cfg.data.dataset_name,
                                         args.data_setting, cfg.data.num_classes,
                                         config_name, args.cval)
    result = train_network(
        experiment_name=f"{config_name}_cv{args.cval}", train_set=train_set,
        validate_set=val_set, trainer=trainer, cfg=cfg, model_dir=model_dir, log_dir=log_dir,
        log=args.log, seed=args.seed, resume_path=args.resume_path,
        max_epochs=args.max_epochs, fused_epoch=args.fused_epoch,
        multi_epoch=args.multi_epoch, pipeline_epoch=args.pipeline_epoch, warp=args.warp,
        mesh=mesh, use_orbax=not args.no_orbax, resume_orbax=args.resume_orbax)
    if mesh is None or mesh.rank == 0:
        print(f"done: best val Mean IoU {result.best_score:.4f} at epoch {result.best_epoch} "
              f"(last epoch {result.last_epoch})")
    return trainer, result


def main(argv: Optional[Sequence[str]] = None
         ) -> Tuple[Optional[CooperativeTrainer], TrainResult]:
    args = parse_args(argv)
    set_seed(args.seed)
    cfg, name = load_config(args)
    return run(args, cfg, name)


if __name__ == "__main__":
    main()
