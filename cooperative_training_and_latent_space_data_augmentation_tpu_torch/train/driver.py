"""The cooperative training loop.

Counterpart of the JAX package's ``train/driver.py`` (``experiment_dirs``,
``eval_dispatch``, ``eval_model``, ``train_network``'s per-batch path), the
re-design of the reference's ``train_adv_supervised_segmentation_triplet.py``
(train_network:81-288): per-batch on-device augmentation, the cooperative
train step, validation with ``predict(n_iter=2)`` every epoch, Mean-IoU
model selection, best and periodic checkpoints, the ``max_iteration`` stop,
crash and ``KeyboardInterrupt`` snapshots, and resuming from a snapshot.
The JAX package's fused epoch, K-epoch window, pipelined fetch, device mesh
and orbax checkpoints are left out.

Random draws come from a draw source, where the JAX package splits keys:
an object with ``augment(epoch, policy, n, pad_hw)``, the next batch's
:class:`..ops.augment.AugmentDraws` for ``n`` raw samples of ``epoch``, and
``step(n, hw, latent_da)``, the next step's :class:`..train.draws.
StepDraws`.  The default, :class:`GeneratorDraws`, draws both from one CPU
``torch.Generator`` seeded ``seed + 1``; the loop moves the draws to the
trainer's device.  (The JAX package splits an epoch key off ``PRNGKey(seed
+ 1)`` each epoch and each batch's key off it, and each step's key off
``PRNGKey(seed + 1)`` itself; a source that replays those keys gives the
port JAX's draws.)

Nothing is read back to the host inside an epoch: each step's losses stay
the 0-d device tensors ``train_step`` returns until one stack and ``.cpu()``
at the epoch's end, which also makes ``time/train_epoch_sec`` include the
device's work.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from functools import partial
from os.path import join
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    ExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
    CooperativeBatcher,
    EvalBatcher,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.metrics import (
    RunningScore,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
    draw_augment,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
    load_snapshot,
    save_model,
    save_snapshot,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.logging import (
    ScalarLogger,
)

LOSS_KEYS = (  # train...py:164-166
    "loss/standard/total", "loss/standard/seg", "loss/standard/image",
    "loss/standard/shape", "loss/standard/gt_shape",
    "loss/hard/total", "loss/hard/seg", "loss/hard/image", "loss/hard/shape",
)


def experiment_dirs(save_dir: str, dataset_name: str, data_setting: str,
                    num_classes: int, config_name: str, cval: int) -> Tuple[str, str]:
    """The experiment's (log_dir, model_dir), made if missing
    (train...py:426-438):
    {save_dir}/train_{ds}_{setting}_n_cls_{k}/{config_name}/{cval}/{log,model}."""
    root = join(save_dir, f"train_{dataset_name}_{data_setting}_n_cls_{num_classes}",
                config_name, str(cval))
    log_dir, model_dir = join(root, "log"), join(root, "model")
    os.makedirs(log_dir, exist_ok=True)
    os.makedirs(model_dir, exist_ok=True)
    return log_dir, model_dir


class GeneratorDraws:
    """The loop's default draw source: every draw from one CPU
    ``torch.Generator`` seeded ``seed``, in call order."""

    def __init__(self, seed: int):
        self.generator = torch.Generator().manual_seed(seed)

    def augment(self, epoch: int, policy, n: int, pad_hw):
        return draw_augment(self.generator, policy, n, pad_hw)

    def step(self, n: int, hw, latent_da):
        return draw_step(self.generator, n, hw, latent_da)


class _OnDevice:
    """A draw source whose draws are moved to ``device``, counting the host
    seconds spent drawing and moving them."""

    def __init__(self, source, device: torch.device):
        self.source = source
        self.device = device
        self.seconds = 0.0

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args).to(self.device)
        self.seconds += time.perf_counter() - t0
        return out

    def augment(self, epoch, policy, n, pad_hw):
        return self._timed(self.source.augment, epoch, policy, n, pad_hw)

    def step(self, n, hw, latent_da):
        return self._timed(self.source.step, n, hw, latent_da)


def eval_dispatch(model: CooperativePredictor, eval_batcher: EvalBatcher,
                  n_iter: int = 2) -> RunningScore:
    """Run validation: ``predict(n_iter)`` on each batch, argmax, and the
    confusion update of the rows below its ``real_count``, all on the
    device; nothing is read back."""
    running = RunningScore(model.num_classes, eval_batcher.device)
    for batch in eval_batcher.epoch():
        real = batch["real_count"]
        pred = model.predict(batch["image"], n_iter=n_iter).argmax(-1)
        running.update(batch["label"][:real], pred[:real])
    return running


def eval_model(model: CooperativePredictor, eval_batcher: EvalBatcher,
               n_iter: int = 2) -> Tuple[float, float]:
    """Validation with STN refinement: (Mean IoU, mean accuracy)
    (train...py:63-78)."""
    score, _ = eval_dispatch(model, eval_batcher, n_iter).get_scores()
    return float(score["Mean IoU : \t"]), float(score["Mean Acc : \t"])


@dataclass
class EpochRecord:
    """One epoch of the loop: its steps' losses ((steps, len(LOSS_KEYS)),
    float32, in LOSS_KEYS order), the branches each step drew ({"image": b,
    "shape": b} for the codes latent DA perturbs), the validation
    confusion matrix (C, C) int64 and its Mean IoU and accuracy, and host
    seconds: training (to the epoch's read back), validation, and the
    drawing inside training."""

    epoch: int
    losses: np.ndarray
    branches: List[Dict[str, int]]
    confusion: np.ndarray
    iou: float
    acc: float
    train_sec: float
    val_sec: float
    draw_sec: float

    @property
    def steps(self) -> int:
        return self.losses.shape[0]


@dataclass
class TrainResult:
    best_score: float
    best_epoch: int
    last_epoch: int
    epochs: List[EpochRecord] = field(default_factory=list)


def _branches(draws) -> Dict[str, int]:
    return {key: code.branch for key, code in (("image", draws.image), ("shape", draws.shape))
            if code is not None}


def train_network(experiment_name: str, train_set, validate_set, trainer: CooperativeTrainer,
                  cfg: ExperimentConfig, model_dir: str, log_dir: Optional[str] = None,
                  log: bool = False, seed: int = 42, resume_path: Optional[str] = None,
                  max_epochs: Optional[int] = None, draws=None) -> TrainResult:
    """Train ``trainer`` (built by the caller, on its device) on
    ``train_set``, validating on ``validate_set`` every epoch.

    The batch order comes from ``RandomState(seed)``; the draws from
    ``draws`` (default ``GeneratorDraws(seed + 1)``).  The state after an
    epoch whose Mean IoU beats every earlier one is saved to
    ``{model_dir}/best``, and after epoch 0 and every
    ``save_epoch_every_num_epochs``-th epoch to ``{model_dir}/{epoch}``.
    Training stops after ``max_epochs`` (default the configuration's
    ``n_epochs``) or after the step that takes the step count past
    ``max_iteration``.  ``resume_path``: a snapshot to restart from, at its
    epoch.  With ``log``, scalars go to ``{log_dir}/scalars.jsonl`` and
    ``{log_dir}/{experiment_name}.json``."""
    learning, data_cfg = cfg.learning, cfg.data
    start_epoch = load_snapshot(trainer, resume_path) if resume_path else 0
    device = next(trainer.model.parameters()).device
    batcher = CooperativeBatcher(
        train_set, batch_size=learning.batch_size, policy_name=data_cfg.data_aug_policy,
        pad_hw=data_cfg.pad_hw, crop_hw=data_cfg.crop_hw, num_classes=trainer.num_classes,
        keep_orig=data_cfg.keep_orig_image_label_pair_for_training, seed=seed, device=device)
    if len(batcher) == 0:
        raise ValueError("training set is empty (0 batches): check the data root and split; "
                         "refusing to train on nothing")
    eval_batcher = EvalBatcher(validate_set, batch_size=learning.batch_size,
                               pad_hw=data_cfg.pad_hw, crop_hw=data_cfg.crop_hw, device=device)
    source = _OnDevice(GeneratorDraws(seed + 1) if draws is None else draws, device)
    logger = ScalarLogger(log_dir if log else None)
    result = TrainResult(best_score=-1e9, best_epoch=-1, last_epoch=start_epoch)
    i_iter = start_epoch * len(batcher)
    stop_flag = False
    n_epochs = max_epochs if max_epochs is not None else learning.n_epochs
    network = trainer.model.network_type
    try:
        for i_epoch in range(start_epoch, n_epochs):
            if stop_flag:
                break
            result.last_epoch = i_epoch
            t_epoch0, drawn0 = time.perf_counter(), source.seconds
            step_metrics, branches = [], []
            for batch in batcher.epoch(partial(source.augment, i_epoch)):
                if stop_flag:
                    break
                step_draws = source.step(batch["image"].shape[0], data_cfg.crop_hw,
                                         trainer.latent_da)
                step_metrics.append(trainer.train_step(batch["image"], batch["label"],
                                                       step_draws))
                branches.append(_branches(step_draws))
                i_iter += 1
                if i_iter > learning.max_iteration:
                    stop_flag = True
            g_count = len(step_metrics)
            if g_count == 0:
                break
            # the epoch's one read back of its losses
            losses = torch.stack([torch.stack([m[k] for k in LOSS_KEYS])
                                  for m in step_metrics]).cpu().numpy()
            train_sec = time.perf_counter() - t_epoch0
            draw_sec = source.seconds - drawn0
            total = float(losses[:, LOSS_KEYS.index("loss/standard/total")].sum()
                          + losses[:, LOSS_KEYS.index("loss/hard/total")].sum())
            print(f"{experiment_name} network: {network} epoch {i_epoch} training loss iter: "
                  f"{g_count}, total loss: {total / g_count}, train_sec: {train_sec:.2f}",
                  flush=True)
            for j, k in enumerate(LOSS_KEYS):
                logger.add_scalar(k, float(losses[:, j].sum()) / g_count, i_epoch)
            logger.add_scalar("time/train_epoch_sec", train_sec, i_epoch)
            logger.add_scalar("time/draw_epoch_sec", draw_sec, i_epoch)

            # validation and model selection (train...py:249-262)
            t_val0 = time.perf_counter()
            running = eval_dispatch(trainer.model, eval_batcher, n_iter=2)
            score, _ = running.get_scores()
            val_sec = time.perf_counter() - t_val0
            curr_score = float(score["Mean IoU : \t"])
            curr_acc = float(score["Mean Acc : \t"])
            logger.add_scalar("time/val_epoch_sec", val_sec, i_epoch)
            logger.add_scalar("iou/val_iou", curr_score, i_epoch)
            logger.add_scalar("acc/val_acc", curr_acc, i_epoch)
            result.epochs.append(EpochRecord(
                i_epoch, losses, branches, running.confusion_matrix.cpu().numpy(), curr_score,
                curr_acc, train_sec, val_sec, draw_sec))
            if curr_score > result.best_score:
                result.best_score, result.best_epoch = curr_score, i_epoch
                save_model(trainer, model_dir, "best")
            if (i_epoch + 1) % cfg.output.save_epoch_every_num_epochs == 0 or i_epoch == 0:
                save_model(trainer, model_dir, i_epoch)
        if log and log_dir:
            logger.export_scalars_to_json(join(log_dir, experiment_name + ".json"))
    except KeyboardInterrupt:
        print(f"interrupted at epoch {result.last_epoch}; saving snapshot")
        save_snapshot(trainer, model_dir, result.last_epoch)
        raise
    except Exception as e:
        print(f"catch exception at epoch {result.last_epoch}. error: {e}")
        if result.last_epoch > 0:
            save_snapshot(trainer, model_dir, result.last_epoch)
        raise
    finally:
        logger.close()
    return result
