"""The cooperative training loop.

Counterpart of the JAX package's ``train/driver.py`` (``experiment_dirs``,
``eval_dispatch``, ``eval_model``, ``train_network``'s per-batch path), the
re-design of the reference's ``train_adv_supervised_segmentation_triplet.py``
(train_network:81-288): per-batch on-device augmentation, the cooperative
train step, validation with ``predict(n_iter=2)`` every epoch, Mean-IoU
model selection, best and periodic checkpoints, the ``max_iteration`` stop,
crash and ``KeyboardInterrupt`` snapshots, and resuming from a snapshot;
and its three other epoch modes (``train_network``'s ``fused_epoch``,
``multi_epoch`` and ``pipeline_epoch``, the JAX package's ``FUSED_EPOCH``,
``MULTI_EPOCH`` and ``PIPELINE_EPOCH``):

* the fused epoch: the epoch's draws staged on the device up front
  (``train/draws.py:stage_draws``), then every (gather + augment + train
  step) of the epoch replayed from CUDA graphs (``train/graphs.py``) with
  no read back, then validation as one graph replay;
* the K-epoch window (``train/multi_epoch.py``): E fused epochs, each
  followed by validation, Mean IoU and best-model selection on the device,
  one read back a window; epoch 0 never runs in a window, a window never
  straddles a periodic checkpoint and runs only while ``max_iteration``
  leaves room for all its steps (else the epoch runs fused on its own);
* the pipelined fetch: epoch k's results and state are copied to pinned
  host memory by copies queued at its end, and read after epoch k+1 is
  dispatched, so the host's reading, logging and checkpointing of epoch k
  and its staging of epoch k+2 overlap the device's epoch k+1.

All three give the streaming loop's numbers: the same batch orders, the
same draws in the same order, the same ops.  On the CPU (the tests) the
graphs' bodies run uncaptured.

Data-parallel training (``train_network(mesh=)``, the JAX package's
``mesh``; ``parallel/mesh.py``): the streaming loop on each rank of the
mesh, the batch and each step's draws the global ones' rows for the rank
(``CooperativeBatcher(mesh=)``, ``draws.shard_draws``), the trainer put
in data-parallel mode (``shard_train_step``), validation on each rank's
rows with the confusion matrices summed over the ranks, so that every
rank logs the same losses and makes the same Mean-IoU decision.  Rank 0
alone writes (checkpoints, snapshots, scalars), and the ranks meet at a
barrier after each epoch's writes.  The three fused epoch modes refuse a
mesh: they replay CUDA graphs, and the gloo collectives that let ranks
share one card cannot be captured.

Whole-state checkpoints (``use_orbax``, the JAX package's orbax
checkpoints, in the port's own format, ``utils/checkpoint.py``): the
trainer's whole state under ``{model_dir}/orbax`` at every periodic
save; ``resume_orbax`` restarts from the latest one, at its epoch + 1.

Random draws come from a draw source, where the JAX package splits keys:
an object with ``augment(epoch, policy, n, pad_hw)``, the next batch's
:class:`..ops.augment.AugmentDraws` for ``n`` raw samples of ``epoch``, and
``step(n, hw, latent_da, **kw)``, the next step's :class:`..train.draws.
StepDraws` (``kw``: the trainer's ``draw_kwargs()``, empty on the main
path).  The default, :class:`GeneratorDraws`, draws both from one CPU
``torch.Generator`` seeded ``seed + 1``; the loop moves the draws to the
trainer's device.  (The JAX package splits an epoch key off ``PRNGKey(seed
+ 1)`` each epoch and each batch's key off it, and each step's key off
``PRNGKey(seed + 1)`` itself; a source that replays those keys gives the
port JAX's draws.)

Nothing is read back to the host inside an epoch: each step's losses stay
the 0-d device tensors ``train_step`` returns until one stack and ``.cpu()``
at the epoch's end, which also makes ``time/train_epoch_sec`` include the
device's work.  (In a window, ``time/train_epoch_sec`` is the window's
seconds over E and ``time/val_epoch_sec`` 0: validation runs inside it.)
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
    scores_from_confusion,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
    draw_augment,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel.mesh import (
    shard_train_step,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
    load_snapshot,
    save_model,
    save_snapshot,
    save_state_dicts,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    METRIC_KEYS,
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
    shard_draws,
    stage_draws,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
    ValidationGraph,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.multi_epoch import (
    WindowRunner,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
    CooperativePredictor,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.logging import (
    ScalarLogger,
)

LOSS_KEYS = METRIC_KEYS[:-1]  # train...py:164-166


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

    def step(self, n: int, hw, latent_da, **kw):
        return draw_step(self.generator, n, hw, latent_da, **kw)


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

    def step(self, n, hw, latent_da, **kw):
        return self._timed(partial(self.source.step, **kw), n, hw, latent_da)


def eval_dispatch(model: CooperativePredictor, eval_batcher: EvalBatcher,
                  n_iter: int = 2) -> RunningScore:
    """Run validation: each batch through
    ``CooperativePredictor.validation_confusion`` (``predict(n_iter)``, the
    argmax and the confusion update of the rows below its ``real_count``,
    the body the fused paths capture), all on the device; nothing is read
    back.  Under the batcher's mesh, each rank's real rows, the confusion
    matrix summed over the ranks."""
    running = RunningScore(model.num_classes, eval_batcher.device)
    for batch in eval_batcher.epoch():
        real = torch.full((1,), batch["local_count"], device=eval_batcher.device)
        running.confusion_matrix = running.confusion_matrix + model.validation_confusion(
            batch["image"][None], batch["label"][None], real, n_iter)
    if eval_batcher.mesh is not None:  # every rank's rows, summed
        eval_batcher.mesh.all_reduce_(running.confusion_matrix)
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
    """What a run ended with; ``graphs`` and ``validation`` are the fused
    paths' ``train/graphs.py:StepGraphs`` and ``ValidationGraph`` (None on
    the streaming path), whose captures and replays a caller can count;
    ``written``, the files this process wrote (checkpoints, snapshots,
    logs), in order."""

    best_score: float
    best_epoch: int
    last_epoch: int
    epochs: List[EpochRecord] = field(default_factory=list)
    graphs: Optional[object] = None
    validation: Optional[object] = None
    written: List[str] = field(default_factory=list)


def _branches(draws) -> Dict[str, int]:
    return {key: code.branch for key, code in (("image", draws.image), ("shape", draws.shape))
            if code is not None}


def check_epoch_modes(fused_epoch: bool, multi_epoch: int, pipeline_epoch: bool) -> None:
    """Refuse a combination of the epoch modes that does not exist:
    ``multi_epoch`` (above 1) and ``pipeline_epoch`` are arms of the fused
    epoch, and a window reads back once a window, so it has no pipelined
    fetch (the JAX package ignores ``MULTI_EPOCH`` under ``PIPELINE_EPOCH``;
    the port says so instead)."""
    if multi_epoch < 0:
        raise ValueError(f"multi_epoch {multi_epoch}: give 0 (no window) or E > 1")
    if (multi_epoch > 1 or pipeline_epoch) and not fused_epoch:
        raise ValueError("--multi_epoch and --pipeline_epoch run on the fused epoch: add "
                         "--fused_epoch")
    if multi_epoch > 1 and pipeline_epoch:
        raise ValueError("--multi_epoch reads back once a window and has no pipelined fetch: "
                         "give --multi_epoch or --pipeline_epoch, not both")


def check_mesh_modes(n_ranks: int, fused_epoch: bool) -> None:
    """Refuse the fused epoch (and so its window and pipelined fetch) over
    more than one rank: it replays CUDA graphs of the step, and the step's
    collectives cannot be captured under gloo, the backend that lets ranks
    share one card.  A captured sharded step needs NCCL across cards of
    their own."""
    if n_ranks > 1 and fused_epoch:
        raise ValueError(f"--fused_epoch (with --multi_epoch, --pipeline_epoch) runs on one "
                         f"device: its CUDA graphs cannot capture the {n_ranks} ranks' gloo "
                         f"collectives; train over ranks without it")


def train_network(experiment_name: str, train_set, validate_set, trainer: CooperativeTrainer,
                  cfg: ExperimentConfig, model_dir: str, log_dir: Optional[str] = None,
                  log: bool = False, seed: int = 42, resume_path: Optional[str] = None,
                  max_epochs: Optional[int] = None, draws=None, fused_epoch: bool = False,
                  multi_epoch: int = 0, pipeline_epoch: bool = False,
                  warp: str = "composed", mesh=None, use_orbax: bool = True,
                  resume_orbax: bool = False) -> TrainResult:
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
    ``{log_dir}/{experiment_name}.json``.

    ``fused_epoch``: each epoch as the fused epoch (CUDA graphs on the card:
    the trainer must be ``capturable``; the dataset must fit on the
    device); with ``multi_epoch`` E > 1, epochs after the first in K-epoch
    windows of E; with ``pipeline_epoch``, each epoch's results read back
    after the next epoch is dispatched (see the module docstring).  ``warp``:
    the augmentation's geometric warp arm (``ops/augment.py:WARPS``).

    ``mesh``: train data-parallel over its ranks (every rank calls this
    with its own trainer; see the module docstring); the batch size must
    divide over them (the batchers refuse it otherwise).  ``use_orbax``: the trainer's whole state also goes
    to ``{model_dir}/orbax`` at every periodic save (not under
    ``pipeline_epoch``, whose fetch holds the modules but not Adam's
    state); ``resume_orbax``: restart from its latest step at that step +
    1 (``FileNotFoundError`` if there is none), in place of
    ``resume_path``.  Neither restores the draw source's or the batch
    order's position: a resumed run draws from ``seed`` anew, as the JAX
    package's does."""
    check_epoch_modes(fused_epoch, multi_epoch, pipeline_epoch)
    check_mesh_modes(1 if mesh is None else mesh.size, fused_epoch)
    learning, data_cfg = cfg.learning, cfg.data
    writer = mesh is None or mesh.rank == 0
    orbax_dir = join(model_dir, "orbax")
    if resume_orbax:
        step = latest_step(orbax_dir)
        if step is None:
            raise FileNotFoundError(f"resume_orbax: no checkpoints in {orbax_dir}")
        restore_checkpoint(orbax_dir, trainer, step=step)
        start_epoch = step + 1
    else:
        start_epoch = load_snapshot(trainer, resume_path) if resume_path else 0
    if mesh is not None:
        shard_train_step(trainer, mesh)
    device = next(trainer.model.parameters()).device
    batcher = CooperativeBatcher(
        train_set, batch_size=learning.batch_size, policy_name=data_cfg.data_aug_policy,
        pad_hw=data_cfg.pad_hw, crop_hw=data_cfg.crop_hw, num_classes=trainer.num_classes,
        keep_orig=data_cfg.keep_orig_image_label_pair_for_training, seed=seed, device=device,
        warp=warp, mesh=mesh)
    if len(batcher) == 0:
        raise ValueError("training set is empty (0 batches): check the data root and split; "
                         "refusing to train on nothing")
    eval_batcher = EvalBatcher(validate_set, batch_size=learning.batch_size,
                               pad_hw=data_cfg.pad_hw, crop_hw=data_cfg.crop_hw, device=device,
                               mesh=mesh)
    raw_source = GeneratorDraws(seed + 1) if draws is None else draws
    source = _OnDevice(raw_source, device)
    result = TrainResult(best_score=-1e9, best_epoch=-1, last_epoch=start_epoch)
    graphs = validate = window = None
    if fused_epoch:
        graphs = batcher.fused_epoch_runner(trainer)
        validate = ValidationGraph(trainer.model, *eval_batcher.stacked_epoch(),
                                   pool=graphs.pool, stream=graphs.stream)
        result.graphs, result.validation = graphs, validate
        if multi_epoch > 1:
            window = WindowRunner(graphs.run_epoch, validate, trainer.model)
    logger = ScalarLogger(log_dir if log and writer else None)
    if logger.log_dir:
        result.written.append(join(log_dir, "scalars.jsonl"))
    i_iter = start_epoch * len(batcher)
    stop_flag = False
    n_epochs = max_epochs if max_epochs is not None else learning.n_epochs
    network = trainer.model.network_type
    draw_kw = trainer.draw_kwargs()
    period = cfg.output.save_epoch_every_num_epochs
    n_classes = trainer.num_classes

    def stage(epochs, n_steps):
        """The draws of ``n_steps`` steps of each of ``epochs``, staged on
        the device, and the host seconds that took."""
        t0 = time.perf_counter()
        staged = stage_draws(raw_source, epochs, n_steps, batcher.policy, batcher.raw_bs,
                             data_cfg.pad_hw, batcher.step_batch, data_cfg.crop_hw,
                             trainer.latent_da, device, **draw_kw)
        return staged, time.perf_counter() - t0

    def record(i_epoch, losses, branches, confusion, train_sec, val_sec, draw_sec,
               state=None, select=True, note=""):
        """Log one epoch (its (steps, len(LOSS_KEYS)) losses and its
        confusion matrix, on the host); with ``select``, the Mean-IoU
        model selection and the best and periodic checkpoints
        (train...py:195-269), of ``state`` ({module: state_dict}) if given,
        else of the trainer."""
        g_count = losses.shape[0]
        total = float(losses[:, LOSS_KEYS.index("loss/standard/total")].sum()
                      + losses[:, LOSS_KEYS.index("loss/hard/total")].sum())
        if writer:
            print(f"{experiment_name} network: {network} epoch {i_epoch} training loss iter: "
                  f"{g_count}, total loss: {total / g_count}, train_sec: {train_sec:.2f}{note}",
                  flush=True)
        for j, k in enumerate(LOSS_KEYS):
            logger.add_scalar(k, float(losses[:, j].sum()) / g_count, i_epoch)
        logger.add_scalar("time/train_epoch_sec", train_sec, i_epoch)
        logger.add_scalar("time/draw_epoch_sec", draw_sec, i_epoch)
        # validation and model selection (train...py:249-262)
        score, _ = scores_from_confusion(confusion)
        curr_score = float(score["Mean IoU : \t"])
        curr_acc = float(score["Mean Acc : \t"])
        logger.add_scalar("time/val_epoch_sec", val_sec, i_epoch)
        logger.add_scalar("iou/val_iou", curr_score, i_epoch)
        logger.add_scalar("acc/val_acc", curr_acc, i_epoch)
        result.epochs.append(EpochRecord(i_epoch, losses, branches, confusion, curr_score,
                                         curr_acc, train_sec, val_sec, draw_sec))
        if not select:
            return

        def save(tag):
            if not writer:
                return
            if state is None:
                result.written.append(save_model(trainer, model_dir, tag))
            else:
                result.written.append(save_state_dicts(state, model_dir, tag))

        if curr_score > result.best_score:
            result.best_score, result.best_epoch = curr_score, i_epoch
            save("best")
        if (i_epoch + 1) % period == 0 or i_epoch == 0:
            save(i_epoch)
            if use_orbax and state is None and writer:
                result.written.append(save_checkpoint(orbax_dir, trainer, step=i_epoch))
        if mesh is not None:  # the epoch's files are on disk before any rank goes on
            mesh.barrier()

    def consume(i_epoch, fetched, branches, t_epoch0, draw_sec, val_sec):
        """Record a pipelined fused epoch from its fetch (:func:`fetch_to_host`),
        once the fetch has landed."""
        done, (metrics, confusion, state) = fetched
        done()
        train_sec = time.perf_counter() - t_epoch0
        record(i_epoch, metrics.numpy()[:, :len(LOSS_KEYS)], branches, confusion.numpy(),
               train_sec, val_sec, draw_sec, state=state)

    def consume_window(w_start, out, staged, t0, draw_sec):
        """Read back a window's results (its one read back), log each of
        its epochs with host scores recomputed in float64 from the same
        confusion matrices, and write the best checkpoint from the window's
        best buffers and the periodic one at its end."""
        host = {k: out[k].cpu() for k in ("metrics", "confusion", "best_epoch")}
        window_sec = time.perf_counter() - t0
        e_count, k_count = host["metrics"].shape[:2]
        for j in range(e_count):
            record(w_start + j, host["metrics"][j].numpy()[:, :len(LOSS_KEYS)],
                   [s.branches for s in staged.steps[j * k_count:(j + 1) * k_count]],
                   host["confusion"][j].numpy(), window_sec / e_count, 0.0,
                   draw_sec / e_count, select=False, note=f" (window {e_count})")
        best = int(host["best_epoch"])
        if best >= 0:
            result.best_epoch = w_start + best
            result.best_score = result.epochs[best - e_count].iou
            result.written.append(save_state_dicts(out["best"], model_dir, "best"))
        ep_last = w_start + e_count - 1
        if (ep_last + 1) % period == 0:
            result.written.append(save_model(trainer, model_dir, ep_last))
            if use_orbax:
                result.written.append(save_checkpoint(orbax_dir, trainer, step=ep_last))

    pending = None  # the one epoch in flight (pipelined fetch)
    try:
        i_epoch = start_epoch
        while i_epoch < n_epochs and not stop_flag:
            result.last_epoch = i_epoch
            t_epoch0 = time.perf_counter()
            if window is not None and i_epoch > 0:
                nb = len(batcher)
                nxt = (i_epoch // period + 1) * period - 1  # the next periodic checkpoint
                fits = min(multi_epoch, n_epochs - i_epoch, nxt - i_epoch + 1)
                if fits == multi_epoch and learning.max_iteration - i_iter + 1 >= multi_epoch * nb:
                    idx_mats = np.stack([batcher.epoch_index_matrix()
                                         for _ in range(multi_epoch)])
                    staged, draw_sec = stage(range(i_epoch, i_epoch + multi_epoch), nb)
                    out = window(idx_mats, staged.steps, result.best_score)
                    i_iter += multi_epoch * nb
                    stop_flag = i_iter > learning.max_iteration
                    consume_window(i_epoch, out, staged, t_epoch0, draw_sec)
                    result.last_epoch = i_epoch + multi_epoch - 1
                    i_epoch += multi_epoch
                    continue
            if graphs is not None:
                idx_mat = batcher.epoch_index_matrix()
                # the max_iteration stop: after the step that passes the cap
                k_allow = min(len(idx_mat), max(0, learning.max_iteration - i_iter + 1))
                if k_allow == 0:
                    break
                staged, draw_sec = stage([i_epoch], k_allow)
                metrics = graphs.run_epoch(idx_mat[:k_allow], staged.steps)
                i_iter += k_allow
                stop_flag = i_iter > learning.max_iteration
                branches = [s.branches for s in staged.steps]
                confusion = torch.empty((n_classes, n_classes), dtype=torch.int64,
                                        device=device)
                if pipeline_epoch:
                    t_val0 = time.perf_counter()
                    validate(confusion)
                    # queued now, so it waits for this epoch's work and not
                    # for the next epoch's, which is dispatched before it is read
                    fetched = fetch_to_host((metrics, confusion, {
                        name: getattr(trainer.model, name).state_dict()
                        for name in MODULE_NAMES}))
                    entry = (i_epoch, fetched, branches, t_epoch0, draw_sec,
                             time.perf_counter() - t_val0)
                    if pending is not None:
                        consume(*pending)
                    pending = entry
                else:
                    # the epoch's one read back of its losses
                    losses = metrics.cpu().numpy()[:, :len(LOSS_KEYS)]
                    train_sec = time.perf_counter() - t_epoch0
                    t_val0 = time.perf_counter()
                    confusion = validate(confusion).cpu().numpy()
                    record(i_epoch, losses, branches, confusion, train_sec,
                           time.perf_counter() - t_val0, draw_sec)
                i_epoch += 1
                continue
            drawn0 = source.seconds
            step_metrics, branches = [], []
            for batch in batcher.epoch(partial(source.augment, i_epoch)):
                if stop_flag:
                    break
                step_draws = source.step(batcher.step_batch, data_cfg.crop_hw,
                                         trainer.latent_da, **draw_kw)
                step_metrics.append(trainer.train_step(
                    batch["image"], batch["label"],
                    step_draws if mesh is None else shard_draws(step_draws, mesh)))
                branches.append(_branches(step_draws))
                i_iter += 1
                if i_iter > learning.max_iteration:
                    stop_flag = True
            if not step_metrics:
                break
            # the epoch's one read back of its losses
            losses = torch.stack([torch.stack([m[k] for k in LOSS_KEYS])
                                  for m in step_metrics]).cpu().numpy()
            train_sec = time.perf_counter() - t_epoch0
            draw_sec = source.seconds - drawn0
            t_val0 = time.perf_counter()
            confusion = eval_dispatch(trainer.model, eval_batcher, n_iter=2).confusion_matrix
            confusion = confusion.cpu().numpy()
            record(i_epoch, losses, branches, confusion, train_sec,
                   time.perf_counter() - t_val0, draw_sec)
            i_epoch += 1
        if pending is not None:
            consume(*pending)
            pending = None
        if log and log_dir and writer:
            logger.export_scalars_to_json(join(log_dir, experiment_name + ".json"))
            result.written.append(join(log_dir, experiment_name + ".json"))
    except KeyboardInterrupt:
        print(f"interrupted at epoch {result.last_epoch}; saving snapshot")
        _flush_pending(pending, consume)
        if writer:
            save_snapshot(trainer, model_dir, result.last_epoch)
        raise
    except Exception as e:
        print(f"catch exception at epoch {result.last_epoch}. error: {e}")
        _flush_pending(pending, consume)
        if result.last_epoch > 0 and writer:
            save_snapshot(trainer, model_dir, result.last_epoch)
        raise
    finally:
        logger.close()
    return result


def fetch_to_host(tree):
    """Copies on the host of the tensors of ``tree`` (nested tuples and
    dicts), as they stand when the copy is queued: ``(wait, copies)``.
    From the card the copies land in pinned memory without blocking the
    host, and ``wait()`` blocks until they have landed; on the CPU they are
    clones."""
    cuda = []

    def copy(x):
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(copy(v) for v in x)
        if not x.is_cuda:
            return x.detach().clone()
        cuda.append(x)
        return x.detach().to("cpu", non_blocking=True)

    copies = copy(tree)
    if not cuda:
        return (lambda: None), copies
    landed = torch.cuda.Event()
    landed.record(torch.cuda.current_stream(cuda[0].device))
    return landed.synchronize, copies


def _flush_pending(pending, consume) -> None:
    """The crash path's flush of the pipelined epoch in flight: without
    it, an exception while epoch k+1 is dispatched would lose epoch k's
    scalars and a would-be best checkpoint.  Best effort: a failure here
    is printed and must not hide the exception being handled."""
    if pending is None:
        return
    try:
        consume(*pending)
    except Exception as flush_err:  # noqa: BLE001 -- the original exception is re-raised
        print(f"warning: could not flush the pending epoch's results: {flush_err}")
