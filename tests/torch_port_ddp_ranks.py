"""Rank functions of the port's data-parallel tests (not a test module).

``parallel.mesh.launch`` starts each rank in a fresh interpreter and finds
these functions by name; this module imports the port alone (no JAX), so a
rank starts in a few seconds.  Each function takes the rank's mesh first
and returns plain host values, which the parent holds against JAX's
sharded step and against the port's one-process step.
"""

import os

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    ExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
    CooperativeBatcher,
    EvalBatcher,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel.mesh import (
    shard_train_step,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    shard_draws,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.driver import (
    GeneratorDraws,
    eval_dispatch,
    train_network,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
    CooperativePredictor,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import checkpoint

POLICY = "ACDC_affine_elastic_intensity"


def step_record(trainer, metrics):
    """What a step left: its metrics, every module's state dict, Adam's
    moments, each parameter's gradient and each code's (branch, mask,
    saliency), as copies on the host."""
    mu, nu = trainer.adam_moments()
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "state": {n: {k: v.detach().cpu().clone() for k, v in getattr(trainer.model, n)
                      .state_dict().items()} for n in MODULE_NAMES},
        "mu": {n: {k: v.cpu().clone() for k, v in d.items()} for n, d in mu.items()},
        "nu": {n: {k: v.cpu().clone() for k, v in d.items()} for n, d in nu.items()},
        "grads": {n: {k: p.grad.cpu().clone() for k, p in getattr(trainer.model, n)
                      .named_parameters()} for n in MODULE_NAMES},
        "generation": {key: (g.branch, g.mask.cpu().clone(),
                             None if g.saliency is None else g.saliency.cpu().clone())
                       for key, g in trainer.generation.items()},
    }


def one_step(lda, state_dicts, image, label, draws, mesh=None, device="cpu", **trainer_kw):
    """One step of a fresh trainer on ``device`` (the mesh's, under one)
    loaded with ``state_dicts``, on the global batch and draws, or on this
    rank's rows of them under ``mesh``: its :func:`step_record`."""
    device = device if mesh is None else mesh.device
    trainer = CooperativeTrainer(lda, device=device, **trainer_kw)
    trainer.model.load_state_dicts(state_dicts)
    if mesh is not None:
        shard_train_step(trainer, mesh)
        image, label, draws = mesh.rows(image), mesh.rows(label), shard_draws(draws, mesh)
    metrics = trainer.train_step(image.to(device), label.to(device), draws.to(device))
    return step_record(trainer, metrics)


def step_cases(mesh, lda, state_dicts, image, label, cases, trainer_kw):
    """One data-parallel step for each draws of ``cases``, each from
    ``state_dicts``."""
    torch.set_num_threads(1)
    return [one_step(lda, state_dicts, image, label, d, mesh, **trainer_kw) for d in cases]


def eval_case(mesh, state_dicts, length, batch_size, hw):
    """Validation of ``length`` phantoms at ``batch_size`` over ``mesh``:
    (global real counts, this rank's counts, the summed confusion)."""
    torch.set_num_threads(1)
    model = CooperativePredictor(device="cpu")
    model.load_state_dicts(state_dicts)
    batcher = EvalBatcher(SyntheticSegDataset(length=length, pad_size=hw), batch_size,
                          pad_hw=hw, crop_hw=hw, device="cpu", mesh=mesh)
    batches = list(batcher.epoch())
    confusion = eval_dispatch(model, batcher, n_iter=2).confusion_matrix
    return ([b["real_count"] for b in batches], [b["local_count"] for b in batches],
            confusion.clone())


def train_batches(mesh, length, batch_size, pad_hw, crop_hw, seed):
    """One epoch of ``CooperativeBatcher`` batches (``keep_orig``) over
    ``mesh``, or the global ones with ``mesh`` None."""
    torch.set_num_threads(1)
    batcher = CooperativeBatcher(SyntheticSegDataset(length=length, pad_size=pad_hw),
                                 batch_size, POLICY, pad_hw, crop_hw, seed=seed, device="cpu",
                                 mesh=mesh)
    source = GeneratorDraws(seed + 1)
    return [{k: v.clone() for k, v in b.items()}
            for b in batcher.epoch(lambda policy, n, pad: source.augment(0, policy, n, pad))]


def all_case(mesh, step_args, eval_args, batch_args):
    """:func:`step_cases`, :func:`eval_case` and :func:`train_batches` in
    one launch of the ranks."""
    return (step_cases(mesh, *step_args), eval_case(mesh, *eval_args),
            train_batches(mesh, *batch_args))


def whole_state(trainer):
    """Every module's state dict and Adam's state per parameter, cloned."""
    modules = {n: {k: v.clone() for k, v in getattr(trainer.model, n).state_dict().items()}
               for n in MODULE_NAMES}
    adam = [{k: v.clone() for k, v in trainer.optimizer.state[p].items()}
            for p in trainer.model.parameters()]
    return modules, adam


def checkpoint_case(mesh, lda, sd, directory, image, label, draws, single):
    """A rank's part of a data-parallel step from ``sd``, rank 0 writing
    its whole-state checkpoint under ``directory``; then a restore of the
    one-process checkpoint under ``single``.  Returns the rank's whole
    state after each."""
    torch.set_num_threads(1)
    trainer = CooperativeTrainer(lda, device="cpu")
    trainer.model.load_state_dicts(sd)
    shard_train_step(trainer, mesh)
    trainer.train_step(mesh.rows(image), mesh.rows(label), shard_draws(draws, mesh))
    if mesh.rank == 0:
        checkpoint.save_checkpoint(directory, trainer, step=0)
    mesh.barrier()
    fresh = CooperativeTrainer(lda, device="cpu", seed=mesh.rank + 5)
    return whole_state(trainer), whole_state(checkpoint.restore_checkpoint(single, fresh))


class Recorded:
    """A draw source (``train/driver.py``) that hands out recorded
    augmentation and step draws in call order."""

    def __init__(self, augments, steps):
        self.augments, self.steps = list(augments), list(steps)

    def augment(self, epoch, policy, n, pad_hw):
        return self.augments.pop(0)

    def step(self, n, hw, latent_da, **kw):
        return self.steps.pop(0)


def run_record(trainer, result):
    """What a ``train_network`` run left on this rank, on the host: each
    epoch's losses, branches, confusion matrix and scores, the best
    epoch, the files written, the graphs' counts, every module's state
    dict and Adam's state per parameter."""
    graphs = result.graphs
    return {
        "epochs": [(e.epoch, e.losses, e.branches, e.confusion, e.iou, e.acc)
                   for e in result.epochs],
        "best": (result.best_epoch, result.best_score, result.last_epoch),
        "written": result.written,
        "graphs": None if graphs is None else (graphs.eager_steps, sum(graphs.replays.values())),
        "state": whole_state(trainer),
    }


def epoch_runs(mesh, cfg_dict, state_dicts, root, runs, draws=None):
    """``train_network`` over ``mesh`` once for each ``(tag, keywords)`` of
    ``runs`` (``fused_epoch``, ``pipeline_epoch``), each from
    ``state_dicts`` on the configuration ``cfg_dict``'s phantoms (training
    seed 0, validation seed 1), into ``root/tag``, on the recorded
    ``draws`` ((augment, step) lists) or the loop's own: each run's
    :func:`run_record`."""
    torch.set_num_threads(1)
    cfg = ExperimentConfig.from_dict(cfg_dict)
    data = cfg.data
    out = {}
    for tag, kw in runs:
        trainer = CooperativeTrainer(cfg.latent_DA if cfg.learning.latent_DA else None,
                                     learning_rate=cfg.learning.lr, device=mesh.device)
        trainer.model.load_state_dicts(state_dicts)
        sets = [SyntheticSegDataset(length=n, pad_size=data.pad_hw, seed=s)
                for n, s in ((cfg_dict["n_train"], 0), (cfg_dict["n_val"], 1))]
        result = train_network(tag, *sets, trainer, cfg, os.path.join(root, tag, "model"),
                               log_dir=os.path.join(root, tag, "log"), log=True, seed=40,
                               draws=None if draws is None else Recorded(*draws), mesh=mesh,
                               **kw)
        out[tag] = run_record(trainer, result)
    return out


def epoch_cases(mesh, cases):
    """:func:`epoch_runs` for each argument tuple of ``cases``, in one
    start of the ranks."""
    return [epoch_runs(mesh, *case) for case in cases]


def captured_sharded_steps(mesh, lda, n_steps, pad_hw, crop_hw, batch):
    """On a card a rank (NCCL): ``n_steps`` steps of batch ``batch`` under
    ``lda`` (one branch tuple), replayed from a CUDA graph of the sharded
    step after the first (eager, then captured), each against a twin
    capturable trainer's eager sharded step on the same rows and draws.
    Returns (the backend, each step's metrics equal, the states equal, the
    graph's collectives at capture, the twin's collectives a step,
    replays)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
        stage_draws,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        StepGraphs,
    )

    batcher = CooperativeBatcher(SyntheticSegDataset(length=4, pad_size=pad_hw, seed=0), batch,
                                 POLICY, pad_hw, crop_hw, device=mesh.device, mesh=mesh)
    trainers = [CooperativeTrainer(lda, learning_rate=1e-3, compute_dtype=torch.bfloat16,
                                   device=mesh.device, seed=0, capturable=True)
                for _ in range(2)]
    graphs = []
    for t in trainers:
        shard_train_step(t, mesh)
        graphs.append(StepGraphs(t, batcher.pipeline_idx, *batcher.device_dataset(), mesh=mesh))
    staged = stage_draws(GeneratorDraws(1), [0], n_steps, batcher.policy, batcher.raw_bs, pad_hw,
                         batcher.step_batch, crop_hw, lda, mesh.device, mesh=mesh)
    idx = torch.from_numpy(batcher.epoch_index_matrix()[0]).to(mesh.device)
    got = torch.empty((n_steps, 10), device=mesh.device)
    equal, calls = [], []
    for k, s in enumerate(staged.steps):
        graphs[0].run(idx, s, got[k])
        before = mesh.calls
        want = graphs[1].body(idx, s.augment, s.step)
        calls.append(mesh.calls - before)
        equal.append(bool(torch.equal(got[k], want)))
    (m0, a0), (m1, a1) = whole_state(trainers[0]), whole_state(trainers[1])
    same = (all(torch.equal(m0[n][k], m1[n][k]) for n in m0 for k in m0[n])
            and all(torch.equal(x[k], y[k]) for x, y in zip(a0, a1) for k in x))
    return (mesh.backend, equal, same, [c.collectives for c in graphs[0].graphs.values()], calls,
            sum(graphs[0].replays.values()))
