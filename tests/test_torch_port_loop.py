"""The port's training loop and its parts against the JAX package's on the
CPU: the phantom datasets, the samplers and batchers, the validation
metric, the configuration, and ``train_network`` itself; then the loop's
own behaviour (the ``max_iteration`` stop, the empty-set error, snapshots,
checkpoints, resuming, the command line).

Small sizes: phantoms padded to 40x40 and cropped to 32x32, batch 4 (2 raw
slices and their originals), 4 training and 2 validation phantoms, 2
epochs, the configuration's policy and latent DA (``mask_type="random"``
on both codes, soft masks).

The whole loop: JAX's ``train_network`` (``use_orbax=False``, its
per-batch path, ``TILED_WARP=0`` as in test_torch_port_augment.py) and the
port's run from the same weights (``torch_port_util.random_variables``,
given to JAX through its ``init_state`` and to the port through
``convert.from_jax``) on JAX's draws, replayed from its key schedule by
:class:`JaxKeys`, at learning rate 0 in both.  At rate 0 the parameters
never move (Adam's update is ``-0 * m / (sqrt(v) + eps)``), so the
checks hold the loop's plumbing tightly: batch order, draws, augmentation,
BN running statistics, the metric, model selection and checkpoints,
without the step's gradient sensitivity at f32 rounding (which
test_torch_port_step.py's docstring measures; the step's own update is
held there).  JAX's PNG dumps of validation images are not ported and are
switched off.  Tolerances, float32 throughout:

- each step's batch: images within ``IMAGE_ATOL`` = 5e-5 on the [0, 1]
  scale and labels equal, except at the pixels ``ops/augment.py:
  unsure_pixels`` marks (a sample coordinate within 1e-3 of the frame's
  edge, or a class score within 1e-3 of 0.5: test_torch_port_augment.py's
  bounds, derived there); the excused pixels are counted and printed
  (measured: images within 3.7e-6, 1 label pixel excused, none differ);
- each step's branches and masks, against JAX's hard-example generation
  recomputed from the state the step started at: equal, or swapped only
  where the two saliencies lie within their f32 difference of the
  threshold (``torch_port_util.check_step_masks``, the step tests' rule);
- each step's nine losses: within ``LOSS_RTOL`` = 1e-4 of their value,
  the step tests' bound (measured: at most 7.5e-6); the four hard losses
  only at steps whose masks equal JAX's, since a swap near the threshold
  changes the hard example (1 of the 4 steps here; its five standard
  losses are held);
- parameters in every checkpoint: equal, bit for bit, to JAX's (neither
  moves at rate 0, and the converters only transpose);
- BN running statistics in the checkpoints after each epoch and in the
  best one: within ``STATS_RTOL`` = 1e-4 of each tensor's largest
  magnitude, the step tests' per-step bound (measured: at most 4.1e-5).
  It holds for any number of steps: a running statistic is a convex
  combination of the batch statistics, so it stays as close as they are
  (hard examples run with the statistics frozen, so a mask swap does not
  reach them);
- each epoch's validation confusion matrix: equal, except that a pixel
  whose two largest JAX class scores lie within twice
  test_torch_port_predict.py's f32 bound on a score (``2e-4 + 4e-6`` of
  the largest score; each of the two may move that far) may move one
  count between two cells (measured: equal); its
  Mean IoU and accuracy are ``scores_from_confusion`` of the port's
  matrix; the best epoch and score: JAX's rule on JAX's scores.
"""

import json
import os
from functools import partial

import jax
import numpy as np
import pytest
import torch
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture
    JaxKeys,
    check_step_masks,
    jax_generation,
    jax_train_state,
    one_torch_thread,
    random_variables,
)

from cooperative_training_and_latent_space_data_augmentation_tpu.config import (
    ExperimentConfig as JaxExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.data import loader as JL
from cooperative_training_and_latent_space_data_augmentation_tpu.data import synthetic as JS
from cooperative_training_and_latent_space_data_augmentation_tpu.eval import metrics as JM
from cooperative_training_and_latent_space_data_augmentation_tpu.parallel.mesh import (
    pad_batch_to_multiple as jax_pad_batch_to_multiple,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.train import driver as JD
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    ExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import loader as L
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.base import (
    ConcatDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import synthetic as S
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval import metrics as M
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import augment as A
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import checkpoint as C
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import driver as D
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAD = (40, 40)
CROP = (32, 32)
BATCH = 4
N_TRAIN, N_VAL = 4, 2
EPOCHS = 2
SEED = 40
POLICY = "ACDC_affine_elastic_intensity"
CFG = {"name": "loop", "data": {"pad_size": [*PAD, 1], "crop_size": [*CROP, 1]},
       "learning": {"batch_size": BATCH, "lr": 0.0},
       "output": {"save_epoch_every_num_epochs": 1}}
IMAGE_ATOL = 5e-5
UNSURE = 1e-3
LOSS_RTOL = 1e-4
STATS_RTOL = 1e-4


# ------------------------------------------------------------------ datasets
@pytest.mark.parametrize("seed,index", [(s, i) for s in (0, 1, 7, 40) for i in (0, 1, 2, 9, 19)])
def test_synthetic_dataset_matches_jax(seed, index):
    """``SyntheticSegDataset`` (and so ``make_phantom``) bit-equal to JAX's
    at 224x224, 20 seeds and indices."""
    got = S.SyntheticSegDataset(length=20, seed=seed)[index]
    want = JS.SyntheticSegDataset(length=20, seed=seed)[index]
    assert got["image"].dtype == want["image"].dtype == np.float32
    assert got["label"].dtype == want["label"].dtype == np.int32
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["label"], want["label"])
    rng = np.random.RandomState(seed * 100003 + index)
    img, lbl = S.make_phantom(rng, (31, 33), 3)
    want_img, want_lbl = JS.make_phantom(np.random.RandomState(seed * 100003 + index),
                                         (31, 33), 3)
    np.testing.assert_array_equal(img, want_img)
    np.testing.assert_array_equal(lbl, want_lbl)


def test_patient_volumes_and_concat_match_jax():
    got = S.SyntheticSegDataset(seed=3, slices_per_patient=4).get_patient_data_for_testing(
        2, crop_size=(48, 40))
    want = JS.SyntheticSegDataset(seed=3, slices_per_patient=4).get_patient_data_for_testing(
        2, crop_size=(48, 40))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    parts = [S.SyntheticSegDataset(length=3, pad_size=PAD, seed=s) for s in (0, 1)]
    both = ConcatDataset(parts)
    assert len(both) == 6 and both.get_patient_num() == 6
    np.testing.assert_array_equal(both[4]["image"], parts[1][1]["image"])
    assert both.get_id(4) == "synthetic_001"
    with pytest.raises(IndexError):
        both[6]


# ------------------------------------------------------------ samplers, metric
@pytest.mark.parametrize("n,bs,shuffle,wrap", [(4, 2, True, True), (5, 2, True, True),
                                               (5, 2, True, False), (3, 5, True, True),
                                               (7, 3, False, False)])
def test_batch_sampler_matches_jax(n, bs, shuffle, wrap):
    got = L.BatchSampler(n, bs, shuffle=shuffle, seed=SEED, wrap=wrap)
    want = JL.BatchSampler(n, bs, shuffle=shuffle, seed=SEED, wrap=wrap)
    assert len(got) == len(want)
    for _ in range(3):
        g, w = list(got.epoch()), list(want.epoch())
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,multiple", [(3, 4), (1, 4), (6, 3), (5, 2)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    batch = {"image": np.arange(n * 2, dtype=np.float32).reshape(n, 2),
             "label": np.arange(n, dtype=np.int32)}
    got, got_real = L.pad_batch_to_multiple(batch, multiple)
    want, want_real = jax_pad_batch_to_multiple(batch, multiple)
    assert got_real == want_real == n
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n_val,batch", [(2, 4), (5, 2), (4, 4)])
def test_eval_batcher_matches_jax(n_val, batch):
    ds = S.SyntheticSegDataset(length=n_val, pad_size=(36, 44), seed=1)
    got = list(L.EvalBatcher(ds, batch, (40, 40), CROP, device="cpu").epoch())
    want = list(JL.EvalBatcher(JS.SyntheticSegDataset(length=n_val, pad_size=(36, 44), seed=1),
                               batch, (40, 40), CROP).epoch())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["real_count"] == w["real_count"]
        assert g["image"].shape == w["image"].shape == (batch, *CROP, 1)
        np.testing.assert_allclose(g["image"].numpy(), np.asarray(w["image"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(g["label"].numpy(), np.asarray(w["label"]))


def test_batchers_cache_on_the_device_or_stream_alike():
    """The device-cached and the streamed (prefetched) paths give the same
    batches on the same draws; the eval batches are cached after a pass."""
    ds = S.SyntheticSegDataset(length=5, pad_size=PAD, seed=2)
    source = D.GeneratorDraws(3)
    drawn = []

    def draws(policy, n, pad_hw):
        drawn.append(source.augment(0, policy, n, pad_hw))
        return drawn[-1]

    cached = L.CooperativeBatcher(ds, BATCH, POLICY, PAD, CROP, seed=1, device="cpu",
                                  device_cache=True)
    streamed = L.CooperativeBatcher(ds, BATCH, POLICY, PAD, CROP, seed=1, device="cpu",
                                    device_cache=False)
    got = list(cached.epoch(draws))
    replay = iter(drawn)
    want = list(streamed.epoch(lambda policy, n, pad_hw: next(replay)))
    assert len(got) == len(want) == len(cached) == 3
    for g, w in zip(got, want):
        assert g["image"].shape == (BATCH, *CROP, 1) and g["label"].dtype == torch.int32
        assert torch.equal(g["image"], w["image"]) and torch.equal(g["label"], w["label"])
    ev = L.EvalBatcher(ds, BATCH, PAD, CROP, device="cpu")
    first, second = list(ev.epoch()), list(ev.epoch())
    assert [b["real_count"] for b in first] == [4, 1]
    assert all(a["image"] is b["image"] for a, b in zip(first, second))


def test_prefetch_raises_the_producers_error():
    def broken():
        yield 1
        raise RuntimeError("collation failed")

    it = L.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="collation failed"):
        next(it)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_running_score_matches_jax(seed):
    """Confusion matrix and scores against JAX's ``RunningScore`` on random
    label maps with true labels outside [0, C) (not counted) and two
    updates."""
    rng = np.random.RandomState(seed)
    got, want = M.RunningScore(4, device="cpu"), JM.RunningScore(4)
    for _ in range(2):
        true = rng.randint(-1, 6, (3, 9, 7)).astype(np.int32)
        pred = rng.randint(0, 4, (3, 9, 7)).astype(np.int32)
        got.update(torch.from_numpy(true), torch.from_numpy(pred))
        want.update(true, pred)
    assert got.confusion_matrix.dtype == torch.int64
    np.testing.assert_array_equal(got.confusion_matrix.numpy(), np.asarray(want.confusion_matrix))
    gs, gi = got.get_scores()
    ws, wi = want.get_scores()
    assert list(gs) == list(ws) == ["Overall Acc: \t", "Mean Acc : \t", "FreqW Acc : \t",
                                    "Mean IoU : \t"]
    np.testing.assert_array_equal([gs[k] for k in gs], [ws[k] for k in ws])
    np.testing.assert_array_equal([gi[k] for k in sorted(gi)], [wi[k] for k in sorted(wi)])
    got.reset()
    assert int(got.confusion_matrix.sum()) == 0


def test_config_reads_the_reference_json():
    path = os.path.join(REPO, "configs", "ACDC", "cooperative_training.json")
    got = ExperimentConfig.from_json(path).to_dict()
    want = JaxExperimentConfig.from_json(path).to_dict()
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    # the parallel section is read, as the JAX package reads it
    again = ExperimentConfig.from_dict({**got, "parallel": {"mesh_shape": [8]}})
    want_again = JaxExperimentConfig.from_dict({**want, "parallel": {"mesh_shape": [8]}})
    assert json.loads(json.dumps(again.to_dict())) == json.loads(
        json.dumps(want_again.to_dict()))
    assert again.to_dict()["parallel"]["mesh_shape"] == [8]


# ------------------------------------------------------------- the whole loop
@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    root = tmp_path_factory.mktemp("loops")
    solver = CooperativeTripletSolver(input_hw=CROP, learning_rate=0.0)
    params, stats = random_variables(solver, seed=0)
    jax_rec = {"before": [], "keys": [], "batches": [], "metrics": [], "confusion": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TILED_WARP", "0")
        mp.setenv("FUSED_EPOCH", "0")
        mp.delenv("PIPELINE_EPOCH", raising=False)
        mp.delenv("MULTI_EPOCH", raising=False)
        mp.setattr(JD, "save_testing_images_results", lambda *a, **k: None)
        mp.setattr(solver, "init_state", lambda key: jax_train_state(solver, params, stats))
        make = solver.make_train_step

        def make_recording(**kw):
            step = make(donate=False, **kw)

            def run(state, batch, key):
                jax_rec["before"].append(jax.device_get((state.params, state.batch_stats)))
                jax_rec["keys"].append(key)
                jax_rec["batches"].append(jax.device_get(batch))
                state, metrics = step(state, batch, key)
                jax_rec["metrics"].append(jax.device_get(metrics))
                return state, metrics
            return run

        mp.setattr(solver, "make_train_step", make_recording)
        make_predict = solver.make_predict
        predicts = []

        def make_predict_recording(**kw):
            predicts.append(make_predict(**kw))
            return predicts[-1]

        mp.setattr(solver, "make_predict", make_predict_recording)
        dispatch = JD.eval_dispatch

        def eval_recording(*args, **kw):
            running, last = dispatch(*args, **kw)
            jax_rec["confusion"].append(np.asarray(running.confusion_matrix))
            return running, last

        mp.setattr(JD, "eval_dispatch", eval_recording)
        jax_state, jax_best, _ = JD.train_network(
            "loop", JS.SyntheticSegDataset(length=N_TRAIN, pad_size=PAD, seed=0),
            JS.SyntheticSegDataset(length=N_VAL, pad_size=PAD, seed=1), solver,
            JaxExperimentConfig.from_dict(CFG), str(root / "jax"), seed=SEED,
            max_epochs=EPOCHS, use_orbax=False)

        cfg = ExperimentConfig.from_dict(CFG)
        trainer = CooperativeTrainer(cfg.latent_DA, learning_rate=0.0, device="cpu")
        trainer.model.load_state_dicts(convert.from_jax(params, stats))
        port_batches, port_generation = [], []
        step = trainer.train_step

        def step_recording(image, label, draws):
            port_batches.append((image.clone(), label.clone()))
            metrics = step(image, label, draws)
            port_generation.append(dict(trainer.generation))
            return metrics

        trainer.train_step = step_recording
        keys = JaxKeys(SEED)
        result = D.train_network(
            "loop", S.SyntheticSegDataset(length=N_TRAIN, pad_size=PAD, seed=0),
            S.SyntheticSegDataset(length=N_VAL, pad_size=PAD, seed=1), trainer, cfg,
            str(root / "port"), seed=SEED, max_epochs=EPOCHS, draws=keys)

    # JAX's hard-example generation at each step (its masks and the code
    # gradients behind their saliencies), from the state the step started at
    lda = JaxExperimentConfig.from_dict(CFG).latent_DA
    gen = jax.jit(lambda p, s, b, k: jax_generation(solver, lda, p, s, b, k))
    masks = [{"draws": draws, "port_generation": generation,
              "gen": jax.device_get(gen(*before, batch, key))}
             for draws, generation, before, key, batch in zip(
                 keys.steps, port_generation, jax_rec["before"], jax_rec["keys"],
                 jax_rec["batches"])]

    def jax_variables(tag):
        """JAX's (params, batch_stats) in its checkpoint ``tag``."""
        st = solver.load_model(jax_state, str(root / "jax" / str(tag) / "checkpoints"))
        return st.params, st.batch_stats

    return {"root": root, "jax_predict": predicts[0], "jax": jax_rec, "jax_best": jax_best,
            "jax_variables": jax_variables, "port": result, "port_batches": port_batches,
            "drawn": keys.drawn, "masks": masks}


def _raw_batches():
    """The raw samples of each training step, in JAX's sampler order."""
    ds = S.SyntheticSegDataset(length=N_TRAIN, pad_size=PAD, seed=0)
    sampler = JL.BatchSampler(N_TRAIN, BATCH // 2, seed=SEED)
    for _ in range(EPOCHS):
        for idx in sampler.epoch():
            raw = L.collate(ds, idx)
            yield torch.from_numpy(raw["image"]), torch.from_numpy(raw["label"])


def test_loop_batches_match_jax(loops):
    """Batch order, augmentation draws and the pipeline: each step's batch
    against JAX's."""
    steps = len(loops["jax"]["batches"])
    assert steps == len(loops["port_batches"]) == EPOCHS * N_TRAIN // (BATCH // 2)
    excused = differ = 0
    for i, ((image, label), draws, jb, (pi, pl)) in enumerate(zip(
            _raw_batches(), loops["drawn"], loops["jax"]["batches"], loops["port_batches"])):
        edge, unsure = A.unsure_pixels(draws, image, label, POLICY, PAD, CROP, tol=UNSURE)
        want_img, want_lbl = np.asarray(jb["image"]), np.asarray(jb["label"])
        assert pi.shape == want_img.shape == (BATCH, *CROP, 1)
        err = np.abs(pi.numpy() - want_img)[..., 0]
        assert not ((err > IMAGE_ATOL) & ~edge.numpy()).any(), (i, err.max())
        bad = pl.numpy() != want_lbl
        assert not (bad & ~unsure.numpy()).any(), (i, np.argwhere(bad))
        excused += int(unsure.sum())
        differ += int(bad.sum())
        print(f"step {i}: image max err {err.max():.3g}, {int(edge.sum())} edge pixels, "
              f"{int(unsure.sum())} unsure label pixels, {int(bad.sum())} labels differ")
    print(f"{excused} label pixels excused over {steps} steps, {differ} differ")


def _masks_equal(rec):
    """Whether every code's mask equals JAX's at this step."""
    return all(np.array_equal(rec["port_generation"][name].mask.permute(0, 2, 3, 1).numpy(),
                              np.asarray(rec["gen"][name][0])) for name in ("image", "shape"))


def test_loop_masks_match_jax(loops):
    """Each step's branches and masks: equal, or swapped only near the
    threshold (the step tests' check)."""
    swapped = 0
    for i, rec in enumerate(loops["masks"]):
        check_step_masks(rec, "random", f"step {i}")
        swapped += not _masks_equal(rec)
    print(f"{swapped} of {len(loops['masks'])} steps with a mask swapped near its threshold")


def test_loop_losses_match_jax(loops):
    """Each step's standard losses; its hard losses where its masks equal
    JAX's (a swap near the threshold, held by the mask test, changes the
    hard example)."""
    losses = np.concatenate([e.losses for e in loops["port"].epochs])
    assert losses.shape == (len(loops["jax"]["metrics"]), len(D.LOSS_KEYS))
    hard = np.array([k.startswith("loss/hard") for k in D.LOSS_KEYS])
    for i, (metrics, rec) in enumerate(zip(loops["jax"]["metrics"], loops["masks"])):
        want = np.array([float(metrics[k]) for k in D.LOSS_KEYS])
        assert np.all(np.isfinite(losses[i]))
        held = ~hard if not _masks_equal(rec) else np.ones_like(hard)
        print(f"step {i}: largest relative loss error "
              f"{np.max(np.abs(losses[i] - want)[held] / np.abs(want)[held]):.3g}"
              + ("" if held.all() else " (hard losses not held: a mask swapped)"))
        np.testing.assert_allclose(losses[i][held], want[held], rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"step {i}")


def _assert_state_matches(loops, tag):
    """The port's checkpoint ``tag`` against JAX's."""
    want = convert.from_jax(*jax.device_get(loops["jax_variables"](tag)))
    got_dir = loops["root"] / "port" / str(tag) / "checkpoints"
    what = f"checkpoint {tag}"
    got = {name: torch.load(os.path.join(got_dir, f"{name}.pth"), weights_only=True)
           for name in MODULE_NAMES}
    worst = 0.0
    for name in MODULE_NAMES:
        assert set(got[name]) == set(want[name]), (what, name)
        for key, w in want[name].items():
            g = got[name][key]
            if key.endswith(("running_mean", "running_var")):
                scale = float(w.abs().max())
                err = float((g - w).abs().max())
                worst = max(worst, err / scale)
                assert err <= STATS_RTOL * scale, (what, name, key, err, scale)
            else:
                assert torch.equal(g, w), (what, name, key)
    print(f"{what}: running statistics within {worst:.3g} of their scale")


@pytest.mark.parametrize("epoch", range(EPOCHS))
def test_loop_running_stats_after_each_epoch_match_jax(loops, epoch):
    _assert_state_matches(loops, epoch)


def test_loop_validation_and_selection_match_jax(loops):
    port, jax_conf = loops["port"], loops["jax"]["confusion"]
    assert [e.epoch for e in port.epochs] == list(range(EPOCHS)) and len(jax_conf) == EPOCHS
    assert port.last_epoch == EPOCHS - 1
    predict = loops["jax_predict"]  # the loop's own, predict(n_iter=2)
    val = JS.SyntheticSegDataset(length=N_VAL, pad_size=PAD, seed=1)
    batch = next(JL.EvalBatcher(val, BATCH, PAD, CROP).epoch())
    real = batch["real_count"]
    want_ious = []
    for e, want in zip(port.epochs, jax_conf):
        scores = np.asarray(predict(*loops["jax_variables"](e.epoch), batch["image"]))[:real]
        top2 = np.sort(scores, axis=-1)[..., -2:]
        tie = 2 * (2e-4 + 4e-6 * np.abs(scores).max())
        ties = int((top2[..., 1] - top2[..., 0] <= tie).sum())
        moved = int(np.abs(e.confusion - want).sum())
        print(f"epoch {e.epoch}: confusion {e.confusion.tolist()}, {moved // 2} counts moved, "
              f"{ties} near-tied pixels; Mean IoU {e.iou}")
        assert e.confusion.sum() == want.sum() == N_VAL * CROP[0] * CROP[1]
        assert moved <= 2 * ties, (e.epoch, e.confusion, want)
        score, _ = JM.scores_from_confusion(e.confusion)
        assert e.iou == score["Mean IoU : \t"] and e.acc == score["Mean Acc : \t"]
        want_ious.append(JM.scores_from_confusion(want)[0]["Mean IoU : \t"])
    # JAX's rule (a strictly larger Mean IoU) on JAX's scores
    assert loops["jax_best"] == max(want_ious)
    assert port.best_epoch == int(np.argmax(want_ious))
    assert port.best_score == port.epochs[port.best_epoch].iou


def test_loop_best_checkpoint_matches_jax(loops):
    _assert_state_matches(loops, "best")
    best = str(loops["root"] / "port" / "best" / "checkpoints")
    # the best checkpoint is the state after its epoch's steps, untouched
    # by later steps: the periodic checkpoint of that epoch, bit for bit
    at = str(loops["root"] / "port" / str(loops["port"].best_epoch) / "checkpoints")
    for name in MODULE_NAMES:
        a = torch.load(os.path.join(best, f"{name}.pth"), weights_only=True)
        b = torch.load(os.path.join(at, f"{name}.pth"), weights_only=True)
        assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------- the loop on its own
def _cfg(**learning):
    return ExperimentConfig.from_dict(
        {**CFG, "learning": {**CFG["learning"], "lr": 1e-3, **learning}})


def _trainer(cfg, seed=0):
    return CooperativeTrainer(cfg.latent_DA, learning_rate=cfg.learning.lr, device="cpu",
                              seed=seed)


def _sets(n_train=N_TRAIN):
    return (S.SyntheticSegDataset(length=n_train, pad_size=PAD, seed=0),
            S.SyntheticSegDataset(length=N_VAL, pad_size=PAD, seed=1))


def _adam(trainer):
    return [trainer.optimizer.state[p] for p in trainer.model.parameters()]


def test_max_iteration_stops_after_the_step_past_the_cap(tmp_path):
    """``max_iteration=1`` at 4 steps an epoch: two steps, then validation
    and the end, as in JAX; the default draws are ``GeneratorDraws(seed +
    1)``'s."""
    cfg = _cfg(batch_size=2, max_iteration=1)
    runs = [D.train_network("cap", *_sets(), _trainer(cfg), cfg, str(tmp_path / str(i)),
                            seed=SEED, max_epochs=3, draws=draws)
            for i, draws in enumerate((None, D.GeneratorDraws(SEED + 1)))]
    for result in runs:
        assert [e.steps for e in result.epochs] == [2] and result.last_epoch == 0
        assert result.best_epoch == 0 and np.isfinite(result.best_score)
    np.testing.assert_array_equal(runs[0].epochs[0].losses, runs[1].epochs[0].losses)


def test_empty_training_set_raises(tmp_path):
    cfg = _cfg()
    with pytest.raises(ValueError, match="empty"):
        D.train_network("empty", S.SyntheticSegDataset(length=0, pad_size=PAD), _sets()[1],
                        _trainer(cfg), cfg, str(tmp_path))


def test_snapshot_loads_back_equal(tmp_path):
    """Parameters, running statistics, Adam's moments and step, and the
    epoch; the next step from the loaded snapshot is the original's."""
    cfg = _cfg()
    trainer = _trainer(cfg)
    D.train_network("snap", *_sets(2), trainer, cfg, str(tmp_path), seed=SEED, max_epochs=1)
    path = C.save_snapshot(trainer, str(tmp_path), epoch=3)
    assert path == os.path.join(str(tmp_path), "interrupted", "checkpoints",
                                "FCN_16_standard.pth")
    other = _trainer(cfg, seed=5)
    assert C.load_snapshot(other, path) == 3
    for (ka, a), (kb, b) in zip(trainer.model.state_dict().items(),
                                other.model.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    for a, b in zip(_adam(trainer), _adam(other)):
        assert set(a) == set(b) == {"step", "exp_avg", "exp_avg_sq"}
        assert b["step"].device.type == "cpu" and float(a["step"]) == float(b["step"]) == 1
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    batcher = L.CooperativeBatcher(_sets()[0], BATCH, POLICY, PAD, CROP, device="cpu")
    batch = next(batcher.epoch(partial(D.GeneratorDraws(1).augment, 0)))
    draws = D.GeneratorDraws(2).step(BATCH, CROP, cfg.latent_DA)
    got = other.train_step(batch["image"], batch["label"], draws)
    want = trainer.train_step(batch["image"], batch["label"], draws)
    assert all(torch.equal(got[k], want[k]) for k in want)
    for a, b in zip(trainer.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    assert C.load_snapshot(other, str(tmp_path / "missing.pth")) == 0


def test_save_and_load_model_round_trip(tmp_path):
    trainer = _trainer(_cfg())
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, buf in trainer.model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    path = C.save_model(trainer, str(tmp_path), "best")
    assert path == os.path.join(str(tmp_path), "best", "checkpoints")
    assert sorted(os.listdir(path)) == sorted(f"{m}.pth" for m in MODULE_NAMES)
    loaded = C.load_model(CooperativePredictor(device="cpu", seed=9), path)
    for (ka, a), (kb, b) in zip(trainer.model.state_dict().items(),
                                loaded.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    x = torch.rand((2, *CROP, 1), generator=gen)
    assert torch.equal(loaded.predict(x, n_iter=2), trainer.model.predict(x, n_iter=2))


@pytest.mark.parametrize("fault,at,snapshot", [(RuntimeError, 1, True),
                                               (KeyboardInterrupt, 0, True),
                                               (RuntimeError, 0, False)])
def test_a_fault_saves_a_snapshot_and_resume_restarts_there(tmp_path, fault, at, snapshot):
    """A fault in epoch ``at`` saves a snapshot (an exception only after
    epoch 0, as in JAX); resuming from it runs from that epoch on, from
    the state it held."""
    cfg = _cfg()

    class Faulty(D.GeneratorDraws):
        def augment(self, epoch, *args):
            if epoch == at:
                raise fault("the data went away")
            return super().augment(epoch, *args)

    with pytest.raises(fault):
        D.train_network("fault", *_sets(2), _trainer(cfg), cfg, str(tmp_path), seed=SEED,
                        max_epochs=3, draws=Faulty(SEED + 1))
    path = C.snapshot_path(str(tmp_path), "FCN_16_standard")
    assert os.path.exists(path) == snapshot
    if not snapshot:
        return
    resumed = _trainer(cfg, seed=7)
    result = D.train_network("fault", *_sets(2), resumed, cfg, str(tmp_path), seed=SEED,
                             max_epochs=2, resume_path=path)
    assert [e.epoch for e in result.epochs] == list(range(at, 2))
    assert all(float(st["step"]) == 2 for st in _adam(resumed))


def test_cli_trains_on_the_cpu(tmp_path):
    config = tmp_path / "small.json"
    config.write_text(json.dumps({**CFG, "learning": {"batch_size": BATCH, "lr": 1e-3}}))
    trainer, result = cli.main([
        "--json_config_path", str(config), "--synthetic", "--synthetic_train_length",
        str(N_TRAIN), "--synthetic_val_length", str(N_VAL), "--max_epochs", "1",
        "--device", "cpu", "--save_dir", str(tmp_path / "runs"), "--log"])
    root = tmp_path / "runs" / "train_ACDC_10_n_cls_4" / "small" / "0"
    for tag in ("best", "0"):
        assert sorted(os.listdir(root / "model" / tag / "checkpoints")) == sorted(
            f"{m}.pth" for m in MODULE_NAMES)
    with open(root / "log" / "scalars.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert tags == set(D.LOSS_KEYS) | {"time/train_epoch_sec", "time/val_epoch_sec",
                                       "time/draw_epoch_sec", "iou/val_iou", "acc/val_acc"}
    assert (root / "log" / "small_cv0.json").exists()
    assert result.best_epoch == 0 and [e.steps for e in result.epochs] == [2]
    assert next(trainer.model.parameters()).device.type == "cpu"
    # validation left the modules in train mode for the next step
    assert all(m.training for m in trainer.model.modules())


def test_cli_refuses_without_cuda_or_synthetic_data(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--synthetic", "--max_epochs", "1", "--save_dir", str(tmp_path)])
    with pytest.raises(FileNotFoundError, match="--root_dir or --synthetic"):
        cli.main(["--device", "cpu", "--save_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
