"""The port's fused epoch, K-epoch window and pipelined fetch on the CPU.

On the CPU the fused paths run the bodies of their CUDA graphs uncaptured
(``train/graphs.py``), so they must give the streaming loop's numbers bit
for bit: the same batch orders, the same draws in the same order, the same
ops.  The streaming loop itself is held to the JAX package's
``train_network`` in ``test_torch_port_loop.py``; these tests hold the
three modes to it, as the JAX package's own tests hold its fused scan,
window and pipelined fetch to its serial loop (``tests/test_data.py:455``,
``tests/test_e2e.py:101,142,188``), and hold the parts against the JAX
package where it has them: ``device_scores_from_confusion`` (within 1e-7,
the float32 rounding of a mean of four ratios, with the same NaN pattern)
and the draw order, replayed from JAX's key schedule (``JaxKeys``).

Small sizes: phantoms padded to 40x40 and cropped to 32x32, batch 4 (2 raw
slices and their originals), 4 training and 5 validation phantoms, the
configuration's policy and latent DA (``mask_type="random"`` on both
codes, soft masks), Adam at 1e-3, so that each epoch moves the weights and
no two epochs' Mean IoUs lie within float32 rounding of each other (the
window selects in float32 on the device, the serial loop in float64 on
the host; the test asserts the gap).
"""

import json
import os
from functools import partial

import numpy as np
import pytest
import torch
from torch_port_util import JaxKeys, one_torch_thread  # noqa: F401 - a fixture

from cooperative_training_and_latent_space_data_augmentation_tpu.train.multi_epoch import (
    device_scores_from_confusion as jax_device_scores,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    ExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.convert import TrainState
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import loader as L
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import synthetic as S
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import checkpoint as C
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import driver as D
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (
    multi_epoch as ME,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    stage_draws,
    tensors_of,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import (
    checkpoint as ckpt,
)

PAD = (40, 40)
CROP = (32, 32)
BATCH = 4
N_TRAIN, N_VAL = 4, 5
SEED = 40
EPOCHS = 5
PERIOD = 3  # periodic checkpoints after epochs 0 and 2: windows [1, 2] and [3, 4]
CFG = {"name": "fused", "data": {"pad_size": [*PAD, 1], "crop_size": [*CROP, 1]},
       "learning": {"batch_size": BATCH, "lr": 1e-3},
       "output": {"save_epoch_every_num_epochs": PERIOD}}
SCORES_ATOL = 1e-7
F32_ROUNDING = 4 * 2.0 ** -24  # a few ulps of a Mean IoU below 1


def _cfg(**learning):
    return ExperimentConfig.from_dict({**CFG, "learning": {**CFG["learning"], **learning}})


def _sets():
    return (S.SyntheticSegDataset(length=N_TRAIN, pad_size=PAD, seed=0),
            S.SyntheticSegDataset(length=N_VAL, pad_size=PAD, seed=1))


def _run(root, tag, max_epochs=EPOCHS, cfg=None, **kw):
    """``train_network`` on the CPU into ``root/tag``: (trainer, result,
    model_dir, the logged scalars but the times)."""
    cfg = cfg or _cfg()
    trainer = CooperativeTrainer(cfg.latent_DA, learning_rate=cfg.learning.lr, device="cpu")
    model_dir, log_dir = str(root / tag / "model"), str(root / tag / "log")
    result = D.train_network(tag, *_sets(), trainer, cfg, model_dir, log_dir=log_dir, log=True,
                             seed=SEED, max_epochs=max_epochs, **kw)
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        scalars = {(r["tag"], r["step"]): r["value"] for r in map(json.loads, f)
                   if not r["tag"].startswith("time/")}
    return trainer, result, model_dir, scalars


def _adam(trainer):
    return [trainer.optimizer.state[p] for p in trainer.model.parameters()]


def _assert_same_state(a, b):
    """Parameters, BN running statistics and Adam's moments and step, bit
    for bit."""
    for (ka, x), (kb, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(x, y), ka
    for sa, sb in zip(_adam(a), _adam(b)):
        assert torch.equal(sa["step"], sb["step"])
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def _assert_same_epochs(a, b):
    assert [e.epoch for e in a.epochs] == [e.epoch for e in b.epochs]
    for ea, eb in zip(a.epochs, b.epochs):
        np.testing.assert_array_equal(ea.losses, eb.losses)
        np.testing.assert_array_equal(ea.confusion, eb.confusion)
        assert ea.branches == eb.branches
        assert (ea.iou, ea.acc) == (eb.iou, eb.acc)
    assert (a.best_epoch, a.best_score, a.last_epoch) == (b.best_epoch, b.best_score,
                                                          b.last_epoch)


def _assert_same_checkpoint(dir_a, dir_b):
    for name in MODULE_NAMES:
        a = torch.load(os.path.join(dir_a, "checkpoints", f"{name}.pth"), weights_only=True)
        b = torch.load(os.path.join(dir_b, "checkpoints", f"{name}.pth"), weights_only=True)
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a), name


@pytest.fixture(scope="module")
def serial(tmp_path_factory):
    """The streaming loop over 5 epochs, the reference of the window and
    the pipelined fetch."""
    return _run(tmp_path_factory.mktemp("serial"), "serial")


def test_serial_mean_ious_are_apart(serial):
    """No two epochs' Mean IoUs lie within float32 rounding of each other,
    so the window's float32 selection and the loop's float64 one cannot
    part (the other tests would not see such a fault otherwise)."""
    ious = [e.iou for e in serial[1].epochs]
    assert len(ious) == EPOCHS
    gaps = [abs(a - b) for i, a in enumerate(ious) for b in ious[i + 1:]]
    assert min(gaps) > F32_ROUNDING, ious


def test_fused_epoch_equals_the_streaming_loop_with_the_max_iteration_cut(tmp_path):
    """Two epochs, the second cut after its first step by ``max_iteration``
    (2 steps an epoch, cap 2: JAX's truncated ``idx_mat[:k_allow]``): the
    fused epoch equals the streaming loop bit for bit in losses, branches,
    confusion matrices, parameters, BN running statistics and Adam's
    moments and step."""
    cfg = _cfg(max_iteration=2)
    s_tr, s_res, s_dir, s_sc = _run(tmp_path, "stream", max_epochs=3, cfg=cfg)
    f_tr, f_res, f_dir, f_sc = _run(tmp_path, "fused", max_epochs=3, cfg=cfg, fused_epoch=True)
    assert [e.steps for e in f_res.epochs] == [2, 1] and f_res.last_epoch == 1
    _assert_same_epochs(s_res, f_res)
    _assert_same_state(s_tr, f_tr)
    assert s_sc == f_sc
    assert f_res.graphs.eager_steps == 3 and not f_res.graphs.graphs
    for tag in ("best", "0"):
        _assert_same_checkpoint(os.path.join(s_dir, tag), os.path.join(f_dir, tag))


def test_window_equals_the_serial_loop(serial, tmp_path):
    """``multi_epoch=2`` over 5 epochs (epoch 0 alone, windows [1, 2] and
    [3, 4], a periodic checkpoint at the end of the first) equals the
    serial loop: per-epoch scalars, best epoch and score, the best and
    periodic checkpoints' files and the final state, bit for bit."""
    s_tr, s_res, s_dir, s_sc = serial
    w_tr, w_res, w_dir, w_sc = _run(tmp_path, "window", fused_epoch=True, multi_epoch=2)
    _assert_same_epochs(s_res, w_res)
    assert s_sc == w_sc
    _assert_same_state(s_tr, w_tr)
    assert sorted(os.listdir(w_dir)) == sorted(os.listdir(s_dir)) == ["0", "2", "best", "orbax"]
    # the whole state at each periodic save, the window's at its end
    assert (ckpt.all_steps(os.path.join(w_dir, "orbax"))
            == ckpt.all_steps(os.path.join(s_dir, "orbax")) == [0, 2])
    for tag in ("best", "0", "2"):
        _assert_same_checkpoint(os.path.join(s_dir, tag), os.path.join(w_dir, tag))
    # the window's epochs log their validation inside the window's seconds
    assert [e.val_sec for e in w_res.epochs[1:]] == [0.0] * 4


def test_pipelined_fetch_equals_the_serial_loop(serial, tmp_path):
    """``pipeline_epoch=True`` reorders the read backs only: scalars,
    selection, checkpoints (written from the device copy of each epoch's
    state) and the final state equal the serial loop's."""
    s_tr, s_res, s_dir, s_sc = serial
    p_tr, p_res, p_dir, p_sc = _run(tmp_path, "pipe", fused_epoch=True, pipeline_epoch=True)
    _assert_same_epochs(s_res, p_res)
    assert s_sc == p_sc
    _assert_same_state(s_tr, p_tr)
    for tag in ("best", "0", "2"):
        _assert_same_checkpoint(os.path.join(s_dir, tag), os.path.join(p_dir, tag))


def test_pipelined_fetch_flushes_the_pending_epoch_on_a_fault(tmp_path):
    """A fault while epoch 2 is drawn: epoch 1, still in flight, is read
    back and logged before the snapshot is written (JAX's
    ``_flush_pending``); without the flush only epoch 0 would be."""

    class Faulty(D.GeneratorDraws):
        def augment(self, epoch, *args):
            if epoch == 2:
                raise RuntimeError("the data went away")
            return super().augment(epoch, *args)

    cfg = _cfg()
    trainer = CooperativeTrainer(cfg.latent_DA, learning_rate=cfg.learning.lr, device="cpu")
    with pytest.raises(RuntimeError, match="went away"):
        D.train_network("fault", *_sets(), trainer, cfg, str(tmp_path / "model"),
                        log_dir=str(tmp_path), log=True, seed=SEED, max_epochs=4,
                        draws=Faulty(SEED + 1), fused_epoch=True, pipeline_epoch=True)
    with open(tmp_path / "scalars.jsonl") as f:
        logged = {r["step"] for r in map(json.loads, f) if r["tag"] == "iou/val_iou"}
    assert logged == {0, 1}
    assert os.path.exists(C.snapshot_path(str(tmp_path / "model"), "FCN_16_standard"))


def test_window_selects_on_the_device():
    """The window's selection alone, on scripted epochs: strictly greater
    Mean IoU, the winner's parameters and buffers kept; -1 and the window's
    first state when no epoch beats the best so far."""
    model = CooperativeTrainer(None, device="cpu").model
    w = next(model.parameters())
    name, key = next((n, k) for n in MODULE_NAMES
                     for k, v in getattr(model, n).named_parameters() if v is w)
    # class 0's row [1000, m]: Mean IoU (1000 / (1000 + m) + 0) / 2
    misses = iter([300, 100, 200, 900, 800])

    def epoch(idx_mat, steps, out):
        with torch.no_grad():
            w.add_(1.0)
        out.zero_()

    def validate(confusion):
        confusion.zero_()
        confusion[0, 0], confusion[0, 1] = 1000, next(misses)
        return confusion

    runner = ME.WindowRunner(epoch, validate, model)
    start = w.detach().clone()
    out = runner(np.zeros((3, 1, 2), np.int64), [None] * 3, 0.3)
    assert int(out["best_epoch"]) == 1
    assert float(out["best_iou"]) == pytest.approx(500 / 1100, abs=1e-6)
    np.testing.assert_allclose(out["val_iou"].numpy(), [500 / 1300, 500 / 1100, 500 / 1200],
                               atol=1e-6)
    assert torch.equal(out["best"][name][key], start + 1.0 + 1.0)
    out = runner(np.zeros((2, 1, 2), np.int64), [None] * 2, 0.7)
    assert int(out["best_epoch"]) == -1
    assert torch.equal(out["best"][name][key], start + 1.0 + 1.0 + 1.0)


@pytest.mark.parametrize("seed", range(6))
def test_device_scores_match_jax(seed):
    """``device_scores_from_confusion`` against the JAX function on random
    4-class confusion matrices, classes left empty included (0 / 0 left
    out of the means): within 1e-7, NaN where JAX's is."""
    rng = np.random.RandomState(seed)
    hist = rng.randint(0, 5000, (4, 4))
    empty = rng.rand(4) < 0.4
    hist[empty, :] = 0
    if seed == 0:
        hist[:] = 0  # every class empty: both means NaN
    if seed == 1:
        hist[:, 2] = 0  # a class never predicted: IoU 0, accuracy defined
    got = [float(v) for v in ME.device_scores_from_confusion(torch.from_numpy(hist))]
    want = [float(v) for v in jax_device_scores(hist)]
    for g, w in zip(got, want):
        assert np.isnan(g) == np.isnan(w)
        if not np.isnan(w):
            assert abs(g - w) <= SCORES_ATOL


def _streaming_calls(source, epochs, n_steps, batcher, lda):
    """The streaming loop's calls of a draw source over ``epochs``."""
    out = []
    for epoch in epochs:
        for _ in range(n_steps):
            augment = source.augment(epoch, batcher.policy, batcher.raw_bs, PAD)
            out.append((augment, source.step(batcher.step_batch, CROP, lda)))
    return out


@pytest.mark.parametrize("kind", ["generator", "jax_keys"])
def test_staged_draws_equal_the_streaming_calls(kind):
    """The staged draws of a 2-epoch window equal, field by field, what
    the streaming loop draws from a fresh source of the same seed: the
    default ``GeneratorDraws`` and the replay of JAX's key schedule."""
    cfg = _cfg()
    batcher = L.CooperativeBatcher(_sets()[0], BATCH, "ACDC_affine_elastic_intensity", PAD,
                                   CROP, device="cpu")
    make = {"generator": lambda: D.GeneratorDraws(SEED + 1),
            "jax_keys": lambda: JaxKeys(SEED)}[kind]
    want = _streaming_calls(make(), [1, 2], len(batcher), batcher, cfg.latent_DA)
    staged = stage_draws(make(), [1, 2], len(batcher), batcher.policy, batcher.raw_bs, PAD,
                         batcher.step_batch, CROP, cfg.latent_DA, "cpu")
    assert len(staged) == len(want) == 2 * len(batcher)
    for s, (augment, step) in zip(staged.steps, want):
        got, ref = tensors_of((s.augment, s.step)), tensors_of((augment, step))
        assert len(got) == len(ref)
        assert all(g.dtype == r.dtype and torch.equal(g, r) for g, r in zip(got, ref))
        assert s.branches == D._branches(step)


def test_fused_epoch_streams_the_samplers_orders():
    """``epoch_index_matrix`` takes the sampler's next epoch, as
    ``epoch`` does."""
    make = partial(L.CooperativeBatcher, _sets()[0], BATCH, "ACDC_affine_elastic_intensity",
                   PAD, CROP, device="cpu", seed=7)
    a, b = make(), make()
    for _ in range(3):
        want = np.stack(list(b.sampler.epoch()))
        np.testing.assert_array_equal(a.epoch_index_matrix(), want)


def test_cli_fused_window_trains_on_the_cpu(tmp_path):
    """``cli.train --fused_epoch --multi_epoch 2`` through the entry point
    on the CPU: the uncaptured bodies, epoch 0 alone, epochs 1-2 in one
    window."""
    config = tmp_path / "small.json"
    config.write_text(json.dumps({**CFG, "output": {"save_epoch_every_num_epochs": 10}}))
    trainer, result = cli.main([
        "--json_config_path", str(config), "--synthetic", "--synthetic_train_length",
        str(N_TRAIN), "--synthetic_val_length", "2", "--max_epochs", "3", "--device", "cpu",
        "--fused_epoch", "--multi_epoch", "2", "--save_dir", str(tmp_path / "runs")])
    assert [e.epoch for e in result.epochs] == [0, 1, 2]
    assert result.graphs is not None and result.graphs.eager_steps == 6
    assert not trainer.capturable
    assert all(np.isfinite(e.losses).all() for e in result.epochs)


@pytest.mark.parametrize("argv,match", [
    (["--multi_epoch", "2"], "--fused_epoch"),
    (["--pipeline_epoch"], "--fused_epoch"),
    (["--fused_epoch", "--multi_epoch", "2", "--pipeline_epoch"], "not both"),
    (["--fused_epoch", "--multi_epoch", "-1"], "multi_epoch"),
])
def test_cli_refuses_epoch_modes_that_do_not_exist(tmp_path, argv, match):
    with pytest.raises(ValueError, match=match):
        cli.main(["--synthetic", "--device", "cpu", "--save_dir", str(tmp_path)] + argv)
    assert not os.listdir(tmp_path)


def test_fused_epoch_refuses_a_dataset_off_the_device():
    batcher = L.CooperativeBatcher(_sets()[0], BATCH, "ACDC_affine_elastic_intensity", PAD,
                                   CROP, device="cpu", device_cache=False)
    with pytest.raises(ValueError, match="DEVICE_CACHE_LIMIT_BYTES"):
        batcher.fused_epoch_runner(CooperativeTrainer(None, device="cpu"))


def test_stacked_epoch_equals_the_eval_batches():
    evals = L.EvalBatcher(_sets()[1], BATCH, PAD, CROP, device="cpu")
    images, labels, real = evals.stacked_epoch()
    batches = list(evals.epoch())
    assert images.shape == (2, BATCH, *CROP, 1) and labels.dtype == torch.int32
    assert real.tolist() == [b["real_count"] for b in batches] == [4, 1]
    for i, b in enumerate(batches):
        assert torch.equal(images[i], b["image"]) and torch.equal(labels[i], b["label"])


@pytest.mark.parametrize("capturable", [False, True])
def test_adam_step_loads_where_the_trainer_keeps_it(tmp_path, capturable):
    """``load_train_state`` and ``load_snapshot`` put Adam's step with the
    parameters for a ``capturable`` trainer and on the host otherwise, as
    float32, and keep the trainer's own ``capturable`` flag whatever the
    snapshot's trainer had."""
    cfg = _cfg()
    source = CooperativeTrainer(cfg.latent_DA, learning_rate=1e-3, device="cpu")
    D.train_network("adam", *_sets(), source, cfg, str(tmp_path), seed=SEED, max_epochs=1)
    path = C.save_snapshot(source, str(tmp_path), epoch=1)
    trainer = CooperativeTrainer(cfg.latent_DA, learning_rate=1e-3, device="cpu", seed=3,
                                 capturable=capturable)
    assert C.load_snapshot(trainer, path) == 1
    assert all(g["capturable"] == capturable for g in trainer.optimizer.param_groups)
    for p, st in zip(trainer.model.parameters(), _adam(trainer)):
        want = p.device if capturable else torch.device("cpu")
        assert st["step"].device == want and st["step"].dtype == torch.float32
        assert float(st["step"]) == 2
    mu, nu = source.adam_moments()
    state = TrainState({name: getattr(source.model, name).state_dict() for name in MODULE_NAMES},
                       mu, nu, step=5)
    trainer.load_train_state(state)
    for p, st in zip(trainer.model.parameters(), _adam(trainer)):
        assert st["step"].device == (p.device if capturable else torch.device("cpu"))
        assert float(st["step"]) == 5


def test_pointwise_f32_conv_gradients():
    """The route of every float32 1x1 stride-1 conv on the card
    (``conv_chw._PointwiseF32``, its weight gradient a batched matmul): its
    gradients are F.conv2d's, by ``gradcheck`` in float64."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
        _PointwiseF32,
    )

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((3, 16, 8, 9), generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn((4, 16, 1, 1), generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(_PointwiseF32.apply, (x, w))
    torch.testing.assert_close(_PointwiseF32.apply(x, w),
                               torch.nn.functional.conv2d(x, w), rtol=0, atol=1e-12)


def test_streaming_validation_is_the_captured_body():
    """The streaming loop's validation (``eval_dispatch``, a batch at a
    time) and the body the fused paths capture
    (``validation_confusion`` over ``EvalBatcher.stacked_epoch``) give one
    confusion matrix, the ragged tail's wrap-padded rows left out of both."""
    model = CooperativeTrainer(None, device="cpu").model
    evals = L.EvalBatcher(_sets()[1], BATCH, PAD, CROP, device="cpu")
    stacked = evals.stacked_epoch()
    assert stacked[2].tolist() == [BATCH, N_VAL - BATCH]
    want = model.validation_confusion(*stacked)
    assert torch.equal(D.eval_dispatch(model, evals).confusion_matrix, want)
    assert int(want.sum()) == N_VAL * CROP[0] * CROP[1]


def test_launched_counts_replays_not_captures():
    """``graphs.launched``: a capture ticks the counters and launches
    nothing, a replay launches the graph's counts and ticks nothing."""
    from collections import Counter
    from types import SimpleNamespace as NS

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        launched,
    )

    step = NS(graphs={"a": NS(launches={"k1": 3, "k3": 1}), "b": NS(launches={"k1": 2})},
              replays=Counter({"a": 4}))  # "b" captured and never replayed
    val = NS(graph=object(), launches={"k1": 5}, replays=2)
    eager = {"k1": 10, "k3": 2}
    ticks = {"k1": eager["k1"] + 3 + 2 + 5, "k3": eager["k3"] + 1}
    assert launched(ticks, [step], [val]) == {"k1": 10 + 4 * 3 + 2 * 5, "k3": 2 + 4 * 1}
    assert launched(eager) == eager


def test_fetch_to_host_copies_as_queued():
    """The pipelined fetch's copies hold the tensors as they stood when the
    fetch was queued, not as a later step leaves them in place."""
    x = torch.arange(4.0)
    wait, (got, nested) = D.fetch_to_host((x, {"m": {"w": x}}))
    x.add_(1.0)
    wait()
    assert torch.equal(got, torch.arange(4.0))
    assert torch.equal(nested["m"]["w"], torch.arange(4.0))
