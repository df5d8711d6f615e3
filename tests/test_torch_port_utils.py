"""The port's model utilities against the JAX package's where both compute
the same thing: ``utils/estimate.py``, ``utils/profiling.py``,
``utils/save.py`` with ``TestSegmentationNetwork.save_top_k_result``, and
the TensorBoard mirror of ``utils/logging.py:ScalarLogger`` (with the
training loop's event file).

Exact: parameter counts and bytes against JAX's on the same solver, the
CPU ``estimate_size``'s argument bytes against JAX's, the flop count of a
conv against ``2 N H W C_in C_out 9``, NRRD round trips and the logged
scalars.  No tolerance is needed anywhere here.
"""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    read_nrrd,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval import tester
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import (
    estimate,
    profiling,
    save,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.logging import (
    ScalarLogger,
)
from torch_port_util import HW, make_solver, one_torch_thread, random_variables  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------------ estimate
def test_parameter_counts_and_bytes_equal_jax():
    from cooperative_training_and_latent_space_data_augmentation_tpu.utils import (
        estimate as jax_estimate,
    )

    params, _ = random_variables(make_solver())
    model = CooperativePredictor(device="cpu")
    assert estimate.count_params(model) == jax_estimate.count_params(params)
    assert estimate.param_bytes(model) == jax_estimate.param_bytes(params)
    for name in ("image_encoder", "shape_decoder"):
        module = getattr(model, name)
        assert estimate.count_params(module) == jax_estimate.count_params(params[name])
    # a state dict counts its buffers too (BN's running statistics)
    sd = {"a": {"w": torch.zeros(3, 4), "b": torch.zeros(2, dtype=torch.bfloat16)}}
    assert (estimate.count_params(sd), estimate.param_bytes(sd)) == (14, 52)


def test_estimate_size_on_the_cpu_is_jaxs_fallback():
    """The argument bytes JAX's memory analysis reports, NaN for the rest
    (JAX's answer for a backend without memory analysis)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu.utils import (
        estimate as jax_estimate,
    )

    x = np.ones((64, 32), np.float32)
    want = jax_estimate.estimate_size(lambda a: (a * 2).sum(), jnp.asarray(x))
    got = estimate.estimate_size(lambda a: (a * 2).sum(), torch.from_numpy(x))
    assert got["params_mb"] == want["params_mb"] == x.nbytes / 2 ** 20
    assert all(np.isnan(got[k]) for k in ("output_mb", "temp_mb", "total_mb"))


def test_extract_features_captures_named_submodules():
    model = CooperativePredictor(device="cpu", seed=1).image_decoder
    z = torch.rand(2, 128, 2, 2)
    with torch.no_grad():
        out, feats = estimate.extract_features(model, z)
        assert torch.equal(out, model(z))
        names = [n for n, _ in model.named_modules() if n]
        assert set(feats) == set(names)
        first = names[0]
        only, picked = estimate.extract_features(model, z, layer_filter=first)
        assert torch.equal(only, out) and first in picked and set(picked) <= set(names)
        assert all(first in k for k in picked)
    assert not any(m._forward_hooks for m in model.modules())


# ----------------------------------------------------------------- profiling
@pytest.mark.parametrize("route", ["k1", "conv2d"])
def test_cost_summary_counts_a_convs_operations(route):
    """A conv's flops are ``2 N H W C_in C_out 9`` whether it runs K1's
    plain version (the tap matrix times the wall) or ``F.conv2d``; the
    bytes cover at least its input, weight and output once."""
    n, c_in, c_out, h, w = 2, 8, 16, 12, 10
    x = torch.rand(n, c_in, h, w)
    wt = torch.rand(c_out, c_in, 3, 3)
    if route == "k1":
        fn = lambda a, b: conv_chw.conv3x3_chw(a.reshape(n, c_in, h * w),  # noqa: E731
                                               conv_chw.weights_to_wall(b).contiguous(), h, w)
    else:
        fn = lambda a, b: F.conv2d(a, b, padding=1)  # noqa: E731
    cost = profiling.cost_summary(fn, x, wt, measured_s=1e-3)
    flops = 2 * n * h * w * c_in * c_out * 9
    assert cost["flops"] == flops
    assert cost["bytes_accessed"] >= x.nbytes + wt.nbytes + n * c_out * h * w * 4
    assert cost["argument_bytes"] == x.nbytes + wt.nbytes
    assert cost["achieved_flops_per_s"] == flops / 1e-3
    assert cost["flops_utilization_upper_bound"] == flops / 1e-3 / profiling.PEAK_FLOPS[
        "bfloat16"]
    assert cost["hbm_utilization_upper_bound"] == (cost["bytes_accessed"] / 1e-3
                                                   / profiling.HBM_BYTES_PER_S)


def test_card_peaks_have_one_home():
    """The data sheet's rates live in ``utils/profiling.py``; the bench and
    the smoke take them from there (their values unchanged)."""
    import chip_smoke
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import (
        bench_b8_conv,
    )

    assert profiling.HBM_BYTES_PER_S == 3.35e12
    assert profiling.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert bench_b8_conv.bound is profiling.bound
    assert not hasattr(chip_smoke, "HBM_BYTES_PER_S") and not hasattr(chip_smoke, "PEAK_FLOPS")
    assert chip_smoke.bound(3.35e9, 1.0, "float32") == (1.0, "bytes")
    assert profiling.bound(1.0, 67e9, "float32") == (1.0, "operations")


def test_timing_helpers_and_trace(tmp_path):
    calls = []

    def fn(a):
        calls.append(1)
        return a * 2

    t = profiling.time_fn(fn, torch.ones(3), warmup=2, iters=4)
    assert len(calls) == 1 + 1 + 4 and t["compile_s"] > 0 and t["steady_s"] > 0
    seen = []

    def op(c):
        seen.append(float(c))
        return torch.ones(4) + c

    run = profiling.serialize_scan(op, 3)
    out = run()
    assert out.dim() == 0 and len(seen) == 3 and seen[0] == 0.0
    assert seen[1] == float(torch.tensor(1e-12))  # each input is the last mean x 1e-12
    assert np.isfinite(profiling.fused_scan_marginal(
        lambda k: profiling.serialize_scan(lambda c: torch.ones(8) + c, k), 2, 4, reps=1))
    with profiling.trace(str(tmp_path)):
        torch.ones(16).sum()
    assert glob.glob(str(tmp_path / "*.pt.trace.json"))


# ---------------------------------------------------------------------- save
def test_save_dumps_round_trip(tmp_path):
    vol = np.arange(2 * 3 * 4, dtype=np.int16).reshape(2, 3, 4)
    path = save.save_nrrd_to_disk(str(tmp_path / "n"), "v", vol, spacing=(1.5, 1.5, 3.0))
    assert path.endswith("v.nrrd")
    back, spacing = read_nrrd(path)
    np.testing.assert_array_equal(back, vol)
    assert tuple(spacing) == (1.5, 1.5, 3.0)
    pred = save.save_predict(vol, str(tmp_path), "p1", "pred.nrrd")
    np.testing.assert_array_equal(read_nrrd(pred)[0], vol)
    np.testing.assert_array_equal(
        read_nrrd(save.save_numpy_as_nrrd(vol, str(tmp_path / "x.nrrd")))[0], vol)
    assert save.load_dict(save.save_dict({"a": 1}, str(tmp_path / "d" / "s.pkl"))) == {"a": 1}
    np.testing.assert_array_equal(np.load(save.save_npy(vol, str(tmp_path), "arr")), vol)
    link = save.link_image(pred, str(tmp_path), "p2")
    assert os.path.islink(link) and os.path.realpath(link) == os.path.realpath(pred)


def test_save_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(0)
    img = rng.rand(3, 8, 8).astype(np.float32)
    lbl = rng.randint(0, 4, (3, 8, 8))
    assert save.save_testing_images_results(img, lbl, lbl, str(tmp_path), 0).endswith(
        os.path.join("0", "Seg_plots.png"))
    assert save.save_imgs([img[..., None], rng.rand(3, 8, 8, 4)], is_image=False,
                          save_dir=str(tmp_path), file_name="imgs.png")
    for fn, args in ((save.save_results_as_png, ([img[0], img[1]], str(tmp_path / "r.png"))),
                     (save.save_list_results_as_png,
                      ([[img[0], img[1]], [img[2], img[0]]], str(tmp_path / "l.png"))),
                     (save.save_results_with_points_as_png,
                      ([img[0]], str(tmp_path / "p.png"), [np.array([[1, 2]])])),
                     (save.save_npy2image, (img[0], str(tmp_path), "g"))):
        path = fn(*args)
        assert os.path.getsize(path) > 0


def test_save_top_k_result(tmp_path):
    """The k best and worst patients of a run, each a grid named by rank,
    patient and Dice, in the order of ``top_k``/``worst_k`` (the JAX
    package's names)."""
    pytest.importorskip("matplotlib")
    ds = SyntheticSegDataset(length=10, pad_size=(HW, HW), n_patients=3, slices_per_patient=4)
    rng = np.random.RandomState(1)

    def predict(x):  # noisy class scores, so the patients' Dice differ
        return torch.from_numpy(rng.rand(x.shape[0], HW, HW, 4).astype(np.float32))

    net = tester.TestSegmentationNetwork(ds, predict, crop_size=(HW, HW), device="cpu")
    net.run()
    for worst, chosen in ((False, net.top_k(2)), (True, net.worst_k(2))):
        paths = net.save_top_k_result(str(tmp_path), k=2, worst=worst)
        tag = "worst" if worst else "top"
        assert [os.path.relpath(p, tmp_path) for p in paths] == [
            os.path.join(f"{tag}_{r}_{rec['pid']}_dice_{rec['dice']:.3f}", "Seg_plots.png")
            for r, rec in enumerate(chosen)]
        assert all(os.path.getsize(p) > 0 for p in paths)


# -------------------------------------------------------------- TensorBoard
def _scalars(log_dir, tag):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir)
    acc.Reload()
    return [(e.step, e.value) for e in acc.Scalars(tag)]


def test_tensorboard_mirror_and_purge_step(tmp_path):
    """Every scalar goes to the JSONL stream and to an event file; a logger
    started at ``purge_step`` replaces the steps from there on."""
    log = ScalarLogger(str(tmp_path))
    assert len(log.event_files) == 1 and os.path.exists(log.event_files[0])
    for step in range(5):
        log.add_scalar("loss", float(step), step)
    log.close()
    resumed = ScalarLogger(str(tmp_path), purge_step=2)
    for step in (2, 3):
        resumed.add_scalar("loss", 10.0 + step, step)
    resumed.close()
    assert _scalars(str(tmp_path), "loss") == [(0, 0.0), (1, 1.0), (2, 12.0), (3, 13.0)]
    with open(tmp_path / "scalars.jsonl") as f:
        assert len(f.readlines()) == 7
    none = ScalarLogger(None)  # no log directory: the history only, no file
    none.add_scalar("x", 1.0, 0)
    none.close()
    assert none.history["x"] == [(0, 1.0)] and none.event_files == []


def test_loop_writes_its_scalars_to_tensorboard(tmp_path):
    """``cli.train --log``: the loop's scalars in its log directory's event
    file, which ``TrainResult.written`` lists."""
    with open(os.path.join(REPO, "configs", "ACDC", "cooperative_training.json")) as f:
        cfg = json.load(f)
    cfg["data"].update(pad_size=[40, 40, 1], crop_size=[HW, HW, 1])
    cfg["learning"]["batch_size"] = 4
    path = str(tmp_path / "tiny.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    args = cli.parse_args(["--json_config_path", path, "--synthetic", "--synthetic_train_length",
                           "4", "--synthetic_val_length", "4", "--device", "cpu",
                           "--save_dir", str(tmp_path / "runs"), "--log", "--max_epochs", "2"])
    exp_cfg, name = cli.load_config(args)
    _, result = cli.run(args, exp_cfg, name)
    events = [p for p in result.written if "events.out.tfevents" in p]
    assert len(events) == 1
    ious = _scalars(os.path.dirname(events[0]), "iou/val_iou")
    assert [s for s, _ in ious] == [0, 1]
    np.testing.assert_allclose([v for _, v in ious], [e.iou for e in result.epochs], rtol=1e-6)
