"""The port's serving export (``utils/serving.py``, ``cli/export.py``)
against ``CooperativeTripletSolver.predict`` (JAX) on converted weights.

32x32 slices, random weights drawn with numpy (``torch_port_util``); the
JAX predict runs its convs through XLA, the plain reference of its Pallas
conv (the same function), in one jitted call a batch size.  The archive
is written by ``export_predictor`` from a predictor loaded with
``convert.from_jax``, and by ``cli.export`` from the JAX solver's own
``save_model`` directory (``.msgpack``), reloaded with ``load_predictor``
on the CPU and called at batch 2 and 3, in probability and logit modes.
Tolerance (float32): ``2e-4 + 4e-6 * max|JAX|``, the predict test's
(f32 summation orders amplified through the FTN and one STN refinement).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    export as cli_export,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import serving
from torch_port_util import HW, jax_train_state, make_solver, one_torch_thread, random_variables  # noqa: F401

BATCHES = (2, 3)
N_ITER = 2


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    atol = 2e-4 + 4e-6 * np.abs(want).max()
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=atol,
                               err_msg=what)


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """Weights, inputs at each batch size, JAX's probabilities and logits,
    and the JAX solver's ``save_model`` directory of those weights."""
    solver = make_solver()
    params, stats = random_variables(solver, seed=3)
    rng = np.random.RandomState(4)
    xs = {n: rng.uniform(0, 1, (n, HW, HW, 1)).astype(np.float32) for n in BATCHES}
    run = jax.jit(lambda p, s, x: (solver.predict(p, s, x, N_ITER, True),
                                   solver.predict(p, s, x, N_ITER, False)))
    want = {n: jax.device_get(run(params, stats, jnp.asarray(x))) for n, x in xs.items()}
    ckpt = tmp_path_factory.mktemp("jax_ckpt")
    solver.save_model(jax_train_state(solver, params, stats), str(ckpt), "best")
    return params, stats, xs, want, str(ckpt / "best" / "checkpoints")


@pytest.mark.parametrize("softmax", [True, False])
def test_exported_archive_matches_jax_predict(jax_case, tmp_path, softmax):
    params, stats, xs, want, _ = jax_case
    live = CooperativePredictor(device="cpu")
    live.load_state_dicts(convert.from_jax(params, stats))
    path = serving.export_predictor(live, str(tmp_path / "predictor"), input_hw=(HW, HW),
                                    n_iter=N_ITER, softmax=softmax)
    assert path.endswith(".pt")
    served = serving.load_predictor(path, device="cpu")
    for n in BATCHES:
        got = served(xs[n])
        assert got.shape == (n, HW, HW, 4) and got.dtype == torch.float32
        _close(got.numpy(), want[n][0 if softmax else 1], f"batch {n} softmax {softmax}")
        # the archive serves exactly what the live predictor computes
        assert torch.equal(got, live.predict(torch.from_numpy(xs[n]), N_ITER, softmax))


def test_cli_export_of_a_jax_checkpoint_matches_jax_predict(jax_case, tmp_path, capsys):
    """``cli.export --checkpoint`` of the JAX solver's msgpack directory,
    reloaded and called: JAX's probabilities; ``--logits``: its logits."""
    _, _, xs, want, ckpt = jax_case
    for logits in (False, True):
        out = str(tmp_path / f"p{int(logits)}.pt")
        argv = ["--checkpoint", ckpt, "--out", out, "--input_hw", str(HW), str(HW),
                "--device", "cpu", "--verify_batch", "3"] + (["--logits"] if logits else [])
        assert cli_export.main(argv) == out
        assert "verify: served(batch=3) -> (3, 32, 32, 4) torch.float32 on cpu" in (
            capsys.readouterr().out)
        served = serving.load_predictor(out, device="cpu")
        for n in BATCHES:
            _close(served(xs[n]).numpy(), want[n][int(logits)], f"cli batch {n} {logits}")


def test_archive_holds_the_configuration(tmp_path):
    """What the archive records, and that a predictor rebuilt from it has
    the same configuration and state, bf16 with ``conv_s2`` and
    ``conv_nl``."""
    live = CooperativePredictor(device="cpu", seed=2, compute_dtype=torch.bfloat16,
                                conv_s2=True, conv_nl=True,
                                network_type="FCN_16_standard_share_code")
    path = serving.export_predictor(live, str(tmp_path / "a.pt"), input_hw=(64, 48),
                                    n_iter=3, softmax=False)
    archive = serving.read_archive(path)
    assert {k: v for k, v in archive.items() if k != "state_dicts"} == {
        "format": serving.FORMAT, "version": serving.VERSION,
        "network_type": "FCN_16_standard_share_code", "image_ch": 1, "num_classes": 4,
        "temperature": 2.0, "widths": [16, 32, 64, 128, 128], "conv_s2": True,
        "conv_nl": True, "compute_dtype": "bfloat16", "n_iter": 3, "softmax": False,
        "input_hw": [64, 48]}
    rebuilt = serving.build_predictor(archive, device="cpu")
    assert (rebuilt.conv_s2, rebuilt.conv_nl, rebuilt.compute_dtype, rebuilt.network_type) == (
        True, True, torch.bfloat16, "FCN_16_standard_share_code")
    for (k, a), (_, b) in zip(live.state_dict().items(), rebuilt.state_dict().items()):
        assert torch.equal(a, b), k
    x = torch.rand(2, 64, 48, 1)
    served = serving.load_predictor(path, device="cpu")
    assert torch.equal(served(x), live.predict(x, n_iter=3))
    with pytest.raises(ValueError, match="exported for"):  # JAX's: one size, any batch
        served(torch.rand(2, 32, 32, 1))


def test_load_refuses_other_files_and_a_missing_card(tmp_path):
    torch.save({"format": "something else"}, tmp_path / "x.pt")
    with pytest.raises(ValueError, match="not a cooperative_predictor archive"):
        serving.load_predictor(str(tmp_path / "x.pt"), device="cpu")
    path = serving.export_predictor(CooperativePredictor(device="cpu"), str(tmp_path / "p"))
    archive = torch.load(path, weights_only=True)
    archive["version"] = serving.VERSION + 1
    torch.save(archive, tmp_path / "v.pt")
    with pytest.raises(ValueError, match="archive version"):
        serving.read_archive(str(tmp_path / "v.pt"))
    archive["version"] = serving.VERSION
    archive["widths"] = [16, 32, 64, 128, 256]
    torch.save(archive, tmp_path / "w.pt")
    with pytest.raises(ValueError, match="archive widths"):
        serving.load_predictor(str(tmp_path / "w.pt"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.load_predictor(path)
