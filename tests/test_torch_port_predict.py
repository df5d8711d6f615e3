"""The port's predictor against ``CooperativeTripletSolver`` (JAX): the FTN
forward, ``predict`` and ``slow_refinement``, at 32x32, batch 2, on shared
weights.  The JAX side runs its Pallas CHW conv in interpret mode; all its
variants are traced into one jitted function per dtype so that they
compile once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)
from torch_port_util import (
    BATCH,
    HW,
    assert_bf16_close,
    make_solver,
    pallas_interpret,
    random_variables,
)

PREDICT = [(1, False), (1, True), (2, False), (2, True)]          # (n_iter, softmax)
SLOW = [(0, False, 1e-4), (1, False, 1e-4), (2, False, 1e-4),      # (n_steps, auto_stop, tol)
        (1, True, 1e-4), (2, True, 1e-4), (1, True, 1e3), (2, True, 1e3)]


def _jax_outputs(solver, params, stats, x):
    def run(params, stats, x):
        (z_i, z_s), y0, _ = solver.fast_predict(params, stats, x)
        out = {"z_i": z_i, "z_s": z_s, "y0": y0}
        for n_iter, sm in PREDICT:
            out[f"predict-{n_iter}-{sm}"] = solver.predict(params, stats, x, n_iter, sm)
        for n_steps, auto, tol in SLOW:
            out[f"slow-{n_steps}-{auto}-{tol}"] = solver.slow_refinement(
                params, stats, y0, n_steps, auto, tol, save_internal_predicts=True)
        return out

    with pallas_interpret():
        return jax.device_get(jax.jit(run)(params, stats, x))


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX solver's outputs in f32 and in bf16, same weights and input."""
    x = np.random.RandomState(2).uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32)
    out = {}
    for dtype, jdt in (("float32", None), ("bfloat16", jnp.bfloat16)):
        solver = make_solver(jdt)
        params, stats = random_variables(solver, seed=0)
        out[dtype] = _jax_outputs(solver, params, stats, jnp.asarray(x))
    return params, stats, torch.from_numpy(x), out


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def case(request, jax_outputs):
    params, stats, x, want = jax_outputs
    bf16 = request.param == "bfloat16"
    port = CooperativePredictor(compute_dtype=torch.bfloat16 if bf16 else None,
                                device="cpu")
    port.load_state_dicts(convert.from_jax(params, stats))
    return request.param, port, x, want


def _close(dtype, got, want, key, pick=lambda v: v):
    """Compare ``got`` with JAX's output ``pick(want[dtype][key])``."""
    got = got.float().numpy()
    if dtype == "float32":
        ref = np.asarray(pick(want["float32"][key]), np.float32)
        # f32 rounding, amplified by the random networks: the FTN + STN of
        # predict(n_iter=2) come out 2.2e-6 of the output's scale apart
        atol = 2e-4 + 4e-6 * np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=key)
    else:
        assert_bf16_close(got, pick(want["bfloat16"][key]),
                          pick(want["float32"][key]), key)


def test_fast_predict(case):
    dtype, port, x, want = case
    with torch.no_grad():
        (z_i, z_s), y0 = port.fast_predict(x.permute(0, 3, 1, 2).contiguous())
    for got, key in ((z_i, "z_i"), (z_s, "z_s"), (y0, "y0")):
        _close(dtype, got.permute(0, 2, 3, 1), want, key)


@pytest.mark.parametrize("n_iter,softmax", PREDICT)
def test_predict(case, n_iter, softmax):
    dtype, port, x, want = case
    got = port.predict(x, n_iter=n_iter, softmax=softmax)
    assert got.shape == (BATCH, HW, HW, 4) and got.dtype == torch.float32
    _close(dtype, got, want, f"predict-{n_iter}-{softmax}")


@pytest.mark.parametrize("n_steps,auto_stop,tol", SLOW)
def test_slow_refinement(case, n_steps, auto_stop, tol):
    """Both packages refine the same logits: the JAX FTN's output."""
    dtype, port, _, want = case
    y0 = torch.from_numpy(np.array(want[dtype]["y0"], np.float32))
    got, internal = port.slow_refinement(y0, n_steps, auto_stop, tol,
                                         save_internal_predicts=True)
    key = f"slow-{n_steps}-{auto_stop}-{tol}"
    _close(dtype, got, want, key, lambda v: v[0])
    assert sorted(internal) == sorted(want[dtype][key][1])
    for k in internal:
        _close(dtype, internal[k][0], want, key, lambda v: v[1][k][0])


def test_k1_calls_per_predict(case, monkeypatch):
    """13 K1 convs per FTN forward and 13 per STN refinement (6 in an
    encoder, 7 in a decoder): 26 for predict(n_iter=2)."""
    _, port, x, _ = case
    calls = []
    plain = conv_chw.conv3x3_chw_plain
    monkeypatch.setattr(conv_chw, "conv3x3_chw_plain",
                        lambda *a: calls.append(a[0].shape[1:]) or plain(*a))
    port.predict(x, n_iter=1)
    assert len(calls) == 13
    port.predict(x, n_iter=2)
    assert len(calls) == 13 + 26
