"""The port's ``predict(n_iter=2)`` with ``conv_nl=True``, alone and with
``conv_s2=True``, against the JAX package's ``PALLAS_CONV_NL=1`` (and
``PALLAS_CONV_S2=1``), run in interpret mode on the CPU, at 32x32, batch 2,
on shared weights, in float32 and bfloat16; and the port's ``conv_nl=True``
against its own default route.  The train step under the same
configuration: tests/test_torch_port_step_nl.py.

JAX's two switches are independent, and so are the port's: each flag
changes the route of its own convs only (K5 takes the large-channel 3x3
convs of the residual stages, K4 the <=64-channel stride-2 downsamples).
Bounds as in tests/test_torch_port_predict.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
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

CONFIGS = {"nl": dict(conv_nl=True), "nl+s2": dict(conv_nl=True, conv_s2=True)}


def _close_f32(got, want, what):
    """tests/test_torch_port_predict.py's f32 bound: rounding amplified by
    the random networks (FTN + STN)."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=2e-4 + 4e-6 * np.abs(want).max(), err_msg=what)


@pytest.fixture(scope="module")
def predict_case():
    """JAX's ``predict(n_iter=2)`` under ``PALLAS_CONV_NL=1``, and under it
    with ``PALLAS_CONV_S2=1``, in f32 and bf16 on the same weights and
    input."""
    x = np.random.RandomState(2).uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32)
    want = {}
    for config, flags in CONFIGS.items():
        for dtype, jdt in (("float32", None), ("bfloat16", jnp.bfloat16)):
            solver = make_solver(jdt)
            params, stats = random_variables(solver, seed=0)
            with pallas_interpret(s2=flags.get("conv_s2", False), nl=True):
                want[config, dtype] = np.asarray(jax.jit(
                    lambda p, s, xx, solver=solver: solver.predict(p, s, xx, 2, False))(
                        params, stats, jnp.asarray(x)), np.float32)
    return convert.from_jax(params, stats), torch.from_numpy(x), want


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_matches_jax_under_nl(predict_case, config, dtype):
    sds, x, want = predict_case
    port = CooperativePredictor(compute_dtype=getattr(torch, dtype) if dtype != "float32"
                                else None, device="cpu", **CONFIGS[config])
    port.load_state_dicts(sds)
    got = port.predict(x, n_iter=2).numpy()
    if dtype == "float32":
        _close_f32(got, want[config, "float32"], f"predict-2 under {config}")
    else:
        assert_bf16_close(got, want[config, "bfloat16"], want[config, "float32"],
                          f"predict-2 under {config} bf16")


def test_predict_nl_route_matches_default_route(predict_case):
    """f32: the K5 route and the F.conv2d route compute the same convs in
    another summation order."""
    sds, x, _ = predict_case
    got = {}
    for on in (False, True):
        port = CooperativePredictor(device="cpu", conv_nl=on)
        port.load_state_dicts(sds)
        got[on] = port.predict(x, n_iter=2).numpy()
    _close_f32(got[True], got[False], "conv_nl True vs False")
