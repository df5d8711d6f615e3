"""Eval-mode forward of the port's five subnetworks against the JAX
package's, with the same weights moved over by ``convert.from_jax``.

The JAX side runs its Pallas CHW conv in interpret mode on the CPU; the
port runs K1's plain version.  32x32 inputs, batch 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
)
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

DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(solver, seed=1):
    rng = np.random.RandomState(seed)
    lh, lw = solver.latent_hw
    z = lambda: rng.uniform(0, 2, (BATCH, lh, lw, solver.latent_ch)).astype(np.float32)
    seg = rng.uniform(0, 1, (BATCH, HW, HW, solver.num_classes)).astype(np.float32)
    return {
        "image_encoder": rng.uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32),
        "segmentation_decoder": z(),
        "shape_encoder": seg / seg.sum(-1, keepdims=True),
        "shape_decoder": z(),
        "image_decoder": z(),
    }


@pytest.fixture(scope="module")
def jax_outputs():
    """The JAX subnetworks' outputs in f32 and in bf16, same weights and
    inputs."""
    out = {}
    for dtype, (jdt, _) in DTYPES.items():
        solver = make_solver(jdt)
        params, stats = random_variables(solver, seed=0)
        inputs = _inputs(solver)

        def forward_all(params, stats, inputs, solver=solver):
            return {name: solver.modules[name].apply(
                {"params": params[name], "batch_stats": stats[name]}, inputs[name],
                train=False) for name in MODULE_NAMES}

        with pallas_interpret():
            out[dtype] = jax.device_get(jax.jit(forward_all)(params, stats, inputs))
    return params, stats, inputs, out


@pytest.fixture(scope="module", params=list(DTYPES))
def case(request, jax_outputs):
    params, stats, inputs, want = jax_outputs
    port = CooperativePredictor(compute_dtype=DTYPES[request.param][1], device="cpu")
    port.load_state_dicts(convert.from_jax(params, stats))
    return request.param, port, inputs, want


def _to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _check(dtype, got, want, want_f32, what):
    got = np.transpose(got.float().numpy(), (0, 2, 3, 1))
    if dtype == "float32":
        # tests/test_torch_parity.py's bound for these networks in f32
        np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=2e-4)
    else:
        assert_bf16_close(got, want, want_f32, what)


@pytest.mark.parametrize("name", MODULE_NAMES)
def test_subnetwork_forward(case, name):
    dtype, port, inputs, want = case
    with torch.no_grad():
        got = getattr(port, name)(_to_nchw(inputs[name]))
    if name == "image_encoder":                 # (z_i, z_s)
        for i in range(2):
            _check(dtype, got[i], want[dtype][name][i], want["float32"][name][i], name)
    else:
        _check(dtype, got, want[dtype][name], want["float32"][name], name)


def test_converter_fills_every_parameter(case):
    """from_jax's state dicts have exactly the port's keys and shapes."""
    _, port, _, _ = case
    solver = make_solver()
    sds = convert.from_jax(*random_variables(solver, seed=3))
    for name in MODULE_NAMES:
        mine = getattr(port, name).state_dict()
        assert set(sds[name]) == set(mine), name
        for k, v in sds[name].items():
            assert tuple(v.shape) == tuple(mine[k].shape), (name, k)


def test_conv_transpose_flip():
    """flax's k2s2 ConvTranspose and the port's agree through the converter
    on a single up stage (the image decoder's 'Conv2' upsample)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu.models import blocks as jblocks
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import blocks

    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 5, 6).astype(np.float32)
    kern = rng.randn(2, 2, 6, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    want = np.asarray(jblocks.ConvTranspose(6, (2, 2), strides=(2, 2)).apply(
        {"params": {"kernel": kern, "bias": bias}}, jnp.asarray(x)))
    up = blocks.ConvTranspose2x2(6, 6, None)
    up.load_state_dict(convert._conv_transpose({"kernel": kern, "bias": bias}))
    with torch.no_grad():
        got = up(_to_nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_batchnorm_eval_only():
    """Eval mode normalizes with the running statistics alone and keeps the
    input dtype.  (Train mode, ported with the train step, normalizes with
    the batch's: tests/test_torch_port_masking.py.)"""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
        BatchNorm,
    )

    bn = BatchNorm(4)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 4, 2, 2)
    train_out = bn(x)                      # batch statistics, running ones move
    assert train_out.abs().max() < 2 and not bn.running_mean.eq(0).all()
    bn.eval()
    with torch.no_grad():
        bn.running_mean.zero_()
        bn.running_var.fill_(1.0)
    torch.testing.assert_close(bn(x), x / (1 + 1e-5) ** 0.5)
    y = bn(torch.ones(1, 4, 2, 2, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16
