"""The port's baseline networks against the JAX package's, on the CPU.

Every network of ``train/segmentation.py:NETWORK_REGISTRY``, in eval mode
and in train mode, on weights drawn with numpy from a seed in the JAX
layout (found with ``jax.eval_shape``) and carried over by
``convert.baseline_from_jax``, at 32x32, batch 2, 4 classes; the JAX side
jitted.  Outputs within ``2e-4 + 4e-6 max|ref|`` (the rule of
``test_torch_port_predict.py``); the running statistics and spectral-norm
``u``/``sigma`` a train-mode forward leaves within 1e-5 of each tensor's
scale (at least 1).  One bf16 network is held by ``assert_bf16_close``.
The extra networks (``DeeplySupervisedUNet``, the layer-dropout networks on
JAX's recorded keep masks, ``UNet3D``, ``DomainSpecificEncoder``) and the
layers are in ``test_torch_port_layers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.train.segmentation import (
    NETWORK_REGISTRY as JAX_REGISTRY,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.segmentation import (
    NETWORK_REGISTRY,
)
from torch_port_util import assert_bf16_close, one_torch_thread  # noqa: F401

HW, BATCH, CLASSES = 32, 2, 4


def _leaf(name, shape, rng):
    """A random leaf for a flax variable named ``name``."""
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
    if name in ("scale", "rho"):
        return rng.uniform(0.8, 1.2, shape) if name == "scale" else rng.uniform(0.2, 0.8, shape)
    if name in ("bias", "beta"):
        return rng.normal(0.0, 0.05, shape)
    if name == "gamma":
        return rng.uniform(0.5, 1.5, shape)
    if name == "mean":
        return rng.normal(0.0, 0.1, shape)
    if name in ("var", "Conv_0/kernel/sigma"):
        return rng.uniform(0.5, 1.5, shape)
    if name == "Conv_0/kernel/u":
        return rng.normal(0.0, 1.0, shape)
    raise KeyError(name)


def fill(tree, rng):
    """Numpy leaves for a tree of shapes, drawn in sorted key order."""
    return {k: (fill(v, rng) if hasattr(v, "items") else
                _leaf(k, v.shape, rng).astype(np.float32))
            for k, v in sorted(tree.items())}


def random_variables(module, sample_shape, seed=0, **kw):
    """(params, batch_stats) for a flax ``module`` from ``seed``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                jnp.zeros(sample_shape), **kw))
    rng = np.random.RandomState(seed)
    return fill(shapes["params"], rng), fill(shapes.get("batch_stats", {}), rng)


def load(port, params, stats):
    """Load the converted JAX weights into ``port`` (every key, strict)."""
    port.load_state_dict(convert.baseline_from_jax(port, params, stats))
    return port


def nchw(a):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def assert_output_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    tol = 2e-4 + 4e-6 * float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol, (what, err, tol)


def assert_stats_close(port, params, new_stats, what=""):
    """The port's buffers against the JAX forward's new ``batch_stats``."""
    want = convert.baseline_from_jax(port, params, new_stats)
    buffers = dict(port.named_buffers())
    assert buffers, what
    for k, got in buffers.items():
        w = want[k]
        tol = 1e-5 * max(1.0, float(w.abs().max()))
        err = float((got - w).abs().max())
        assert err <= tol, (what, k, err, tol)


def batch(seed=0, shape=(BATCH, HW, HW, 1)):
    return np.random.RandomState(100 + seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(NETWORK_REGISTRY))
def test_registry_network_matches_jax(name):
    """Eval-mode and train-mode forward, and the statistics a train-mode
    forward leaves."""
    flax_model = JAX_REGISTRY[name](CLASSES, 1)
    params, stats = random_variables(flax_model, (1, HW, HW, 1), train=False)
    port = load(NETWORK_REGISTRY[name](CLASSES, 1), params, stats)
    x = batch()
    variables = {"params": params, "batch_stats": stats}

    want = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(variables, x)
    port.eval()
    with torch.no_grad():
        got = port(nchw(x))
    assert_output_close(nhwc(got), want, f"{name} eval")

    want, new = jax.jit(lambda v, x: flax_model.apply(v, x, train=True,
                                                      mutable=["batch_stats"]))(variables, x)
    port.train()
    with torch.no_grad():
        got = port(nchw(x))
    assert_output_close(nhwc(got), want, f"{name} train")
    assert_stats_close(port, params, jax.tree.map(np.asarray, new["batch_stats"]), name)


def test_bf16_network_matches_jax():
    """SN_UNet_16 with bf16 convs, eval mode: held to JAX's own bf16
    precision (``assert_bf16_close``)."""
    f32, bf16 = JAX_REGISTRY["SN_UNet_16"](CLASSES, 1), JAX_REGISTRY["SN_UNet_16"](
        CLASSES, 1, dtype=jnp.bfloat16)
    params, stats = random_variables(f32, (1, HW, HW, 1), train=False)
    port = load(NETWORK_REGISTRY["SN_UNet_16"](CLASSES, 1, dtype=torch.bfloat16), params, stats)
    x = batch(1)
    variables = {"params": params, "batch_stats": stats}
    run = jax.jit(lambda v, x: (f32.apply(v, x, train=False), bf16.apply(v, x, train=False)))
    want32, want16 = run(variables, x)
    port.eval()
    with torch.no_grad():
        got = port(nchw(x))
    assert got.dtype == torch.float32
    assert_bf16_close(nhwc(got), want16, want32, "SN_UNet_16 bf16")
