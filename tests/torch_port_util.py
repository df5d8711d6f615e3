"""Shared set-up of the PyTorch port's parity tests (not a test module).

Parameters of the JAX solver are drawn with numpy from a seed, in the
shapes of its flax parameter tree (found with ``jax.eval_shape``, which
traces without compiling), so both packages get the same weights without
running the JAX initialisers.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
    CooperativeTripletSolver,
)

HW = 32
BATCH = 2


def make_solver(compute_dtype=None) -> CooperativeTripletSolver:
    return CooperativeTripletSolver(input_hw=(HW, HW), compute_dtype=compute_dtype)


def _draw(path, shape, rng):
    leaf = path[-1]
    if leaf == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
    if leaf == "scale":
        return rng.uniform(0.8, 1.2, shape)
    if leaf == "bias":
        return rng.normal(0.0, 0.05, shape)
    if leaf == "mean":
        return rng.normal(0.0, 0.1, shape)
    if leaf == "var":
        return rng.uniform(0.5, 1.5, shape)
    raise KeyError(path)


def _fill(tree, rng, path=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _fill(v, rng, path + (k,)) for k, v in sorted(tree.items())}
    return _draw(path, tree.shape, rng).astype(np.float32)


def random_variables(solver: CooperativeTripletSolver, seed: int = 0):
    """(params, batch_stats) for every module, numpy, from ``seed``."""
    h, w = solver.input_hw
    lh, lw = solver.latent_hw
    sample = {
        "image_encoder": (1, h, w, solver.image_ch),
        "segmentation_decoder": (1, lh, lw, solver.latent_ch),
        "image_decoder": (1, lh, lw, solver.latent_ch),
        "shape_encoder": (1, h, w, solver.num_classes),
        "shape_decoder": (1, lh, lw, solver.latent_ch),
    }
    rng = np.random.RandomState(seed)
    params, stats = {}, {}
    for name in MODULE_NAMES:
        shapes = jax.eval_shape(
            lambda m=solver.modules[name], s=sample[name]: m.init(
                jax.random.PRNGKey(0), jnp.zeros(s), train=False))
        params[name] = _fill(shapes["params"], rng)
        stats[name] = _fill(shapes["batch_stats"], rng)
    return params, stats


@contextlib.contextmanager
def pallas_interpret():
    """Run the JAX package's Pallas paths in interpret mode on the CPU (the
    switch is read when a function is traced)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_CONV_INTERPRET", "1")
        yield


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp at magnitude ``scale`` (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(scale)) - 7))


def assert_bf16_close(got, want_bf16, want_f32, what=""):
    """bf16 parity, held to the JAX package's own bf16 precision.

    Both packages round at the same points, but they sum in other orders,
    so single activations land one bf16 ulp apart and these random
    networks amplify such flips layer by layer.  The bound is what bf16
    itself costs the JAX package: the port may differ from JAX's bf16
    result by at most twice as much as that result differs from JAX's f32
    one, in the largest and in the mean absolute difference; and for class
    scores its argmax may disagree with JAX's bf16 argmax on at most twice
    the share of pixels where JAX's bf16 and f32 argmaxes disagree, plus
    0.5 %.
    """
    got = np.asarray(got, np.float32)
    want_bf16 = np.asarray(want_bf16, np.float32)
    want_f32 = np.asarray(want_f32, np.float32)
    assert got.shape == want_bf16.shape == want_f32.shape, what
    own = np.abs(want_bf16 - want_f32)
    diff = np.abs(got - want_bf16)
    assert diff.max() <= 2 * own.max(), (what, diff.max(), own.max())
    assert diff.mean() <= 2 * own.mean(), (what, diff.mean(), own.mean())
    if got.shape[-1] > 1:
        own_flip = np.mean(want_bf16.argmax(-1) != want_f32.argmax(-1))
        flip = np.mean(got.argmax(-1) != want_bf16.argmax(-1))
        assert flip <= 2 * own_flip + 0.005, (what, flip, own_flip)
