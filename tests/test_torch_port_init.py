"""The port's initial weights are drawn from the JAX package's distributions.

``train/predictor.py:init_parameters`` draws every conv and transposed-conv
kernel from flax's ``he_normal`` (``models/blocks.py:49``): a normal of std
``s = sqrt(2 / fan_in) / 0.87962566...`` truncated at +-2 s, so its std is
``sqrt(2 / fan_in)`` and no weight exceeds ``CUT`` = 2 / 0.87962566... =
2.2737 times it, with fan_in = C_in kh kw (flax reads a (kh, kw, C_in,
C_out) kernel with ``in_axis=-2``, the transposed conv's too); BN scales
from 1 + 0.02 N(0, 1) (``models/blocks.py:79-82``).

Held on the full-width predictor (FCN_16, seed 0) and on the JAX solver's
own initialised parameters, with z = w / sqrt(2 / fan_in):

- every kernel: max |z| <= CUT (a float32 rounding above it allowed);
- kernels of at least ``LARGE`` = 100,000 weights: max |z| > 2.2 (the cut
  is reached, not a narrower one);
- the std of z, per kernel of at least ``STD_MIN`` = 10,000 weights and
  pooled over all kernels: within 5 standard errors of 1, the standard
  error of a sample std of the truncated unit normal being
  ``sqrt((kurtosis - 1) / (4 n))``; the pooled mean within 5 standard
  errors of 0;
- the BN scales, pooled: mean within 5 standard errors of 1, std within 5
  of 0.02.
"""

import math

import jax
import numpy as np
import pytest
import torch
from scipy import stats

from cooperative_training_and_latent_space_data_augmentation_tpu.models.blocks import (
    conv_kernel_init,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BatchNorm,
    ConvTranspose2x2,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import Conv
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    TRUNC_STD,
    CooperativePredictor,
    init_parameters,
)

CUT = 2.0 / TRUNC_STD
LARGE = 100_000
STD_MIN = 10_000
N_SE = 5.0
# the truncated unit normal's std and kurtosis (its fourth moment over the
# squared variance), for the standard errors
_TN = stats.truncnorm(-2.0, 2.0)
KURTOSIS = float(_TN.stats(moments="k")) + 3.0


def _z_std_se(n: int) -> float:
    return math.sqrt((KURTOSIS - 1.0) / (4.0 * n))


def _port_kernels(seed: int):
    """[(z, fan_in, kind)] of every kernel of a port predictor."""
    model = CooperativePredictor(device="cpu", seed=seed)
    out = []
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose2x2)):
            w = m.weight.detach().numpy().astype(np.float64)
            fan_in = (w.shape[0] if isinstance(m, ConvTranspose2x2) else w.shape[1]) \
                * w.shape[2] * w.shape[3]
            out.append((w / math.sqrt(2.0 / fan_in), fan_in, type(m).__name__))
    return model, out


def _jax_kernels():
    """[(z, fan_in, name)] of every kernel of the JAX solver's initialised
    parameters, fan_in = kh kw C_in of its (kh, kw, C_in, C_out) kernel."""
    state = CooperativeTripletSolver(input_hw=(32, 32)).init_state(jax.random.PRNGKey(0))
    out = []

    def walk(tree, path):
        for k, v in tree.items():
            if hasattr(v, "items"):
                walk(v, path + (k,))
            elif k == "kernel":
                w = np.asarray(v, np.float64)
                fan_in = int(np.prod(w.shape[:-1]))
                out.append((w / math.sqrt(2.0 / fan_in), fan_in, "/".join(path)))

    walk(state.params, ())
    return state, out


def _check_kernels(kernels, what):
    pooled = np.concatenate([z.ravel() for z, _, _ in kernels])
    for z, fan_in, name in kernels:
        top = float(np.abs(z).max())
        assert top <= CUT * (1 + 1e-6), (what, name, z.shape, top)
        if z.size >= LARGE:
            assert top > 2.2, (what, name, z.shape, top)
        if z.size >= STD_MIN:
            assert abs(z.std() - 1.0) <= N_SE * _z_std_se(z.size), (what, name, z.std())
    assert abs(pooled.std() - 1.0) <= N_SE * _z_std_se(pooled.size), (what, pooled.std())
    assert abs(pooled.mean()) <= N_SE / math.sqrt(pooled.size), (what, pooled.mean())
    return pooled


@pytest.mark.parametrize("seed", [0, 40])
def test_port_kernels_hold_jax_std_and_cut(seed):
    model, kernels = _port_kernels(seed)
    pooled = _check_kernels(kernels, "port")
    print(f"seed {seed}: {len(kernels)} kernels, {pooled.size} weights, pooled std "
          f"{pooled.std():.5f}, max |z| {np.abs(pooled).max():.5f} (cut {CUT:.5f})")
    scales = np.concatenate([m.weight.detach().numpy() for m in model.modules()
                             if isinstance(m, BatchNorm)]).astype(np.float64)
    n = scales.size
    assert abs(scales.mean() - 1.0) <= N_SE * 0.02 / math.sqrt(n)
    assert abs(scales.std() - 0.02) <= N_SE * 0.02 / math.sqrt(2.0 * n)
    for m in model.modules():
        if isinstance(m, (Conv, ConvTranspose2x2)):
            assert not m.bias.any()


def test_jax_initialised_kernels_hold_the_same_std_and_cut():
    """The JAX solver's own kernels pass the same checks with the port's
    fan_in rule, and both packages have the same kernels (shapes, fan_ins)."""
    _, jax_kernels = _jax_kernels()
    pooled = _check_kernels(jax_kernels, "jax")
    _, port_kernels = _port_kernels(0)
    assert sorted((z.size, f) for z, f, _ in port_kernels) == sorted(
        (z.size, f) for z, f, _ in jax_kernels)
    print(f"JAX: {len(jax_kernels)} kernels, pooled std {pooled.std():.5f}, max |z| "
          f"{np.abs(pooled).max():.5f}")


def test_transposed_conv_fan_in_is_its_input_channels():
    """flax's he_normal on a (2, 2, C_in, C_out) kernel with C_in != C_out
    (the JAX package's ConvTranspose initialiser) has the std of fan_in =
    4 C_in, not 4 C_out: the port's rule for ConvTranspose2x2."""
    for c_in, c_out in ((16, 128), (128, 16)):
        w = np.asarray(conv_kernel_init(jax.random.PRNGKey(1), (2, 2, c_in, c_out)), np.float64)
        z = w / math.sqrt(2.0 / (4 * c_in))
        assert abs(z.std() - 1.0) <= N_SE * _z_std_se(z.size), (c_in, c_out, z.std())
        assert np.abs(z).max() <= CUT * (1 + 1e-6)
        layer = ConvTranspose2x2(c_in, c_out, None)
        init_parameters(layer, 3)
        t = layer.weight.detach().numpy().astype(np.float64) / math.sqrt(2.0 / (4 * c_in))
        assert abs(t.std() - 1.0) <= N_SE * _z_std_se(t.size), (c_in, c_out, t.std())
        assert np.abs(t).max() <= CUT * (1 + 1e-6)


def test_draws_follow_the_seed():
    a, b, c = (CooperativePredictor(device="cpu", seed=s) for s in (5, 5, 6))
    for x, y, z in zip(a.state_dict().values(), b.state_dict().values(),
                       c.state_dict().values()):
        assert torch.equal(x, y)
    assert not torch.equal(a.image_encoder.general_encoder.inc[0].weight,
                           c.image_encoder.general_encoder.inc[0].weight)
