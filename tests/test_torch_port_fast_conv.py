"""The port's staircase conv (``ops/fast_conv.py``) against the JAX
package's and against ``F.conv2d``.

``pick_pack_factor`` must equal JAX's on a grid of widths and channel
counts.  ``staircase_conv3x3`` (NCHW, OIHW) against JAX's (NHWC, HWIO) on
the same numbers, and against ``F.conv2d``, at the shapes the packing
takes (f = 2 for 64->128 @ 48 wide; f = 8 and 16 for the 16- and
8-channel convs): forward and the gradients of x and w.  Tolerances:
float32 within 1e-5 of the output's (gradient's) scale, sums of at most
9 C_in terms an output and N H W a weight gradient in other orders;
bfloat16 within twice what bf16 itself costs ``F.conv2d`` against float32,
plus one ulp of the scale (the staircase rounds the packed conv's output
and adds the corrections in bf16, where JAX does).  Then the staircase
and correction matrices, block by block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import (
    fast_conv as jax_fast_conv,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import fast_conv
from torch_port_util import bf16_ulp, one_torch_thread  # noqa: F401

SHAPES = [(2, 64, 128, 6, 48), (2, 16, 16, 8, 32), (1, 8, 24, 4, 32), (2, 128, 64, 6, 24)]


def _inputs(n, c_in, c_out, h, w, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-0.5, 0.5, (n, c_in, h, w)).astype(np.float32)
    k = (rng.uniform(-0.5, 0.5, (c_out, c_in, 3, 3)) / (3 * np.sqrt(c_in))).astype(np.float32)
    return x, k


def test_pick_pack_factor_equals_jax():
    for width in (12, 24, 32, 48, 96, 192, 7):
        for cin in (1, 4, 8, 16, 32, 64, 96, 128, 256):
            for cout in (4, 16, 32, 64, 128):
                assert fast_conv.pick_pack_factor(width, cin, cout) == \
                    jax_fast_conv.pick_pack_factor(width, cin, cout), (width, cin, cout)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_staircase_matches_jax_and_conv2d_f32(shape):
    n, c_in, c_out, h, w = shape
    x, k = _inputs(n, c_in, c_out, h, w)
    f = fast_conv.pick_pack_factor(w, c_in, c_out)
    assert f > 1
    dy = np.random.RandomState(1).uniform(0, 1, (n, c_out, h, w)).astype(np.float32)

    def jax_fn(x_nhwc, k_hwio):
        return jax_fast_conv.staircase_conv3x3(x_nhwc, k_hwio, f=f)

    x_nhwc, k_hwio = jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(k.transpose(2, 3, 1, 0))
    y_j, vjp = jax.vjp(jax_fn, x_nhwc, k_hwio)
    dx_j, dk_j = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))
    want = {"y": np.asarray(y_j).transpose(0, 3, 1, 2),
            "dx": np.asarray(dx_j).transpose(0, 3, 1, 2),
            "dw": np.asarray(dk_j).transpose(3, 2, 0, 1)}
    for name, fn in (("staircase", lambda a, b: fast_conv.staircase_conv3x3(a, b, f=f)),
                     ("conv2d", lambda a, b: F.conv2d(a, b, padding=1))):
        xt = torch.from_numpy(x).requires_grad_()
        kt = torch.from_numpy(k).requires_grad_()
        y = fn(xt, kt)
        y.backward(torch.from_numpy(dy))
        got = {"y": y.detach().numpy(), "dx": xt.grad.numpy(), "dw": kt.grad.numpy()}
        for key in got:
            scale = np.abs(want[key]).max()
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-5 * scale,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("shape", SHAPES[:2], ids=lambda s: "x".join(map(str, s)))
def test_staircase_bf16_matches_jax_and_conv2d(shape):
    n, c_in, c_out, h, w = shape
    x, k = _inputs(n, c_in, c_out, h, w, seed=2)
    ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(k), padding=1)
    xb, kb = torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16()
    own = (F.conv2d(xb, kb, padding=1).float() - ref).abs().max().item()
    got = fast_conv.staircase_conv3x3(xb, kb)
    assert got.dtype == torch.bfloat16
    y_j = jax_fast_conv.staircase_conv3x3(jnp.asarray(x.transpose(0, 2, 3, 1), jnp.bfloat16),
                                          jnp.asarray(k.transpose(2, 3, 1, 0), jnp.bfloat16))
    jax_y = torch.from_numpy(np.asarray(y_j, np.float32).transpose(0, 3, 1, 2))
    ulp = bf16_ulp(ref.abs().max().item())
    for what, y in (("port", got.float()), ("jax", jax_y)):
        assert (y - ref).abs().max().item() <= 2 * own + ulp, what
    assert (got.float() - jax_y).abs().max().item() <= 2 * own + ulp


def test_unpacked_shapes_fall_back_to_conv2d():
    x, k = _inputs(1, 128, 128, 4, 12)
    assert fast_conv.pick_pack_factor(12, 128, 128) == 1
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    assert torch.equal(fast_conv.staircase_conv3x3(xt, kt), F.conv2d(xt, kt, padding=1))
    with pytest.raises(ValueError, match="not divisible"):
        fast_conv.staircase_conv3x3(xt, kt, f=5)


@pytest.mark.parametrize("f", [2, 3, 8])
def test_staircase_and_correction_matrices_hold_the_taps(f):
    """Block (s, s') of the staircase is tap kj = s' - s + 1 of ``w`` where
    that tap exists and zero elsewhere; the correction matrix is the block
    diagonal of the taps kj = 0 and kj = 2."""
    c_in, c_out = 3, 5
    _, k = _inputs(1, c_in, c_out, 1, 1, seed=4)
    w = torch.from_numpy(k)
    m = fast_conv.staircase_matrix(w, f)
    assert m.shape == (f * c_out, f * c_in, 3, 1)
    for s in range(f):
        for sp in range(f):
            block = m[s * c_out:(s + 1) * c_out, sp * c_in:(sp + 1) * c_in, :, 0]
            kj = sp - s + 1
            want = w[:, :, :, kj] if 0 <= kj <= 2 else torch.zeros_like(block)
            assert torch.equal(block, want), (s, sp)
    c = fast_conv.correction_matrix(w)
    assert c.shape == (2 * c_out, 2 * c_in, 3, 1)
    assert torch.equal(c[:c_out, :c_in, :, 0], w[:, :, :, 0])
    assert torch.equal(c[c_out:, c_in:, :, 0], w[:, :, :, 2])
    assert not c[:c_out, c_in:].any() and not c[c_out:, :c_in].any()
