"""Gradients of the port's CHW 3x3 conv against the JAX package's custom
VJP ``ops/pallas_conv.py:conv3x3_chw_ad`` on its ``PALLAS_VJP=pallas``
route, run in interpret mode on the CPU: dx (kernel K1 on the flipped,
transposed kernel) and dw (kernel K2, ``_conv3x3_chw_dw``).

On the CPU the port's wrappers run the plain versions
(``conv3x3_chw_plain`` on :func:`flip_wall`, ``conv3x3_chw_dw_plain``);
the kernels are held against those on the card
(tests/test_torch_port_cuda.py and chip_smoke.py).  Also here: the
LeakyReLU gradient at 0 against flax's, and the autograd Function's
routing (dx only where the input needs it, bad input refused).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import pallas_conv as jconv
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import blocks
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
from torch_port_util import bf16_ulp

# (N, C_in, C_out, H, W): C_in = 1 and 4 (the encoders' first convs), every
# (C_in, C_out) pair of the step's K1 convs at 8-16 px, ragged and non-square
SHAPES = [
    (2, 1, 16, 16, 16), (2, 4, 16, 16, 16), (2, 16, 16, 16, 16), (2, 16, 32, 8, 8),
    (2, 32, 32, 8, 8), (2, 32, 64, 8, 8), (2, 64, 64, 8, 8), (2, 64, 32, 8, 8),
    (2, 32, 16, 8, 8), (3, 3, 5, 7, 13), (2, 20, 17, 9, 5), (2, 16, 4, 12, 10),
]


def _inputs(n, c_in, c_out, h, w, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c_in, h * w).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c_in, c_out) / np.sqrt(9 * c_in)).astype(np.float32)
    dy = rng.randn(n, c_out, h * w).astype(np.float32)
    return x, w_hwio, dy


def _jax_vjp(x, w_hwio, dy, h, w, dtype):
    """(dx (N, C_in, H*W), dw HWIO) of the JAX custom VJP, Pallas route,
    interpret mode."""
    jdt = jnp.dtype(dtype)
    _, vjp = jax.vjp(lambda x_, w_: jconv.conv3x3_chw_ad(x_, w_, h, w, True),
                     jnp.asarray(x, jdt), jnp.asarray(w_hwio, jdt))
    dx, dw = vjp(jnp.asarray(dy, jdt))
    return np.asarray(dx.astype(jnp.float32)), np.asarray(dw.astype(jnp.float32))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _atol(want, dtype):
    """f32: sums in another order.  bf16: both round the same f32 sums
    once, so at most one ulp of the output's scale apart."""
    scale = float(np.abs(want).max())
    return 1e-5 * scale if dtype == "float32" else bf16_ulp(scale)


@pytest.fixture(autouse=True)
def pallas_vjp_route(monkeypatch):
    monkeypatch.setenv("PALLAS_VJP", "pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", SHAPES)
def test_dx_and_dw_plain_match_pallas_vjp(n, c_in, c_out, h, w, dtype):
    x, w_hwio, dy = _inputs(n, c_in, c_out, h, w)
    want_dx, want_dw = _jax_vjp(x, w_hwio, dy, h, w, dtype)
    tdt = getattr(torch, dtype)
    w_all = conv_chw.weights_to_wall(_oihw(w_hwio)).to(tdt).contiguous()
    dx = conv_chw.conv3x3_chw_dx(torch.from_numpy(dy).to(tdt), w_all, h, w)
    assert dx.dtype == tdt and dx.shape == (n, c_in, h * w)
    np.testing.assert_allclose(dx.float().numpy(), want_dx, rtol=0,
                               atol=_atol(want_dx, dtype))
    dw = conv_chw.conv3x3_chw_dw(torch.from_numpy(x).to(tdt),
                                 torch.from_numpy(dy).to(tdt), h, w)
    assert dw.dtype == torch.float32 and dw.shape == (9 * c_in, c_out)
    # wall row t*C_in + i is HWIO [t // 3, t % 3, i]; JAX rounds dw to w's dtype
    got_dw = dw.to(tdt).float().reshape(3, 3, c_in, c_out).numpy()
    np.testing.assert_allclose(got_dw, want_dw, rtol=0, atol=_atol(want_dw, dtype))


def test_flip_wall_matches_jax_flip_w():
    _, w_hwio, _ = _inputs(1, 5, 7, 1, 1)
    got = conv_chw.flip_wall(conv_chw.weights_to_wall(_oihw(w_hwio)))
    want = jconv.weights_to_wall(jconv._flip_w(jnp.asarray(w_hwio)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_layer_gradients_match_jax(dtype):
    """The Conv layer's K1 route under autograd: input and OIHW weight
    gradients against ``jax.vjp`` of the JAX kernel on the same weights,
    with JAX's rounding of dw to the compute dtype."""
    n, c_in, c_out, h, w = 2, 6, 10, 9, 12
    x, w_hwio, dy = _inputs(n, c_in, c_out, h, w, seed=3)
    want_dx, want_dw = _jax_vjp(x, w_hwio, dy, h, w, dtype)
    tdt = getattr(torch, dtype)
    conv = conv_chw.Conv(c_in, c_out, 3, padding=1, dtype=tdt)
    with torch.no_grad():
        conv.weight.copy_(_oihw(w_hwio))
    xt = torch.from_numpy(x).reshape(n, c_in, h, w).requires_grad_(True)
    y = conv(xt)
    y.backward(torch.from_numpy(dy).reshape(n, c_out, h, w).to(tdt))
    np.testing.assert_allclose(xt.grad.reshape(n, c_in, h * w).numpy(), want_dx, rtol=0,
                               atol=_atol(want_dx, dtype))
    got_dw = conv.weight.grad.permute(2, 3, 1, 0).numpy()
    np.testing.assert_allclose(got_dw, want_dw, rtol=0, atol=_atol(want_dw, dtype))
    if dtype == "float32":  # the bias gradient is the sum of dy over (N, H, W)
        np.testing.assert_allclose(conv.bias.grad.numpy(), dy.sum((0, 2)), rtol=1e-5)


def test_dx_only_where_the_input_needs_it(monkeypatch):
    """An image or a label needs no input gradient: the backward then runs
    K2 alone, as the JAX package's VJP DCEs the unused dx."""
    calls = []
    for name in ("conv3x3_chw_dx", "conv3x3_chw_dw"):
        fn = getattr(conv_chw, name)
        monkeypatch.setattr(conv_chw, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    conv = conv_chw.Conv(3, 8, 3, padding=1)
    conv(torch.randn(2, 3, 8, 8)).sum().backward()
    assert calls == ["conv3x3_chw_dw"]
    calls.clear()
    conv(torch.randn(2, 3, 8, 8, requires_grad=True)).sum().backward()
    assert sorted(calls) == ["conv3x3_chw_dw", "conv3x3_chw_dx"]
    calls.clear()
    conv.weight.requires_grad_(False)
    conv(torch.randn(2, 3, 8, 8, requires_grad=True)).sum().backward()
    assert calls == ["conv3x3_chw_dx"]


@pytest.mark.parametrize("bad", ["float64", "mixed", "shape", "c_out", "noncontig"])
def test_dw_wrapper_rejects_bad_input(bad):
    x, dy, h, w = torch.randn(2, 4, 64), torch.randn(2, 8, 64), 8, 8
    if bad == "float64":
        x, dy = x.double(), dy.double()
    elif bad == "mixed":
        dy = dy.bfloat16()
    elif bad == "shape":
        h = 7
    elif bad == "c_out":
        dy = torch.randn(2, 65, 64)
    elif bad == "noncontig":
        x = torch.randn(2, 64, 4).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        conv_chw.conv3x3_chw_dw(x, dy, h, w)


def test_conv_autograd_refuses_bad_input():
    """The autograd Function checks its operands before it runs; it does
    not fall back to another conv."""
    with pytest.raises(TypeError):
        conv_chw.conv3x3_chw_ad(torch.randn(1, 2, 16, dtype=torch.float64),
                                torch.randn(3, 18, dtype=torch.float64), 4, 4)
    with pytest.raises(ValueError):
        conv_chw.conv3x3_chw_ad(torch.randn(1, 2, 16), torch.randn(3, 17), 4, 4)


def test_cpu_gradients_do_not_count_as_launches():
    before = (conv_chw.conv3x3_chw_dx.launches, conv_chw.conv3x3_chw_dw.launches)
    conv = conv_chw.Conv(3, 8, 3, padding=1)
    conv(torch.randn(2, 3, 8, 8, requires_grad=True)).sum().backward()
    assert (conv_chw.conv3x3_chw_dx.launches, conv_chw.conv3x3_chw_dw.launches) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaky_relu_value_and_gradient_match_flax(dtype):
    """flax's ``nn.leaky_relu`` is ``where(x >= 0, x, slope * x)``: its
    gradient at exactly 0 is 1 (``F.leaky_relu``'s is the slope)."""
    xs = np.asarray([0.0, -1.0, 1.0, -0.0, -3.5, 2.25], np.float32)
    jdt = jnp.dtype(dtype)
    want = np.asarray(fnn.leaky_relu(jnp.asarray(xs, jdt), 0.2).astype(jnp.float32))
    want_grad = np.asarray(jax.vmap(jax.grad(
        lambda v: fnn.leaky_relu(v, 0.2).astype(jnp.float32)))(jnp.asarray(xs, jdt))
        .astype(jnp.float32))
    x = torch.from_numpy(xs).to(getattr(torch, dtype)).requires_grad_(True)
    y = blocks.leaky_relu(x)
    y.float().sum().backward()
    np.testing.assert_array_equal(y.float().detach().numpy(), want)
    np.testing.assert_array_equal(x.grad.float().numpy(), want_grad)
    assert x.grad[0] == 1.0
