"""The port's output-blocked B8 conv (kernels K6, K6 on flipped weights for
dx, K6dw; ``ops/conv_b8.py``) against the JAX package's
``ops/pallas_conv_blocked.py``, run in interpret mode on the CPU:
``conv3x3_b8``, ``_b8_fwd_dispatch(dy, _flip_w(w))``, ``_conv3x3_b8_dw``
and the custom VJP ``conv3x3_b8_ad``, at JAX's own test shapes
(tests/test_pallas_conv_blocked.py:29-34); the blocked weights, the fold
of the dw wall and the shape gate against JAX's; and the port's
``bench_b8_conv`` entry on the CPU.

The port's plain versions compute the TPU kernel's blocked formulation
(P' @ W' per image, the fold after), so these tests hold the blocking and
the fold themselves.  On the CPU the wrappers run the plain versions; the
CUDA kernels (register-blocked, no P') are held against them on the card
(tests/test_torch_port_cuda.py and chip_smoke.py).

Tolerances: float32 within 1e-5 of the result's scale (the same f32 sums
in another order); bfloat16 outputs within one bf16 ulp of the scale (one
rounding of nearly the same f32 sums).  dw is float32 in both packages
from exact products, so it is held to 1e-5 of its scale in both dtypes.
bfloat16 runs batch 2 where JAX's shape has 1: XLA-CPU refuses the bf16 x
bf16 -> f32 dot of the interpreted dw kernel at batch 1 (as in
tests/test_torch_port_grad.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import (
    pallas_conv_blocked as jb8,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import bench_b8_conv
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    conv_b8,
    conv_chw,
)
from torch_port_util import bf16_ulp

# (N, H, W, C_in, C_out): JAX's test shapes
SHAPES = [(2, 16, 16, 16, 16), (1, 12, 16, 8, 4), (3, 8, 24, 16, 32), (2, 10, 32, 32, 16)]


def _inputs(n, h, w, c_in, c_out, dtype, seed=0):
    n = max(n, 2) if dtype == "bfloat16" else n
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c_in).astype(np.float32)                 # NHWC
    w_hwio = (0.2 * rng.randn(3, 3, c_in, c_out)).astype(np.float32)
    dy = rng.randn(n, h, w, c_out).astype(np.float32)
    return x, w_hwio, dy


def _chw(a_nhwc, tdt):
    n, h, w, c = a_nhwc.shape
    return torch.from_numpy(np.ascontiguousarray(
        a_nhwc.transpose(0, 3, 1, 2).reshape(n, c, h * w))).to(tdt)


def _nhwc(t, h, w):
    n, c, _ = t.shape
    return t.detach().float().reshape(n, c, h, w).permute(0, 2, 3, 1).numpy()


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _wall(w_hwio, tdt):
    return conv_chw.weights_to_wall(_oihw(w_hwio)).to(tdt).contiguous()


def _atol(want, dtype):
    scale = float(np.abs(want).max())
    return 1e-5 * scale if dtype == "float32" else bf16_ulp(scale)


def _j(a, dtype):
    return jnp.asarray(a, jnp.dtype(dtype))


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c_in,c_out", SHAPES)
def test_plain_k6_matches_pallas_kernel(n, h, w, c_in, c_out, dtype):
    x, w_hwio, _ = _inputs(n, h, w, c_in, c_out, dtype)
    want = _np(jb8.conv3x3_b8(_j(x, dtype), _j(w_hwio, dtype), interpret=True))
    tdt = getattr(torch, dtype)
    got = conv_b8.conv3x3_b8(_chw(x, tdt), _wall(w_hwio, tdt), h, w)
    assert got.dtype == tdt and got.shape == (x.shape[0], c_out, h * w)
    np.testing.assert_allclose(_nhwc(got, h, w), want, rtol=0, atol=_atol(want, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c_in,c_out", SHAPES)
def test_plain_k6dx_matches_pallas_kernel(n, h, w, c_in, c_out, dtype):
    _, w_hwio, dy = _inputs(n, h, w, c_in, c_out, dtype, seed=1)
    want = _np(jb8._b8_fwd_dispatch(_j(dy, dtype), jb8._flip_w(_j(w_hwio, dtype)), True))
    tdt = getattr(torch, dtype)
    got = conv_b8.conv3x3_b8_dx(_chw(dy, tdt), _wall(w_hwio, tdt), h, w)
    assert got.dtype == tdt and got.shape == (dy.shape[0], c_in, h * w)
    np.testing.assert_allclose(_nhwc(got, h, w), want, rtol=0, atol=_atol(want, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,w,c_in,c_out", SHAPES)
def test_plain_k6dw_matches_pallas_kernel(n, h, w, c_in, c_out, dtype):
    x, _, dy = _inputs(n, h, w, c_in, c_out, dtype, seed=2)
    nb = x.shape[0]
    want = _np(jb8._conv3x3_b8_dw(_j(x, dtype).reshape(nb, h * w // 8, 8 * c_in),
                                  _j(dy, dtype).reshape(nb, h * w // 8, 8 * c_out),
                                  H=h, W=w, C=c_in, interpret=True))
    tdt = getattr(torch, dtype)
    got = conv_b8.conv3x3_b8_dw(_chw(x, tdt), _chw(dy, tdt), h, w)
    assert got.dtype == torch.float32 and got.shape == (9 * c_in, c_out)
    np.testing.assert_allclose(got.reshape(3, 3, c_in, c_out).numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("c_in,c_out", [(16, 16), (8, 4), (3, 5)])
def test_blocked_weights_and_fold_match_jax(c_in, c_out):
    """W' and the fold of a (30*C_in, 8*C_out) wall are JAX's, exactly (both
    are copies and f32 sums in the same order)."""
    rng = np.random.RandomState(c_in)
    w_hwio = rng.randn(3, 3, c_in, c_out).astype(np.float32)
    np.testing.assert_array_equal(
        conv_b8.blocked_weights(torch.from_numpy(w_hwio)).numpy(),
        np.asarray(jb8.blocked_weights(jnp.asarray(w_hwio))))
    wall = rng.randn(30 * c_in, 8 * c_out).astype(np.float32)
    np.testing.assert_array_equal(
        conv_b8.fold_dw_wall(torch.from_numpy(wall), c_in, c_out).numpy(),
        np.asarray(jb8.fold_dw_wall(jnp.asarray(wall), c_in, c_out)))


def test_edge_tap_counts():
    """JAX's own check: an all-ones input and kernel count the in-image
    taps (corners 4, edges 6, interior 9), across the block seam too."""
    h, w, c = 8, 16, 8
    out = conv_b8.conv3x3_b8(torch.ones(1, c, h * w), torch.ones(2, 9 * c), h, w)
    out = out[0, 0].reshape(h, w)
    assert out[0, 0] == 4 * c and out[0, -1] == 4 * c
    assert out[0, 5] == 6 * c and out[3, 0] == 6 * c
    assert out[3, 7] == 9 * c and out[3, 8] == 9 * c


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_b8_ad_gradients_match_jax_vjp(dtype, monkeypatch):
    """``conv3x3_b8_ad`` runs K6 forward and K6 dx and K6dw backward, and
    its output and its input and wall gradients match ``jax.vjp`` of
    ``conv3x3_b8_ad``, with JAX's rounding of dw to the weight's dtype."""
    n, h, w, c_in, c_out = 2, 8, 16, 16, 32
    x, w_hwio, dy = _inputs(n, h, w, c_in, c_out, dtype, seed=3)
    want_y, vjp = jax.vjp(lambda a, b: jb8.conv3x3_b8_ad(a, b, True),
                          _j(x, dtype), _j(w_hwio, dtype))
    want_dx, want_dw = (_np(g) for g in vjp(_j(dy, dtype)))
    want_y = _np(want_y)
    calls = []
    for name in ("conv3x3_b8", "conv3x3_b8_dx", "conv3x3_b8_dw"):
        fn = getattr(conv_b8, name)
        monkeypatch.setattr(conv_b8, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    tdt = getattr(torch, dtype)
    xt = _chw(x, tdt).requires_grad_(True)
    wt = _wall(w_hwio, tdt).requires_grad_(True)
    y = conv_b8.conv3x3_b8_ad(xt, wt, h, w)
    y.backward(_chw(dy, tdt))
    assert sorted(calls) == ["conv3x3_b8", "conv3x3_b8_dw", "conv3x3_b8_dx"]
    np.testing.assert_allclose(_nhwc(y, h, w), want_y, rtol=0, atol=_atol(want_y, dtype))
    assert xt.grad.dtype == tdt and wt.grad.dtype == tdt
    np.testing.assert_allclose(_nhwc(xt.grad, h, w), want_dx, rtol=0,
                               atol=_atol(want_dx, dtype))
    got_dw = wt.grad.float().reshape(c_out, 3, 3, c_in).permute(1, 2, 3, 0).numpy()
    np.testing.assert_allclose(got_dw, want_dw, rtol=0, atol=_atol(want_dw, dtype))


def test_plain_versions_match_torch_conv():
    """The plain forward, dx and dw are the SAME 3x3 conv's value and
    gradients (``F.conv2d`` under float64 autograd)."""
    n, c_in, c_out, h, w = 2, 8, 12, 6, 24
    rng = np.random.RandomState(5)
    x4 = torch.from_numpy(rng.randn(n, c_in, h, w)).requires_grad_(True)
    w4 = torch.from_numpy(0.2 * rng.randn(c_out, c_in, 3, 3)).requires_grad_(True)
    y = F.conv2d(x4, w4, None, 1, 1)
    dy = torch.from_numpy(rng.randn(*y.shape))
    y.backward(dy)
    wall = conv_chw.weights_to_wall(w4.detach()).float().contiguous()
    xf = x4.detach().float().reshape(n, c_in, -1)
    dyf = dy.float().reshape(n, c_out, -1)
    for got, want in ((conv_b8.conv3x3_b8(xf, wall, h, w), y.detach().reshape(n, c_out, -1)),
                      (conv_b8.conv3x3_b8_dx(dyf, wall, h, w), x4.grad.reshape(n, c_in, -1)),
                      (conv_b8.conv3x3_b8_dw(xf, dyf, h, w),
                       conv_chw.weights_to_wall(w4.grad).t())):
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("h,w,c_in,c_out", [(16, 16, 16, 16), (1, 16, 16, 16), (16, 12, 16, 16),
                                            (16, 16, 4, 16), (16, 16, 64, 64), (16, 16, 65, 8),
                                            (16, 16, 8, 65), (2, 8, 8, 1)])
def test_gate_matches_jax(h, w, c_in, c_out):
    assert conv_b8.b8_eligible(h, w, c_in, c_out) == jb8.b8_eligible(h, w, c_in, c_out)


@pytest.mark.parametrize("bad", ["float64", "mixed", "shape", "gate", "noncontig", "device"])
@pytest.mark.parametrize("which", ["fwd", "dx", "dw"])
def test_wrappers_reject_bad_input(which, bad):
    n, c_in, c_out, h, w = 2, 8, 16, 4, 16
    a = torch.randn(n, c_in, h * w) if which != "dx" else torch.randn(n, c_out, h * w)
    b = {"fwd": torch.randn(c_out, 9 * c_in), "dx": torch.randn(c_out, 9 * c_in),
         "dw": torch.randn(n, c_out, h * w)}[which]
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "shape":
        a = a[:, :, :-1].contiguous()
    elif bad == "gate":             # W not a multiple of 8
        w = 12
        a = torch.randn(a.shape[0], a.shape[1], h * w)
        if which == "dw":
            b = torch.randn(n, c_out, h * w)
    elif bad == "noncontig":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":           # no kernel for a device other than the card
        a, b = a.to("meta"), b.to("meta")
    fn = {"fwd": conv_b8.conv3x3_b8, "dx": conv_b8.conv3x3_b8_dx, "dw": conv_b8.conv3x3_b8_dw}
    with pytest.raises((TypeError, ValueError)):
        fn[which](a, b, h, w)


def test_cpu_calls_do_not_count_as_launches():
    fns = (conv_b8.conv3x3_b8, conv_b8.conv3x3_b8_dx, conv_b8.conv3x3_b8_dw)
    before = [f.launches for f in fns]
    x = torch.randn(2, 8, 64, requires_grad=True)
    w_all = torch.randn(8, 72, requires_grad=True)
    conv_b8.conv3x3_b8_ad(x, w_all, 8, 8).sum().backward()
    assert [f.launches for f in fns] == before


def test_kernel_binding_declares_pointer_arguments(monkeypatch):
    """ctypes passes an undeclared argument as a 32-bit int, which would cut
    the tensors' device pointers and the stream handle."""
    import ctypes
    import types

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels

    libc = ctypes.CDLL(None)
    fake = types.SimpleNamespace(**{name: getattr(libc, f) for name, f in (
        ("conv3x3_b8", "labs"), ("conv3x3_b8_dw", "llabs"),
        ("conv3x3_b8_dw_workspace", "atoi"))})
    monkeypatch.setattr(kernels, "load", lambda name: fake)
    # conv3x3_b8: n, c_in, c_out, h, w, flip, is_bf16; conv3x3_b8_dw: no flip
    for name, n_ptr, n_int in (("conv3x3_b8", 3, 7), ("conv3x3_b8_dw", 4, 6)):
        fn = conv_b8._fn(name)
        assert fn.restype is ctypes.c_int
        assert fn.argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert fn.argtypes[n_ptr:-1] == [ctypes.c_int] * n_int
        assert fn.argtypes[-1] is ctypes.c_void_p
    ws = conv_b8._fn("conv3x3_b8_dw_workspace")
    assert ws.restype is ctypes.c_longlong and ws.argtypes == [ctypes.c_int] * 5


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bench_runs_on_the_cpu(dtype, capsys):
    """``bench_b8_conv`` on the CPU at batch 1: the five stages of JAX's
    bench, the B8 route checked against the CHW route, one JSON line a
    stage, and every time "not measured" (a CPU run gives no device time);
    the bounds come from the shapes."""
    assert bench_b8_conv.STAGES == [(192, 16, 16), (96, 16, 32), (96, 32, 32),
                                    (48, 32, 64), (48, 64, 64)]
    recs = bench_b8_conv.run(batch=1, dtype=dtype, device="cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == recs and [r["stage"] for r in recs] == [
        "192^2 16->16", "96^2 16->32", "96^2 32->32", "48^2 32->64", "48^2 64->64"]
    for r in recs:
        assert all(r[f"{v}_ms"] == "not measured"
                   for v in ("b8", "chw", "cudnn", "b8_vjp", "chw_vjp", "cudnn_vjp"))
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert r["dtype"] == dtype and r["device"] == "cpu"
    # 48^2 64->64, batch 1: x, w and y in 2 or 4 bytes against 2*9*64*64*48^2 flops
    es = 2 if dtype == "bfloat16" else 4
    nbytes = (64 * 48 * 48 * 2 + 64 * 9 * 64) * es
    flops = 2.0 * 48 * 48 * 9 * 64 * 64
    want = max(nbytes / 3.35e12, flops / bench_b8_conv.PEAK_FLOPS[dtype]) * 1e3
    assert recs[4]["bound_ms"] == pytest.approx(want)
