"""The port's stride-2 phase conv (kernels K4, K4dx, K4dw; ``ops/conv_s2.py``)
against the JAX package's ``ops/pallas_conv.py`` stride-2 kernels, run in
interpret mode on the CPU: ``conv3x3s2_phase`` on the phase-split input,
``_conv3x3s2_phase_dx`` merged back, ``_conv3x3s2_phase_dw`` and the custom
VJP ``conv3x3s2_phase_ad``.  The port reads the unsplit (N, C, H*W) input
with stride-2 indexing, so ``conv3x3s2(x)`` is held against
``conv3x3s2_phase(chw_phase_split(x))`` and ``conv3x3s2_dx(dy)`` against
``chw_phase_merge(_conv3x3s2_phase_dx(dy))``.

On the CPU the wrappers run their plain versions; the kernels are held
against those on the card (tests/test_torch_port_cuda.py and
chip_smoke.py).  Also here: the routing of ``ResConvDown`` against the JAX
gate ``s2_chain_ok``, the input checks, and that the parameters, and so
``convert.from_jax``, are the same under both routes.

Tolerances: float32 within 1e-5 of the result's scale (the same f32 sums
in another order); bfloat16 outputs within one bf16 ulp of the scale (one
rounding of nearly the same f32 sums).  dw is float32 in both packages
from exact products, so it is held to 1e-5 of its scale in both dtypes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import pallas_conv as jconv
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    ResConvDown,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    conv_chw,
    conv_s2,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
    CooperativePredictor,
)
from torch_port_util import bf16_ulp, make_solver, pallas_interpret, random_variables

# (N, C_in, C_out, H, W): the model's two K4 downsamples at test size, the
# non-square 16x12 of the JAX package's own test, a ragged input-channel
# group and C_out bucket, the channel cutoff, and one output pixel
SHAPES = [
    (2, 16, 16, 32, 32), (2, 32, 32, 16, 16), (2, 3, 5, 16, 12),
    (2, 20, 17, 10, 6), (2, 64, 64, 8, 8), (2, 1, 4, 2, 2),
]


def _inputs(n, c_in, c_out, h, w, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, c_in, h * w).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c_in, c_out) / np.sqrt(9 * c_in)).astype(np.float32)
    dy = rng.randn(n, c_out, (h // 2) * (w // 2)).astype(np.float32)
    return x, w_hwio, dy


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
@pytest.mark.parametrize("n,c_in,c_out,h,w", SHAPES)
def test_plain_k4_matches_pallas_kernel(n, c_in, c_out, h, w, dtype):
    x, w_hwio, _ = _inputs(n, c_in, c_out, h, w)
    want = _np(jconv.conv3x3s2_phase(jconv.chw_phase_split(_j(x, dtype), h, w),
                                     _j(w_hwio, dtype), H=h, W=w, interpret=True))
    tdt = getattr(torch, dtype)
    got = conv_s2.conv3x3s2(torch.from_numpy(x).to(tdt), _wall(w_hwio, tdt), h, w)
    assert got.dtype == tdt and got.shape == (n, c_out, (h // 2) * (w // 2))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_atol(want, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", SHAPES)
def test_plain_k4dx_matches_pallas_kernel(n, c_in, c_out, h, w, dtype):
    _, w_hwio, dy = _inputs(n, c_in, c_out, h, w, seed=1)
    dxp = jconv._conv3x3s2_phase_dx(_j(dy, dtype), _j(w_hwio, dtype), H=h, W=w,
                                    interpret=True)
    want = _np(jconv.chw_phase_merge(dxp, h // 2, w // 2))
    tdt = getattr(torch, dtype)
    got = conv_s2.conv3x3s2_dx(torch.from_numpy(dy).to(tdt), _wall(w_hwio, tdt), h, w)
    assert got.dtype == tdt and got.shape == (n, c_in, h * w)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=_atol(want, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", SHAPES)
def test_plain_k4dw_matches_pallas_kernel(n, c_in, c_out, h, w, dtype):
    x, _, dy = _inputs(n, c_in, c_out, h, w, seed=2)
    want = _np(jconv._conv3x3s2_phase_dw(jconv.chw_phase_split(_j(x, dtype), h, w),
                                         _j(dy, dtype), H=h, W=w, interpret=True))
    tdt = getattr(torch, dtype)
    got = conv_s2.conv3x3s2_dw(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
                               h, w)
    assert got.dtype == torch.float32 and got.shape == (9 * c_in, c_out)
    # wall row t*C_in + i is HWIO [t // 3, t % 3, i]
    np.testing.assert_allclose(got.reshape(3, 3, c_in, c_out).numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_plain_versions_match_torch_stride2_conv():
    """The plain forward, dx and dw are the stride-2 pad-1 conv's value and
    gradients (``F.conv2d`` under float64 autograd)."""
    n, c_in, c_out, h, w = 2, 5, 7, 10, 14
    x, w_hwio, _ = _inputs(n, c_in, c_out, h, w, seed=5)
    x4 = torch.from_numpy(x).double().reshape(n, c_in, h, w).requires_grad_(True)
    w4 = _oihw(w_hwio).double().requires_grad_(True)
    y = F.conv2d(x4, w4, None, 2, 1)
    dy = torch.randn(y.shape, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    y.backward(dy)
    wall = _wall(w_hwio, torch.float32)
    dyf = dy.float().reshape(n, c_out, -1)
    got_y = conv_s2.conv3x3s2(torch.from_numpy(x), wall, h, w)
    got_dx = conv_s2.conv3x3s2_dx(dyf, wall, h, w)
    got_dw = conv_s2.conv3x3s2_dw(torch.from_numpy(x), dyf, h, w)
    torch.testing.assert_close(got_y.double(), y.detach().reshape(n, c_out, -1),
                               rtol=0, atol=1e-5 * float(y.detach().abs().max()))
    torch.testing.assert_close(got_dx.double(), x4.grad.reshape(n, c_in, -1),
                               rtol=0, atol=1e-5 * float(x4.grad.abs().max()))
    want_dw = conv_chw.weights_to_wall(w4.grad).t()
    torch.testing.assert_close(got_dw.double(), want_dw, rtol=0,
                               atol=1e-5 * float(want_dw.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_layer_gradients_match_jax_vjp(dtype, monkeypatch):
    """A ``Conv`` built with ``k4=True`` runs K4 forward and K4dx and K4dw
    backward, and its input and OIHW weight gradients match ``jax.vjp`` of
    ``conv3x3s2_phase_ad`` through the phase split, with JAX's rounding of
    dx to the input's dtype and of dw to the weight's."""
    n, c_in, c_out, h, w = 2, 6, 10, 16, 12
    x, w_hwio, dy = _inputs(n, c_in, c_out, h, w, seed=3)

    def f(x_, w_):
        return jconv.conv3x3s2_phase_ad(jconv.chw_phase_split(x_, h, w), w_, h, w, True)

    want_y, vjp = jax.vjp(f, _j(x, dtype), _j(w_hwio, dtype))
    want_dx, want_dw = (_np(g) for g in vjp(_j(dy, dtype)))
    calls = []
    for name in ("conv3x3s2", "conv3x3s2_dx", "conv3x3s2_dw"):
        fn = getattr(conv_s2, name)
        monkeypatch.setattr(conv_s2, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    tdt = getattr(torch, dtype)
    conv = conv_chw.Conv(c_in, c_out, 3, stride=2, padding=1, dtype=tdt, k4=True)
    with torch.no_grad():
        conv.weight.copy_(_oihw(w_hwio))
    assert conv.uses_k4() and not conv.uses_k1()
    xt = torch.from_numpy(x).to(tdt).reshape(n, c_in, h, w).requires_grad_(True)
    y = conv(xt)
    y.backward(torch.from_numpy(dy).reshape(y.shape).to(tdt))
    assert sorted(calls) == ["conv3x3s2", "conv3x3s2_dw", "conv3x3s2_dx"]
    want_y = _np(want_y)
    np.testing.assert_allclose(y.detach().float().reshape(n, c_out, -1).numpy(), want_y,
                               rtol=0, atol=_atol(want_y, dtype))
    assert xt.grad.dtype == tdt
    np.testing.assert_allclose(xt.grad.float().reshape(n, c_in, h * w).numpy(), want_dx,
                               rtol=0, atol=_atol(want_dx, dtype))
    got_dw = conv.weight.grad.permute(2, 3, 1, 0).numpy()
    np.testing.assert_allclose(got_dw, want_dw, rtol=0, atol=_atol(want_dw, dtype))


def test_dx_only_where_the_input_needs_it(monkeypatch):
    calls = []
    for name in ("conv3x3s2_dx", "conv3x3s2_dw"):
        fn = getattr(conv_s2, name)
        monkeypatch.setattr(conv_s2, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    conv = conv_chw.Conv(3, 3, 3, stride=2, padding=1, k4=True)
    conv(torch.randn(2, 3, 8, 8)).sum().backward()
    assert calls == ["conv3x3s2_dw"]
    calls.clear()
    conv(torch.randn(2, 3, 8, 8, requires_grad=True)).sum().backward()
    assert sorted(calls) == ["conv3x3s2_dw", "conv3x3s2_dx"]


@pytest.mark.parametrize("c_in,features,hw,k4", [
    (16, 32, 32, True),     # down1 of FCN_16
    (32, 64, 16, True),     # down2
    (64, 128, 8, False),    # down3: its stage has 128 channels
    (128, 128, 4, False),   # down4
    (16, 32, 6, True),      # 6x6: even, K4
    (16, 32, 7, False),     # odd H and W: F.conv2d in the port, stock in JAX
])
def test_resconvdown_routes_by_the_jax_gate(c_in, features, hw, k4, monkeypatch):
    """``conv_s2=True`` sends the downsample to K4 exactly where the JAX
    package's ``s2_chain_ok`` holds under ``PALLAS_CONV_S2=1``;
    ``conv_s2=False`` never does."""
    from cooperative_training_and_latent_space_data_augmentation_tpu.models import blocks as jb

    with pallas_interpret(s2=True):
        assert jb.s2_chain_ok(c_in, features, hw, hw) == k4
    calls = []
    fn = conv_s2.conv3x3s2
    monkeypatch.setattr(conv_s2, "conv3x3s2", lambda *a: calls.append(1) or fn(*a))
    x = torch.randn(2, c_in, hw, hw)
    for on in (False, True):
        block = ResConvDown(c_in, features, None, conv_s2=on)
        with torch.no_grad():
            block.down.weight.normal_(0, 0.1)
            y = block.down(x)
            want = F.conv2d(x, block.down.weight, block.down.bias, 2, 1)
        torch.testing.assert_close(y, want, rtol=0, atol=1e-5)
    assert len(calls) == int(k4)


@pytest.mark.parametrize("bad", ["float64", "mixed", "odd", "shape", "c_out", "noncontig",
                                 "device"])
@pytest.mark.parametrize("which", ["fwd", "dx", "dw"])
def test_wrappers_reject_bad_input(which, bad):
    n, c_in, c_out, h, w = 2, 4, 8, 8, 8
    a = torch.randn(n, c_in, h * w) if which != "dx" else torch.randn(n, c_out, h * w // 4)
    b = {"fwd": torch.randn(c_out, 9 * c_in), "dx": torch.randn(c_out, 9 * c_in),
         "dw": torch.randn(n, c_out, h * w // 4)}[which]
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "odd":
        h = 7
    elif bad == "shape":
        a = a[:, :, :-1].contiguous()
    elif bad == "c_out":
        b = torch.randn(65, 9 * c_in) if which != "dw" else torch.randn(n, 65, h * w // 4)
        if which == "dx":
            a = torch.randn(n, 65, h * w // 4)
    elif bad == "noncontig":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":          # no kernel for a device other than the card
        a, b = a.to("meta"), b.to("meta")
    fn = {"fwd": conv_s2.conv3x3s2, "dx": conv_s2.conv3x3s2_dx, "dw": conv_s2.conv3x3s2_dw}
    with pytest.raises((TypeError, ValueError)):
        fn[which](a, b, h, w)


def test_cpu_calls_do_not_count_as_launches():
    before = [f.launches for f in (conv_s2.conv3x3s2, conv_s2.conv3x3s2_dx,
                                   conv_s2.conv3x3s2_dw)]
    conv = conv_chw.Conv(3, 3, 3, stride=2, padding=1, k4=True)
    conv(torch.randn(2, 3, 8, 8, requires_grad=True)).sum().backward()
    assert [f.launches for f in (conv_s2.conv3x3s2, conv_s2.conv3x3s2_dx,
                                 conv_s2.conv3x3s2_dw)] == before


def test_kernel_binding_declares_pointer_arguments(monkeypatch):
    """ctypes passes an undeclared argument as a 32-bit int, which would cut
    the tensors' device pointers and the stream handle."""
    import ctypes
    import types

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels

    libc = ctypes.CDLL(None)
    fake = types.SimpleNamespace(**{name: getattr(libc, f) for name, f in (
        ("conv3x3s2", "labs"), ("conv3x3s2_dx", "abs"), ("conv3x3s2_dw", "llabs"),
        ("conv3x3s2_dw_workspace", "atoi"))})
    monkeypatch.setattr(kernels, "load", lambda name: fake)
    for name, n_ptr in (("conv3x3s2", 3), ("conv3x3s2_dx", 3), ("conv3x3s2_dw", 4)):
        fn = conv_s2._fn(name)
        assert fn.restype is ctypes.c_int
        assert fn.argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert fn.argtypes[n_ptr:-1] == [ctypes.c_int] * 6
        assert fn.argtypes[-1] is ctypes.c_void_p
    ws = conv_s2._fn("conv3x3s2_dw_workspace")
    assert ws.restype is ctypes.c_longlong and ws.argtypes == [ctypes.c_int] * 6


def test_parameters_are_the_same_under_both_routes():
    """The JAX parameter tree is the same under ``PALLAS_CONV_S2=1`` and
    under the default, and the port's state dicts are the same under
    ``conv_s2=True`` and ``False``: one ``convert.from_jax`` serves both,
    strictly."""
    solver = make_solver()

    def tree():
        return jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
            lambda: solver.modules["image_encoder"].init(
                jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False)))

    default = tree()
    with pallas_interpret(s2=True):
        s2 = tree()
    assert default == s2
    sds = convert.from_jax(*random_variables(solver, seed=1))
    models = [CooperativePredictor(device="cpu", conv_s2=on) for on in (False, True)]
    for model in models:
        model.load_state_dicts(sds)
    for name in MODULE_NAMES:
        a, b = (getattr(m, name).state_dict() for m in models)
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_k4_calls_per_predict(monkeypatch):
    """Two K4 downsamples per encoder pass (16->16 and 32->32 at full
    width): 2 for predict(n_iter=1), 4 for predict(n_iter=2); none with
    ``conv_s2=False``."""
    calls = []
    fn = conv_s2.conv3x3s2
    monkeypatch.setattr(conv_s2, "conv3x3s2",
                        lambda *a: calls.append((a[0].shape[1], a[1].shape[0], a[2])) or fn(*a))
    x = torch.rand(2, 32, 32, 1)
    CooperativePredictor(device="cpu").predict(x, n_iter=2)
    assert calls == []
    model = CooperativePredictor(device="cpu", conv_s2=True)
    model.predict(x, n_iter=1)
    assert calls == [(16, 16, 32), (32, 32, 16)]
    model.predict(x, n_iter=2)
    assert len(calls) == 2 + 4
