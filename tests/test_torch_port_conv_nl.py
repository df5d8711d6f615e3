"""The port's large-channel conv (kernels K5, K5 on flipped weights for dx,
K5dw; ``ops/conv_nl.py``) against the JAX package's ``ops/pallas_conv.py``
NL-sublanes kernels, run in interpret mode on the CPU: ``conv3x3_nl``,
``_nl_fwd_dispatch(dy, _flip_w(w))``, ``_conv3x3_nl_dw`` and the custom
VJP ``conv3x3_nl_ad``.  The JAX kernels take NHWC; the port's (N, C, H*W)
view of NCHW is held against them through a transpose in the test.

On the CPU the wrappers run their plain versions; the kernels are held
against those on the card (tests/test_torch_port_cuda.py and
chip_smoke.py).  The dx kernel reads the flipped wall out of the unflipped
one; that index map, written as a plain gather, is held against JAX's dx
here too.  Also here: the channel rule against JAX's
``_eligible_channels_nl``, the routing of every conv of the five
subnetworks under ``conv_nl`` against the NL ``pallas_call``s in JAX's own
trace (4 an encoder pass, 1 a decoder pass, none in the code decoupler),
the input checks, and that the parameters, and so ``convert.from_jax``,
are the same under both routes.

Shapes: JAX's own test shapes (tests/test_pallas_conv.py:435-440) and a
batch of 10 at 24x24 that makes JAX cut its grid into two chunks of 5
images (``_nl_chunk``: at most 4608 rows a chunk).

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
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.encoder_decoder import (
    code_decoupler,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    conv_chw,
    conv_nl,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
    CooperativePredictor,
)
from torch_port_util import bf16_ulp, make_solver, pallas_interpret, random_variables

# (N, H, C_in, C_out): JAX's four test shapes, then a batch JAX chunks
SHAPES = [(2, 12, 128, 128), (4, 24, 64, 128), (2, 24, 128, 64), (3, 12, 128, 128),
          (10, 24, 64, 128)]


def _inputs(n, h, c_in, c_out, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, c_in).astype(np.float32)                 # NHWC
    w_hwio = (rng.randn(3, 3, c_in, c_out) / np.sqrt(9 * c_in)).astype(np.float32)
    dy = rng.randn(n, h, h, c_out).astype(np.float32)
    return x, w_hwio, dy


def _chw(a_nhwc, tdt):
    """NHWC numpy -> the port's (N, C, H*W) tensor in ``tdt``."""
    n, h, w, c = a_nhwc.shape
    return torch.from_numpy(np.ascontiguousarray(
        a_nhwc.transpose(0, 3, 1, 2).reshape(n, c, h * w))).to(tdt)


def _nhwc(t, h):
    """The port's (N, C, H*W) -> NHWC numpy float32."""
    n, c, _ = t.shape
    return t.detach().float().reshape(n, c, h, -1).permute(0, 2, 3, 1).numpy()


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
@pytest.mark.parametrize("n,h,c_in,c_out", SHAPES)
def test_plain_k5_matches_pallas_kernel(n, h, c_in, c_out, dtype):
    x, w_hwio, _ = _inputs(n, h, c_in, c_out)
    want = _np(jconv.conv3x3_nl(_j(x, dtype), _j(w_hwio, dtype), interpret=True))
    tdt = getattr(torch, dtype)
    got = conv_nl.conv3x3_nl(_chw(x, tdt), _wall(w_hwio, tdt), h, h)
    assert got.dtype == tdt and got.shape == (n, c_out, h * h)
    np.testing.assert_allclose(_nhwc(got, h), want, rtol=0, atol=_atol(want, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,c_in,c_out", SHAPES)
def test_plain_k5dx_matches_pallas_kernel(n, h, c_in, c_out, dtype):
    _, w_hwio, dy = _inputs(n, h, c_in, c_out, seed=1)
    want = _np(jconv._nl_fwd_dispatch(_j(dy, dtype), jconv._flip_w(_j(w_hwio, dtype)), True))
    tdt = getattr(torch, dtype)
    got = conv_nl.conv3x3_nl_dx(_chw(dy, tdt), _wall(w_hwio, tdt), h, h)
    assert got.dtype == tdt and got.shape == (n, c_in, h * h)
    np.testing.assert_allclose(_nhwc(got, h), want, rtol=0, atol=_atol(want, dtype))


def _dx_folded_flip(dy, w_all, H, W):
    """K5dx as the kernel computes it with ``flip = 1``, in plain PyTorch: no
    flipped wall is built; the A operand's element (i, t, o) (output
    channel i, tap t, reduction channel o) is gathered from the flat
    unflipped wall at ``o*9*C_in + (8-t)*C_in + i``, the address the
    kernel's wall staging reads, and the product runs over dy's tap
    matrix."""
    c_out, k = w_all.shape
    c_in = k // 9
    i = torch.arange(c_in).view(c_in, 1, 1)
    t = torch.arange(9).view(1, 9, 1)
    o = torch.arange(c_out).view(1, 1, c_out)
    a = w_all.reshape(-1)[o * 9 * c_in + (8 - t) * c_in + i].reshape(c_in, 9 * c_out)
    n, _, L = dy.shape
    out = torch.matmul(conv_nl.tap_matrix(dy, H, W), a.float().t())  # (N*H*W, C_in)
    return out.reshape(n, L, c_in).permute(0, 2, 1).contiguous().to(dy.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,c_in,c_out", SHAPES)
def test_folded_flip_index_map_matches_pallas_dx(n, h, c_in, c_out, dtype):
    """The dx kernel's folded flip, w_all[o, (8-t)*C_in + i] with o as the
    reduction, against JAX's ``_nl_fwd_dispatch(dy, _flip_w(w))``; and equal
    to the CPU path's product on ``flip_wall`` (the same matrix)."""
    _, w_hwio, dy = _inputs(n, h, c_in, c_out, seed=4)
    want = _np(jconv._nl_fwd_dispatch(_j(dy, dtype), jconv._flip_w(_j(w_hwio, dtype)), True))
    tdt = getattr(torch, dtype)
    dyt, wall = _chw(dy, tdt), _wall(w_hwio, tdt)
    got = _dx_folded_flip(dyt, wall, h, h)
    assert got.dtype == tdt and got.shape == (n, c_in, h * h)
    np.testing.assert_allclose(_nhwc(got, h), want, rtol=0, atol=_atol(want, dtype))
    assert torch.equal(got, conv_nl.conv3x3_nl_dx(dyt, wall, h, h))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,h,c_in,c_out", SHAPES)
def test_plain_k5dw_matches_pallas_kernel(n, h, c_in, c_out, dtype):
    x, _, dy = _inputs(n, h, c_in, c_out, seed=2)
    want = _np(jconv._conv3x3_nl_dw(_j(x, dtype).reshape(n * h * h, c_in),
                                    _j(dy, dtype).reshape(n * h * h, c_out),
                                    H=h, W=h, interpret=True))
    tdt = getattr(torch, dtype)
    got = conv_nl.conv3x3_nl_dw(_chw(x, tdt), _chw(dy, tdt), h, h)
    assert got.dtype == torch.float32 and got.shape == (9 * c_in, c_out)
    # wall row t*C_in + i is HWIO [t // 3, t % 3, i]
    np.testing.assert_allclose(got.reshape(3, 3, c_in, c_out).numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_edge_masks_keep_images_apart():
    """The rolls of the flattened (N*H*W) tap matrix cross image
    boundaries; the masks must kill every such read (JAX's own test): a
    constant image k+1 per image, an all-ones kernel, each image's output
    equal to its output alone."""
    h, c = 6, 64
    x = torch.stack([torch.full((c, h * h), float(k + 1)) for k in range(3)])
    w_all = torch.ones(128, 9 * c)
    got = conv_nl.conv3x3_nl(x, w_all, h, h)
    for k in range(3):
        torch.testing.assert_close(got[k], conv_nl.conv3x3_nl(x[k:k + 1], w_all, h, h)[0])
    assert float(got[0, 0, 0]) == 4 * c and float(got[2, 0, h + 1]) == 27 * c


def test_plain_versions_match_torch_conv():
    """The plain forward, dx and dw are the SAME 3x3 conv's value and
    gradients (``F.conv2d`` under float64 autograd), at a non-square
    image."""
    n, c_in, c_out, h, w = 2, 64, 128, 5, 7
    rng = np.random.RandomState(5)
    x4 = torch.from_numpy(rng.randn(n, c_in, h, w)).requires_grad_(True)
    w4 = torch.from_numpy(rng.randn(c_out, c_in, 3, 3) / 24).requires_grad_(True)
    y = F.conv2d(x4, w4, None, 1, 1)
    dy = torch.from_numpy(rng.randn(*y.shape))
    y.backward(dy)
    wall = conv_chw.weights_to_wall(w4.detach()).float().contiguous()
    xf = x4.detach().float().reshape(n, c_in, -1)
    dyf = dy.float().reshape(n, c_out, -1)
    for got, want in ((conv_nl.conv3x3_nl(xf, wall, h, w), y.detach().reshape(n, c_out, -1)),
                      (conv_nl.conv3x3_nl_dx(dyf, wall, h, w), x4.grad.reshape(n, c_in, -1)),
                      (conv_nl.conv3x3_nl_dw(xf, dyf, h, w),
                       conv_chw.weights_to_wall(w4.grad).t())):
        torch.testing.assert_close(got.double(), want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_layer_gradients_match_jax_vjp(dtype, monkeypatch):
    """A ``Conv`` built with ``k5=True`` runs K5 forward and K5 dx and K5dw
    backward, and its output and its input and OIHW weight gradients match
    ``jax.vjp`` of ``conv3x3_nl_ad``, with JAX's rounding of dw to the
    weight's dtype."""
    n, h, c_in, c_out = 2, 6, 128, 64
    x, w_hwio, dy = _inputs(n, h, c_in, c_out, seed=3)
    want_y, vjp = jax.vjp(lambda a, b: jconv.conv3x3_nl_ad(a, b, True),
                          _j(x, dtype), _j(w_hwio, dtype))
    want_dx, want_dw = (_np(g) for g in vjp(_j(dy, dtype)))
    want_y = _np(want_y)
    calls = []
    for name in ("conv3x3_nl", "conv3x3_nl_dx", "conv3x3_nl_dw"):
        fn = getattr(conv_nl, name)
        monkeypatch.setattr(conv_nl, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    tdt = getattr(torch, dtype)
    conv = conv_chw.Conv(c_in, c_out, 3, padding=1, dtype=tdt, k5=True)
    with torch.no_grad():
        conv.weight.copy_(_oihw(w_hwio))
    assert conv.uses_k5() and not conv.uses_k1()
    xt = _chw(x, tdt).reshape(n, c_in, h, h).requires_grad_(True)
    y = conv(xt)
    y.backward(_chw(dy, tdt).reshape(y.shape))
    assert sorted(calls) == ["conv3x3_nl", "conv3x3_nl_dw", "conv3x3_nl_dx"]
    np.testing.assert_allclose(_nhwc(y.reshape(n, c_out, -1), h), want_y, rtol=0,
                               atol=_atol(want_y, dtype))
    assert xt.grad.dtype == tdt
    np.testing.assert_allclose(_nhwc(xt.grad.reshape(n, c_in, -1), h), want_dx, rtol=0,
                               atol=_atol(want_dx, dtype))
    got_dw = conv.weight.grad.permute(2, 3, 1, 0).numpy()
    np.testing.assert_allclose(got_dw, want_dw, rtol=0, atol=_atol(want_dw, dtype))


def test_dx_only_where_the_input_needs_it(monkeypatch):
    calls = []
    for name in ("conv3x3_nl_dx", "conv3x3_nl_dw"):
        fn = getattr(conv_nl, name)
        monkeypatch.setattr(conv_nl, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    conv = conv_chw.Conv(64, 128, 3, padding=1, k5=True)
    conv(torch.randn(2, 64, 4, 4)).sum().backward()
    assert calls == ["conv3x3_nl_dw"]
    calls.clear()
    conv(torch.randn(2, 64, 4, 4, requires_grad=True)).sum().backward()
    assert sorted(calls) == ["conv3x3_nl_dw", "conv3x3_nl_dx"]


@pytest.mark.parametrize("c_in,c_out", [(64, 128), (128, 128), (128, 64), (64, 64),
                                        (32, 128), (63, 128), (64, 127), (256, 256),
                                        (128, 257), (200, 96), (16, 16)])
def test_channel_rule_matches_jax(c_in, c_out):
    assert conv_nl.eligible_channels_nl(c_in, c_out) == jconv._eligible_channels_nl(c_in,
                                                                                    c_out)
    conv = conv_chw.Conv(c_in, c_out, 3, padding=1, k5=True)
    assert conv.uses_k5() == (jconv._eligible_channels_nl(c_in, c_out)
                              and not jconv._eligible_channels(c_in, c_out))
    assert not conv_chw.Conv(c_in, c_out, 3, padding=1).uses_k5()
    assert not conv_chw.Conv(c_in, c_out, 3, stride=2, padding=1, k5=True).uses_k5()
    assert not conv_chw.Conv(c_in, c_out, 1, k5=True).uses_k5()


def _nl_calls(fn, *args):
    """NL-kernel ``pallas_call``s in the jaxpr of ``fn(*args)``: those with a
    2-D output, the (M, C_out) of ``conv3x3_nl`` (K1's output is (N, C,
    H*W); a forward trace has no dw kernel)."""
    def walk(jaxpr):
        count = 0
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                count += all(len(a.shape) == 2 for a in eqn.params["out_avals"])
            for v in eqn.params.values():
                sub = getattr(v, "jaxpr", v)
                if hasattr(sub, "eqns"):
                    count += walk(sub)
        return count
    return walk(jax.make_jaxpr(fn)(*args).jaxpr)


def test_routing_matches_the_jax_trace():
    """Under ``conv_nl`` the port sends to K5 exactly the convs that JAX's
    trace under ``PALLAS_CONV_NL=1`` sends to its NL kernel: 4 an encoder
    pass (down3's two, down4's two), 1 a decoder pass (up1's first), and
    none of the code decoupler's two 128->128 convs, which JAX builds with
    flax's stock ``nn.Conv`` (its ``encoder_decoder.py:174,178``)."""
    solver = make_solver()
    params, stats = random_variables(solver, seed=0)
    shapes = {"image_encoder": (1, 32, 32, 1), "shape_encoder": (1, 32, 32, 4),
              "segmentation_decoder": (1, 2, 2, 128), "image_decoder": (1, 2, 2, 128),
              "shape_decoder": (1, 2, 2, 128)}
    want = {"image_encoder": 4, "shape_encoder": 4, "segmentation_decoder": 1,
            "image_decoder": 1, "shape_decoder": 1}
    with pallas_interpret(nl=True):
        for name in MODULE_NAMES:
            variables = {"params": params[name], "batch_stats": stats[name]}
            got = _nl_calls(lambda v, x, m=solver.modules[name]: m.apply(v, x, train=False),
                            variables, jnp.zeros(shapes[name]))
            assert got == want[name], name
    model = CooperativePredictor(device="cpu", conv_nl=True)
    for name in MODULE_NAMES:
        k5 = [n for n, m in getattr(model, name).named_modules()
              if isinstance(m, conv_chw.Conv) and m.uses_k5()]
        assert len(k5) == want[name], (name, k5)
        assert not any("code_decoupler" in n for n in k5)
    assert not any(m.k5 for m in model.image_encoder.code_decoupler.modules()
                   if isinstance(m, conv_chw.Conv))
    assert not any(m.k5 for m in code_decoupler(128).modules() if isinstance(m, conv_chw.Conv))
    default = CooperativePredictor(device="cpu")
    assert not any(m.uses_k5() for m in default.modules() if isinstance(m, conv_chw.Conv))


def test_k5_calls_per_predict(monkeypatch):
    """predict(n_iter=2) under ``conv_nl`` calls K5 10 times (FTN encoder
    4, segmentation decoder 1, shape encoder 4, shape decoder 1) at the
    model's five large-channel shapes, and never without it; K1's calls
    are the default route's."""
    calls, k1 = [], []
    fn, fn1 = conv_nl.conv3x3_nl, conv_chw.conv3x3_chw
    monkeypatch.setattr(conv_nl, "conv3x3_nl",
                        lambda *a: calls.append((a[0].shape[1], a[1].shape[0], a[2])) or fn(*a))
    monkeypatch.setattr(conv_chw, "conv3x3_chw", lambda *a: k1.append(1) or fn1(*a))
    x = torch.rand(2, 32, 32, 1)
    CooperativePredictor(device="cpu").predict(x, n_iter=2)
    assert calls == [] and len(k1) == 26
    CooperativePredictor(device="cpu", conv_nl=True, conv_s2=True).predict(x, n_iter=2)
    assert len(calls) == 10 and len(k1) == 2 * 26
    assert sorted(set(calls)) == [(64, 128, 4), (128, 64, 4), (128, 128, 2), (128, 128, 4)]


@pytest.mark.parametrize("bad", ["float64", "mixed", "shape", "channels", "noncontig",
                                 "device"])
@pytest.mark.parametrize("which", ["fwd", "dx", "dw"])
def test_wrappers_reject_bad_input(which, bad):
    n, c_in, c_out, h, w = 2, 64, 128, 4, 4
    a = torch.randn(n, c_in, h * w) if which != "dx" else torch.randn(n, c_out, h * w)
    b = {"fwd": torch.randn(c_out, 9 * c_in), "dx": torch.randn(c_out, 9 * c_in),
         "dw": torch.randn(n, c_out, h * w)}[which]
    if bad == "float64":
        a, b = a.double(), b.double()
    elif bad == "mixed":
        b = b.bfloat16()
    elif bad == "shape":
        a = a[:, :, :-1].contiguous()
    elif bad == "channels":   # 64 -> 64 is K1's, not the NL rule's
        b = torch.randn(64, 9 * c_in) if which != "dw" else torch.randn(n, 64, h * w)
        if which == "dx":
            a = torch.randn(n, 64, h * w)
    elif bad == "noncontig":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "device":          # no kernel for a device other than the card
        a, b = a.to("meta"), b.to("meta")
    fn = {"fwd": conv_nl.conv3x3_nl, "dx": conv_nl.conv3x3_nl_dx, "dw": conv_nl.conv3x3_nl_dw}
    with pytest.raises((TypeError, ValueError)):
        fn[which](a, b, h, w)


def test_cpu_calls_do_not_count_as_launches():
    fns = (conv_nl.conv3x3_nl, conv_nl.conv3x3_nl_dx, conv_nl.conv3x3_nl_dw)
    before = [f.launches for f in fns]
    conv = conv_chw.Conv(64, 128, 3, padding=1, k5=True)
    conv(torch.randn(2, 64, 4, 4, requires_grad=True)).sum().backward()
    assert [f.launches for f in fns] == before


def test_kernel_binding_declares_pointer_arguments(monkeypatch):
    """ctypes passes an undeclared argument as a 32-bit int, which would cut
    the tensors' device pointers and the stream handle."""
    import ctypes
    import types

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels

    libc = ctypes.CDLL(None)
    fake = types.SimpleNamespace(**{name: getattr(libc, f) for name, f in (
        ("conv3x3_nl", "labs"), ("conv3x3_nl_dw", "llabs"),
        ("conv3x3_nl_dw_workspace", "atoi"))})
    monkeypatch.setattr(kernels, "load", lambda name: fake)
    # conv3x3_nl: n, c_in, c_out, h, w, flip, is_bf16; conv3x3_nl_dw: no flip
    for name, n_ptr, n_int in (("conv3x3_nl", 3, 7), ("conv3x3_nl_dw", 4, 6)):
        fn = conv_nl._fn(name)
        assert fn.restype is ctypes.c_int
        assert fn.argtypes[:n_ptr] == [ctypes.c_void_p] * n_ptr
        assert fn.argtypes[n_ptr:-1] == [ctypes.c_int] * n_int
        assert fn.argtypes[-1] is ctypes.c_void_p
    ws = conv_nl._fn("conv3x3_nl_dw_workspace")
    assert ws.restype is ctypes.c_longlong and ws.argtypes == [ctypes.c_int] * 5


def test_parameters_are_the_same_under_both_routes():
    """The JAX parameter tree is the same under ``PALLAS_CONV_NL=1`` and
    under the default, and the port's state dicts are the same under
    ``conv_nl=True`` and ``False``: one ``convert.from_jax`` serves both,
    strictly."""
    solver = make_solver()

    def tree():
        return jax.tree_util.tree_map(lambda a: a.shape, jax.eval_shape(
            lambda: solver.modules["image_encoder"].init(
                jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False)))

    default = tree()
    with pallas_interpret(nl=True):
        nl = tree()
    assert default == nl
    sds = convert.from_jax(*random_variables(solver, seed=1))
    models = [CooperativePredictor(device="cpu", conv_nl=on) for on in (False, True)]
    for model in models:
        model.load_state_dicts(sds)
    for name in MODULE_NAMES:
        a, b = (getattr(m, name).state_dict() for m in models)
        assert list(a) == list(b)
        assert all(torch.equal(a[k], b[k]) for k in a)
