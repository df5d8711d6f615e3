"""The port's CHW 3x3 conv (kernel K1's wrapper and its plain version, and
the conv dispatcher) against the JAX package's Pallas
kernel ``ops/pallas_conv.py:conv3x3_chw`` run in interpret mode on the CPU.

On the CPU the wrapper runs K1's plain version; the kernel itself is held
against that plain version on the card (tests/test_torch_port_cuda.py and
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import pallas_conv as jconv
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
from torch_port_util import bf16_ulp

# every (C_in, C_out) pair K1 sees on the predictor's main path, at 16-32 px,
# plus C_in = 1 and C_in = 4 on non-square images
SHAPES = [
    (1, 16, 32, 32), (4, 16, 32, 32), (16, 16, 32, 32), (16, 32, 16, 16),
    (32, 32, 16, 16), (32, 64, 16, 16), (64, 64, 16, 16), (64, 32, 16, 16),
    (32, 16, 16, 16), (1, 16, 16, 24), (4, 8, 24, 16),
]


def _inputs(c_in, c_out, h, w, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, c_in, h * w).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c_in, c_out) / np.sqrt(9 * c_in)).astype(np.float32)
    return x, w_hwio


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out,h,w", SHAPES)
def test_plain_conv_matches_pallas_kernel(c_in, c_out, h, w, dtype):
    x, w_hwio = _inputs(c_in, c_out, h, w)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jconv.conv3x3_chw(jnp.asarray(x, jdt), jnp.asarray(w_hwio, jdt),
                                        H=h, W=w, interpret=True)).astype(np.float32)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    w_all = conv_chw.weights_to_wall(_oihw(w_hwio)).to(tdt).contiguous()
    got = conv_chw.conv3x3_chw(xt, w_all, h, w)
    assert got.dtype == tdt and got.shape == (2, c_out, h * w)
    got = got.float().numpy()
    # f32: accumulation order only.  bf16: both round the same f32 sums
    # once, so they differ by at most one ulp of the output's scale.
    atol = 1e-5 if dtype == "float32" else bf16_ulp(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_weights_to_wall_and_layouts_match_jax():
    """The wall form matches JAX's, and the (N, C, H*W) view of an NCHW
    activation, which the dispatcher hands to K1, is JAX's CHW layout."""
    x, w_hwio = _inputs(5, 7, 6, 4)
    np.testing.assert_array_equal(
        conv_chw.weights_to_wall(_oihw(w_hwio)).numpy(),
        np.asarray(jconv.weights_to_wall(jnp.asarray(w_hwio))))
    x_nhwc = x.reshape(2, 5, 6, 4).transpose(0, 2, 3, 1).copy()
    chw = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2).reshape(2, 5, 24)
    np.testing.assert_array_equal(chw.numpy(),
                                  np.asarray(jconv.nhwc_to_chw(jnp.asarray(x_nhwc))))


def test_dispatcher_matches_jax_nhwc_entry():
    """The Conv layer's image route (NCHW -> K1 on the (N, C, H*W) view)
    against the JAX package's NHWC entry to its kernel."""
    x, w_hwio = _inputs(3, 8, 12, 20)
    x_nhwc = x.reshape(2, 3, 12, 20).transpose(0, 2, 3, 1).copy()
    want = np.asarray(jconv.conv3x3_nhwc_via_chw(jnp.asarray(x_nhwc), jnp.asarray(w_hwio),
                                                 interpret=True))
    conv = conv_chw.Conv(3, 8, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(_oihw(w_hwio))
        got = conv(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_eligibility_rule_matches_jax():
    for c_in, c_out in [(1, 16), (64, 64), (64, 65), (128, 64), (16, 128), (128, 128)]:
        assert conv_chw.eligible_channels(c_in, c_out) == jconv._eligible_channels(c_in, c_out)


@pytest.mark.parametrize("bad", ["float64", "int32", "w_dtype", "noncontig",
                                 "c_out", "shape", "w_shape"])
def test_wrapper_rejects_bad_input(bad):
    x = torch.randn(2, 4, 8 * 8)
    w_all = torch.randn(8, 36)
    h = w = 8
    if bad == "float64":
        x, w_all = x.double(), w_all.double()
    elif bad == "int32":
        x, w_all = x.int(), w_all.int()
    elif bad == "w_dtype":
        w_all = w_all.bfloat16()
    elif bad == "noncontig":
        x = torch.randn(2, 64, 4).transpose(1, 2)
    elif bad == "c_out":
        w_all = torch.randn(65, 36)
    elif bad == "shape":
        h = 7
    elif bad == "w_shape":
        w_all = torch.randn(8, 35)
    with pytest.raises((TypeError, ValueError)):
        conv_chw.conv3x3_chw(x, w_all, h, w)


def test_cpu_calls_do_not_count_as_launches():
    before = conv_chw.conv3x3_chw.launches
    conv_chw.conv3x3_chw(torch.randn(1, 2, 16), torch.randn(3, 18), 4, 4)
    assert conv_chw.conv3x3_chw.launches == before


@pytest.mark.parametrize("c_in,c_out,k,stride,padding,k1", [
    (16, 32, 3, 1, 1, True),     # K1
    (64, 64, 3, 1, 1, True),     # K1 at the cutoff
    (128, 64, 3, 1, 1, False),   # too wide: F.conv2d
    (16, 16, 3, 2, 1, False),    # stride 2: F.conv2d
    (16, 32, 1, 1, 0, False),    # 1x1: F.conv2d
])
def test_conv_dispatcher(c_in, c_out, k, stride, padding, k1, monkeypatch):
    """Routes like the JAX package's Conv and computes conv + bias."""
    torch.manual_seed(0)
    conv = conv_chw.Conv(c_in, c_out, k, stride, padding)
    with torch.no_grad():
        conv.weight.normal_(0, 0.1)
        conv.bias.normal_(0, 0.1)
    assert conv.uses_k1() == k1
    calls = []
    plain = conv_chw.conv3x3_chw_plain
    monkeypatch.setattr(conv_chw, "conv3x3_chw_plain",
                        lambda *a: calls.append(1) or plain(*a))
    x = torch.randn(2, c_in, 12, 12)
    with torch.no_grad():
        got = conv(x)
        want = F.conv2d(x, conv.weight, conv.bias, stride, padding)
    assert len(calls) == int(k1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layer,dtype,tf32_inside", [
    ("conv1x1", torch.float32, False),
    ("conv_s2", torch.float32, False),
    ("conv1x1", torch.bfloat16, True),
    ("convT", torch.float32, False),
])
def test_library_convs_run_in_full_f32(layer, dtype, tf32_inside, monkeypatch):
    """An f32 conv left to the library runs with cuDNN's TF32 off, whatever
    the global setting; a bf16 one leaves the setting alone; both restore
    it afterwards."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
        ConvTranspose2x2,
    )

    seen = []
    for name in ("conv2d", "conv_transpose2d"):
        fn = getattr(F, name)
        monkeypatch.setattr(F, name, lambda *a, _fn=fn, **k: seen.append(
            torch.backends.cudnn.allow_tf32) or _fn(*a, **k))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    mod = {"conv1x1": lambda: conv_chw.Conv(8, 4, 1, dtype=dtype),
           "conv_s2": lambda: conv_chw.Conv(8, 8, 3, 2, 1, dtype=dtype),
           "convT": lambda: ConvTranspose2x2(8, 8, dtype)}[layer]()
    with torch.no_grad():
        mod(torch.randn(1, 8, 6, 6))
    assert seen == [tf32_inside]
    assert torch.backends.cudnn.allow_tf32 is True


def test_kernel_binding_declares_pointer_arguments(monkeypatch):
    """ctypes passes an undeclared argument as a 32-bit int, which would cut
    the tensors' device pointers and the stream handle."""
    import ctypes
    import types

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels

    fake = types.SimpleNamespace(conv3x3_chw=ctypes.CDLL(None).labs)
    monkeypatch.setattr(kernels, "load", lambda name: fake)
    fn = conv_chw._k1()
    assert fn.restype is ctypes.c_int
    assert [fn.argtypes[i] for i in (0, 1, 2, 9)] == [ctypes.c_void_p] * 4
    assert fn.argtypes[3:9] == [ctypes.c_int] * 6
