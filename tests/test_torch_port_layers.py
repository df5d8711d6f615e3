"""The port's extra baseline networks, layers and blocks against the JAX
package's, on the CPU.

``DeeplySupervisedUNet`` (``multi_out``), the networks with layer dropout
(on the keep masks JAX drew, recorded by ``record_jax_dropout``),
``UNet3D`` and ``UnetUp3`` in both up modes, ``DomainSpecificEncoder`` at
both domain ids, ``ResUp``'s ``bilinear`` and ``Conv4`` arms, every layer
of ``models/layers.py``, ``upsample_bilinear`` and the transposed convs'
kernel flip; then each new layer's initial values against the
distribution JAX draws from.  Weights are drawn with numpy in the JAX
layout and carried over by ``convert.baseline_from_jax``; inputs are 32x32
(3-D: 4x32x32), batch 2, from a numpy seed.

Tolerances, f32: outputs within ``2e-4 + 4e-6 max|ref|``; running
statistics within 1e-5 of each tensor's scale (at least 1); gradients
within 1e-4 of each tensor's largest |g|.  Initial values within 5
standard errors of the distribution's std (and the cut), as
``test_torch_port_init.py`` holds the cooperative networks.
"""

import inspect
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.models import blocks as jblocks
from cooperative_training_and_latent_space_data_augmentation_tpu.models import layers as jlayers
from cooperative_training_and_latent_space_data_augmentation_tpu.models import unet as junet
from cooperative_training_and_latent_space_data_augmentation_tpu.models import unet3d as junet3d
from cooperative_training_and_latent_space_data_augmentation_tpu.models.encoder_decoder import (
    DomainSpecificEncoder as JaxDSE,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import blocks
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import layers
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import unet
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import unet3d
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.encoder_decoder import (
    DomainSpecificEncoder,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    TRUNC_STD,
    init_parameters,
)
from test_torch_port_baselines import (
    assert_output_close,
    assert_stats_close,
    load,
    random_variables,
)
from torch_port_util import one_torch_thread, record_jax_dropout  # noqa: F401

HW, BATCH, CLASSES = 32, 2, 4


def _x(shape, seed=0):
    return np.random.RandomState(200 + seed).rand(*shape).astype(np.float32)


def to_port(a):
    """Channels-last numpy -> channels-first tensor (any rank)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def from_port(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def assert_grad_close(got, want, what="", top=None):
    want = np.asarray(want, np.float32)
    top = float(np.abs(want).max()) if top is None else top
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= 1e-4 * top + 1e-12, (what, err, top)


def check_module(flax_mod, port_mod, x, train, seed=0, call_kw=None, port_kw=None,
                 channel_last=True, zero_grads=()):
    """Forward of ``flax_mod`` and ``port_mod`` on ``x`` (channels-last),
    and the gradients of ``sum(out * c)`` for a random cotangent c with
    respect to the input and every parameter; in train mode also the
    statistics.  The first output is compared where the module returns a
    tuple, the others too.  ``zero_grads`` names (or picks, a predicate)
    the parameters whose gradient is 0 in exact arithmetic, so that both
    sides hold rounding noise (a conv bias just before a train-mode
    BatchNorm, whose batch mean removes it): they are held to 1e-4 of the
    module's largest parameter gradient."""
    call_kw, port_kw = call_kw or {}, port_kw or {}
    if callable(zero_grads):
        zero_grads = [n for n, _ in port_mod.named_parameters() if zero_grads(n)]
    takes_mode = "train" in inspect.signature(type(flax_mod).__call__).parameters
    mode = {"train": train} if takes_mode else {}
    params, stats = random_variables(flax_mod, x.shape, seed, **mode, **call_kw)
    load(port_mod, params, stats)

    def f(p, x):
        out = flax_mod.apply({"params": p, "batch_stats": stats}, x, **mode, **call_kw,
                             mutable=["batch_stats"] if train else False)
        return out if train else (out, {})

    out, new = jax.jit(f)(params, x)
    first = out[0] if isinstance(out, tuple) else out
    cot = np.random.RandomState(300 + seed).normal(size=first.shape).astype(np.float32)

    def scalar(p, x):
        o, _ = f(p, x)
        o = o[0] if isinstance(o, tuple) else o
        return jnp.sum(o * cot)

    g_params, g_x = jax.jit(jax.grad(scalar, argnums=(0, 1)))(params, x)

    port_mod.train(train)
    xt = (to_port(x) if channel_last else torch.from_numpy(x)).requires_grad_(True)
    got = port_mod(xt, **port_kw)
    got_first = got[0] if isinstance(got, tuple) else got
    conv = from_port if channel_last else (lambda t: t.detach().numpy())
    outs = out if isinstance(out, tuple) else (out,)
    gots = got if isinstance(got, tuple) else (got,)
    for i, (g, w) in enumerate(zip(gots, outs)):
        w = np.asarray(w)
        g = conv(g) if g.dim() == w.ndim and g.shape != w.shape else g.detach().numpy()
        assert_output_close(g, w, f"{type(port_mod).__name__} output {i}")
    c = to_port(cot) if channel_last and got_first.dim() > 2 else torch.from_numpy(cot)
    (got_first * c).sum().backward()
    gx = from_port(xt.grad) if channel_last else xt.grad.numpy()
    assert_grad_close(gx, g_x, f"{type(port_mod).__name__} input grad")
    want_g = convert_grads(port_mod, g_params, stats)
    names = [n for n, _ in port_mod.named_parameters()]
    top = max(float(want_g[n].abs().max()) for n in names)
    for name, p in port_mod.named_parameters():
        if p.grad is None:  # a parameter off the forward's path (a DSBN bank not selected)
            assert not want_g[name].any(), name
            continue
        assert_grad_close(p.grad.numpy(), want_g[name].numpy(), f"{name} grad",
                          top if name in zero_grads else None)
    if train:
        assert_stats_close(port_mod, params, jax.tree.map(np.asarray, new["batch_stats"]),
                           type(port_mod).__name__)
    return params, stats


def convert_grads(port_mod, g_params, stats):
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

    return convert.baseline_from_jax(port_mod, jax.tree.map(np.asarray, g_params), stats)


# ------------------------------------------------------------------ layers
LAYERS = {  # name -> (flax layer, port layer, train modes, zero-gradient parameters)
    "channel_se": (jlayers.ChannelSELayer, lambda: layers.ChannelSELayer(16), (False,), ()),
    "spatial_se": (jlayers.SpatialSELayer, lambda: layers.SpatialSELayer(16), (False,), ()),
    "channel_spatial_se": (jlayers.ChannelSpatialSELayer,
                           lambda: layers.ChannelSpatialSELayer(16), (False,), ()),
    # the key's bias shifts every score of a query alike: the softmax drops it
    "self_attention": (jlayers.SelfAttention, lambda: layers.SelfAttention(16), (False,),
                       ("key.bias",)),
    "batch_instance_norm": (jlayers.BatchInstanceNorm, lambda: layers.BatchInstanceNorm(16),
                            (False, True), ()),
}


@pytest.mark.parametrize("name, train", [(n, t) for n in sorted(LAYERS) for t in LAYERS[n][2]])
def test_layer_matches_jax(name, train):
    jax_mod, port_mod, _, zero = LAYERS[name]
    check_module(jax_mod(), port_mod(), _x((BATCH, 8, 8, 16)), train, zero_grads=zero)


@pytest.mark.parametrize("train", [False, True])
def test_domain_specific_batch_norm(train):
    """Only the selected bank normalises; in train mode only its statistics
    move."""
    for domain in (0, 1):
        port = layers.DomainSpecificBatchNorm(16, 2)
        params, stats = check_module(jlayers.DomainSpecificBatchNorm(2), port,
                                     _x((BATCH, 8, 8, 16), domain), train,
                                     call_kw={"domain_id": domain},
                                     port_kw={"domain_id": domain})
        other = port.banks[1 - domain]
        before = stats[f"bn_{1 - domain}"]
        np.testing.assert_array_equal(other.running_mean.numpy(), before["mean"])
        np.testing.assert_array_equal(other.running_var.numpy(), before["var"])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("up_type", ["bilinear", "Conv4"])
def test_res_up_arms(up_type, train):
    jax_mod = jblocks.ResUp(8, up_type=up_type)
    port = blocks.ResUp(16, 8, up_type, None)
    check_module(jax_mod, port, _x((BATCH, 8, 8, 16)), train,
                 zero_grads=("conv.0.bias", "conv.3.bias") if train else ())


def test_conv_transpose_flip_with_an_asymmetric_kernel():
    """flax's k4s2 'SAME' ConvTranspose (2-D, and the 3-D k(1,4,4)s(1,2,2)
    of UnetUp3) with a kernel that differs under every flip, against the
    port's ConvTranspose on the converted weights."""
    k = np.arange(4 * 4 * 3 * 5, dtype=np.float32).reshape(4, 4, 3, 5) / 100.0
    k[0, 1] += 1.0
    x = _x((1, 6, 7, 3))
    want = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME").apply(
        {"params": {"kernel": k, "bias": np.zeros(5, np.float32)}}, x)
    port = blocks.ConvTranspose(3, 5, (4, 4), (2, 2), (1, 1), None)
    load_conv_t(port, k)
    assert_output_close(from_port(port(to_port(x))), want, "2-D")
    k3 = np.stack([k], 0)                                  # (1, 4, 4, 3, 5)
    x3 = _x((1, 2, 6, 7, 3))
    want3 = fnn.ConvTranspose(5, (1, 4, 4), strides=(1, 2, 2), padding="SAME").apply(
        {"params": {"kernel": k3, "bias": np.zeros(5, np.float32)}}, x3)
    port3 = blocks.ConvTranspose(3, 5, (1, 4, 4), (1, 2, 2), (0, 1, 1), None)
    load_conv_t(port3, k3)
    assert_output_close(from_port(port3(to_port(x3))), want3, "3-D")


def load_conv_t(port, kernel):
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

    w = convert.kernel_to_torch(kernel, "convT").copy()
    port.load_state_dict({"weight": torch.from_numpy(w),
                          "bias": torch.zeros(port.bias.shape)})


@pytest.mark.parametrize("factor", [2, 4, 8, 16])
def test_upsample_bilinear_align_corners(factor):
    x = _x((BATCH, 3, 5, 2), factor)
    cot = np.random.RandomState(factor).normal(size=(BATCH, 3 * factor, 5 * factor, 2))
    cot = cot.astype(np.float32)
    want, vjp = jax.vjp(lambda x: jblocks.upsample_bilinear(x, factor), jnp.asarray(x))
    xt = to_port(x).requires_grad_(True)
    got = blocks.upsample_bilinear(xt, factor)
    assert_output_close(from_port(got), want)
    (got * to_port(cot)).sum().backward()
    assert_grad_close(from_port(xt.grad), vjp(jnp.asarray(cot))[0])


FUNCTIONS = {
    "adaptive_instance_norm": (
        lambda x, w, b: jlayers.adaptive_instance_norm(x, w, b),
        lambda x, w, b: layers.adaptive_instance_norm(x, w, b)),
    "adaptive_batch_norm": (
        lambda x, w, b: jlayers.adaptive_batch_norm(x, w, b),
        lambda x, w, b: layers.adaptive_batch_norm(x, w, b)),
    "bilinear_additive_upsampling": (
        lambda x, w, b: jlayers.bilinear_additive_upsampling(x * w + b, 4),
        lambda x, w, b: layers.bilinear_additive_upsampling(
            x * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1), 4)),
    "spatial_pyramid_pool": (
        lambda x, w, b: jlayers.spatial_pyramid_pool(x * w + b),
        lambda x, w, b: layers.spatial_pyramid_pool(x * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1))),
}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("hw", [(8, 8), (10, 14)])
def test_layer_function_matches_jax(name, hw):
    """Values and gradients (input, weight, bias); the odd size exercises
    the pyramid's shifted windows and the upsample's borders."""
    jfn, pfn = FUNCTIONS[name]
    rng = np.random.RandomState(hw[1])
    x = _x((BATCH, *hw, 8), hw[0])
    w = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    b = rng.normal(0.0, 0.1, 8).astype(np.float32)
    want, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    cot = rng.normal(size=want.shape).astype(np.float32)
    gx, gw, gb = vjp(jnp.asarray(cot))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (to_port(x).numpy(), w, b))
    got = pfn(xt, wt, bt)
    flat = got.dim() == 2
    assert_output_close(got.detach().numpy() if flat else from_port(got), want, name)
    (got * (torch.from_numpy(cot) if flat else to_port(cot))).sum().backward()
    assert_grad_close(from_port(xt.grad), gx, f"{name} dx")
    assert_grad_close(wt.grad.numpy(), gw, f"{name} dw")
    assert_grad_close(bt.grad.numpy(), gb, f"{name} db")


# --------------------------------------------------------------- networks
def _dropout_case(flax_mod, port_mod, x, seed=0):
    """Train-mode forward on the keep masks JAX drew: outputs and
    statistics; returns the number of masks."""
    params, stats = random_variables(flax_mod, x.shape, seed, train=False)
    load(port_mod, params, stats)
    with record_jax_dropout() as masks:
        out, new = flax_mod.apply({"params": params, "batch_stats": stats}, x, train=True,
                                  mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(5)})
        jax.effects_barrier()
        masks = list(masks)
    port_mod.train()
    with torch.no_grad(), blocks.dropout_masks([torch.from_numpy(m) for m in masks]):
        got = port_mod(to_port(x))
    assert_output_close(from_port(got), out, type(port_mod).__name__)
    assert_stats_close(port_mod, params, jax.tree.map(np.asarray, new["batch_stats"]))
    return len(masks)


DROPOUT_NETS = {
    "unet": (lambda: junet.UNet(CLASSES, 4, encoder_dropout=0.3, decoder_dropout=0.2),
             lambda: unet.UNet(1, CLASSES, 4, encoder_dropout=0.3, decoder_dropout=0.2), 9),
    "res_conv_unet": (lambda: junet.ResConvUNet(CLASSES, 4, encoder_dropout=0.3,
                                                decoder_dropout=0.2),
                      lambda: unet.ResConvUNet(1, CLASSES, 4, encoder_dropout=0.3,
                                               decoder_dropout=0.2), 9),
    "fcn": (lambda: junet.FCN(CLASSES, 4, decoder_dropout=0.3),
            lambda: unet.FCN(1, CLASSES, 4, decoder_dropout=0.3), 2),
}


@pytest.mark.parametrize("name", sorted(DROPOUT_NETS))
def test_layer_dropout_on_jax_masks(name):
    jax_mod, port_mod, n_masks = DROPOUT_NETS[name]
    assert _dropout_case(jax_mod(), port_mod(), _x((BATCH, HW, HW, 1))) == n_masks


def test_deeply_supervised_unet():
    """``multi_out`` in eval mode (the three outputs), then a train-mode
    forward with dropout on JAX's masks (down2..down4 and the first three
    skip concats)."""
    jax_mod = junet.DeeplySupervisedUNet(CLASSES, base_n_filters=8, dropout=0.3)
    port = unet.DeeplySupervisedUNet(1, CLASSES, base_n_filters=8, dropout=0.3)
    x = _x((BATCH, HW, HW, 1))
    params, stats = random_variables(jax_mod, x.shape, train=False)
    load(port, params, stats)
    want = jax.jit(lambda x: jax_mod.apply({"params": params, "batch_stats": stats}, x,
                                           multi_out=True))(x)
    port.eval()
    with torch.no_grad():
        got = port(to_port(x), multi_out=True)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert_output_close(from_port(g), w, "multi_out")
    assert _dropout_case(jax_mod, unet.DeeplySupervisedUNet(1, CLASSES, 8, 0.3), x) == 6


@pytest.mark.parametrize("train", [False, True])
def test_unet3d(train):
    x = _x((BATCH, 4, HW, HW, 1))
    before_bn = (lambda n: n.endswith(("conv1.bias", "conv2.bias"))) if train else ()
    check_module(junet3d.UNet3D(CLASSES, 4), unet3d.UNet3D(1, CLASSES, 4), x, train,
                 zero_grads=before_bn)


@pytest.mark.parametrize("z_scale", [1, 2])
@pytest.mark.parametrize("is_deconv", [False, True])
def test_unet_up3_both_modes(is_deconv, z_scale):
    """UnetUp3 with the trilinear resize and with the transposed conv, in
    train mode, at z scale 1 and 2 (the skip comes first, x second)."""
    skip = _x((BATCH, 4 * z_scale, 16, 16, 8), 1)
    x = _x((BATCH, 4, 8, 8, 16), 2)
    jax_mod = junet3d.UnetUp3(8, is_deconv=is_deconv, z_scale_factor=z_scale)
    port = unet3d.UnetUp3(16, 8, 8, is_deconv=is_deconv, z_scale_factor=z_scale)
    params, stats = _up3_variables(jax_mod, skip, x)
    load(port, params, stats)
    out, new = jax.jit(lambda s, x: jax_mod.apply({"params": params, "batch_stats": stats}, s, x,
                                                  train=True, mutable=["batch_stats"]))(skip, x)
    port.train()
    with torch.no_grad():
        got = port(to_port(skip), to_port(x))
    assert_output_close(from_port(got), out)
    assert_stats_close(port, params, jax.tree.map(np.asarray, new["batch_stats"]))


def _up3_variables(jax_mod, skip, x):
    from test_torch_port_baselines import fill

    shapes = jax.eval_shape(lambda: jax_mod.init(jax.random.PRNGKey(0), jnp.zeros(skip.shape),
                                                 jnp.zeros(x.shape), train=False))
    rng = np.random.RandomState(7)
    return fill(shapes["params"], rng), fill(shapes["batch_stats"], rng)


@pytest.mark.parametrize("domain", [0, 1])
def test_domain_specific_encoder(domain):
    """Eval and train forward at each domain id; in train mode only the
    selected bank's statistics move."""
    jax_mod = JaxDSE(feature_reduce=4, num_domains=2, act="sigmoid")
    port = DomainSpecificEncoder(1, feature_reduce=4, num_domains=2, act="sigmoid")
    x = _x((BATCH, HW, HW, 1), domain)
    params, stats = random_variables(jax_mod, x.shape, train=False, domain_id=domain)
    load(port, params, stats)
    apply = jax.jit(lambda x, train: jax_mod.apply(
        {"params": params, "batch_stats": stats}, x, domain_id=domain, train=train,
        mutable=["batch_stats"]), static_argnums=1)
    port.eval()
    with torch.no_grad():
        assert_output_close(from_port(port(to_port(x), domain)), apply(x, False)[0], "eval")
    out, new = apply(x, True)
    port.train()
    with torch.no_grad():
        got = port(to_port(x), domain)
    assert_output_close(from_port(got), out, "train")
    new = jax.tree.map(np.asarray, new["batch_stats"])
    assert_stats_close(port, params, new)
    for name, banks in stats.items():
        untouched = banks[f"bn_{1 - domain}"]
        moved = new[name][f"bn_{1 - domain}"]
        np.testing.assert_array_equal(moved["mean"], untouched["mean"])
        assert not np.array_equal(new[name][f"bn_{domain}"]["mean"], banks[f"bn_{domain}"]["mean"])


# ---------------------------------------------------------- initial values
N_SE = 5.0


def _truncnorm_kurtosis():
    from scipy import stats

    return float(stats.truncnorm(-2.0, 2.0).stats(moments="k")) + 3.0


def _std_se(n, kurtosis):
    return math.sqrt((kurtosis - 1.0) / (4.0 * n))


def _check_z(z, what, kurt):
    """z: a kernel over its target std.  Within the cut, std 1 within 5
    standard errors, mean 0 within 5."""
    assert np.abs(z).max() <= (2.0 / TRUNC_STD) * (1 + 1e-6), what
    assert abs(z.std() - 1.0) <= N_SE * _std_se(z.size, kurt), (what, z.std())
    assert abs(z.mean()) <= N_SE / math.sqrt(z.size), (what, z.mean())


def _jax_init(mod, shape, **kw):
    v = jax.jit(lambda k: mod.init({"params": k}, jnp.zeros(shape), **kw))(jax.random.PRNGKey(1))
    return jax.tree.map(np.asarray, v["params"]), jax.tree.map(np.asarray,
                                                                v.get("batch_stats", {}))


def _kernels(tree, out, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            _kernels(v, out, path + (k,))
        elif k == "kernel":
            out.append(("/".join(path), np.asarray(v, np.float64)))
    return out


def test_initial_kernels_follow_jax():
    """Each network's conv, transposed-conv and dense kernels from the
    port's ``init_parameters`` and from JAX's init, pooled per network and
    side and over all: he_normal (variance 2 / fan_in) for the JAX
    package's ``conv_kernel_init``, lecun_normal (1 / fan_in) for stock
    flax layers, both truncated at +-2 of the underlying std; fan_in is
    C_in times the kernel's taps."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

    kurt = _truncnorm_kurtosis()
    cases = [  # (flax module, port module, input, init kwargs, variance numerator)
        (JaxDSE(feature_reduce=4), DomainSpecificEncoder(1, 4), (1, HW, HW, 1),
         dict(train=False), 2.0),
        (junet.ResConvUNet(CLASSES, 4), unet.ResConvUNet(1, CLASSES, 4), (1, HW, HW, 1),
         dict(train=False), 2.0),
        (junet.FCN(CLASSES, 4), unet.FCN(1, CLASSES, 4), (1, HW, HW, 1), dict(train=False), 2.0),
        (junet3d.UNet3D(CLASSES, 4), unet3d.UNet3D(1, CLASSES, 4), (1, 4, HW, HW, 1),
         dict(train=False), 2.0),
        (jlayers.SelfAttention(), layers.SelfAttention(64), (1, 8, 8, 64), {}, 1.0),
        (jlayers.ChannelSpatialSELayer(), layers.ChannelSpatialSELayer(64), (1, 8, 8, 64), {},
         1.0),
    ]
    everything = {"port": [], "jax": []}
    for jax_mod, port, shape, kw, gain in cases:
        params, _ = _jax_init(jax_mod, shape, **kw)
        init_parameters(port, 3)
        sd = port.state_dict()
        zs = {"port": [], "jax": []}
        for key, _, path, kind in convert.baseline_entries(port):
            if kind == "copy":
                continue
            w = sd[key].numpy().astype(np.float64)
            fan_in = (w.shape[0] * int(np.prod(w.shape[2:])) if kind == "convT"
                      else int(np.prod(w.shape[1:])))
            scale = math.sqrt(gain / fan_in)
            zs["port"].append(w.ravel() / scale)
            zs["jax"].append(np.asarray(convert._at(params, path), np.float64).ravel() / scale)
        for side, z in zs.items():
            _check_z(np.concatenate(z), f"{side} {type(port).__name__}", kurt)
            everything[side] += z
    for side, z in everything.items():
        _check_z(np.concatenate(z), f"{side} pooled", kurt)


def test_initial_norms_and_spectral_vectors_follow_jax():
    """flax BatchNorm scale 1 and bias 0 (DSBN), BatchInstanceNorm's rho and
    gamma 1 and beta 0, SelfAttention's gamma 0, zero biases, SN's sigma 1
    and u from N(0, 1) (mean and std within 5 standard errors), as JAX's
    init gives them."""
    port = DomainSpecificEncoder(1, 4)
    init_parameters(port, 4)
    for m in port.modules():
        if isinstance(m, layers.BiasedBatchNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert not m.bias.any() and not m.running_mean.any()
            assert torch.equal(m.running_var, torch.ones_like(m.running_var))
    params, _ = _jax_init(JaxDSE(feature_reduce=4), (1, HW, HW, 1), train=False)
    assert all(np.all(b["scale"] == 1) for b in params["norm_1"].values())
    bin_port = layers.BatchInstanceNorm(8)
    init_parameters(bin_port, 5)
    jp, _ = _jax_init(jlayers.BatchInstanceNorm(), (1, 4, 4, 8), train=False)
    for name in ("rho", "gamma", "beta"):
        np.testing.assert_array_equal(getattr(bin_port, name).detach().numpy(), jp[name])
    sa = layers.SelfAttention(16)
    init_parameters(sa, 6)
    ja, _ = _jax_init(jlayers.SelfAttention(), (1, 4, 4, 16))
    assert float(sa.gamma.detach()) == float(ja["gamma"]) == 0.0
    for m in (sa.query, sa.key, sa.value):
        assert not m.bias.any()
    _check_spectral_norm_init()


def _sigma_hat(w_rows, u):
    """One power iteration's sigma of the (rows, C_out) matrix from u."""
    def l2n(a):
        return a / np.sqrt((a * a).sum() + 1e-12)

    v = l2n(u @ w_rows.T)
    return float((v @ w_rows @ l2n(v @ w_rows).T)[0, 0])


def _check_spectral_norm_init():
    """SN convs: u from N(0, 1) (mean and std within 5 standard errors),
    sigma 1, and the kernel stored already divided by one power
    iteration's sigma from that u (so that it gives sigma 1), on both
    sides."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

    port = unet.UNet(1, CLASSES, 1, norm="instance", if_SN=True)
    init_parameters(port, 7)
    params, stats = _jax_init(junet.UNet(CLASSES, 1, norm="instance", if_SN=True),
                              (1, HW, HW, 1), train=False)
    where = {key: (col, path) for key, col, path, _ in convert.baseline_entries(port)}
    trees = {"params": params, "batch_stats": stats}
    us = {"port": [], "jax": []}
    for name, m in port.named_modules():
        if not (isinstance(m, blocks.SNConv) and m.if_SN):
            continue
        assert float(m.sigma) == 1.0
        w = m.weight.detach().numpy().astype(np.float64)
        u = m.u.numpy().astype(np.float64)
        assert abs(_sigma_hat(w.reshape(w.shape[0], -1).T, u) - 1.0) <= 1e-5, name
        col, path = where[f"{name}.weight"]
        jw = np.asarray(convert._at(trees[col], path), np.float64)
        col, upath = where[f"{name}.u"]
        ju = np.asarray(convert._at(trees[col], upath), np.float64)
        assert float(convert._at(stats, upath[:-1] + ("Conv_0/kernel/sigma",))) == 1.0
        assert abs(_sigma_hat(jw.reshape(-1, jw.shape[-1]), ju) - 1.0) <= 1e-5, name
        us["port"].append(u.ravel())
        us["jax"].append(ju.ravel())
    for side, z in us.items():
        z = np.concatenate(z)
        assert abs(z.mean()) <= N_SE / math.sqrt(z.size), (side, z.mean())
        assert abs(z.std() - 1.0) <= N_SE * math.sqrt(2.0 / (4.0 * z.size)), (side, z.std())
