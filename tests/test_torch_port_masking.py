"""The port's latent masking and the train-mode pieces of its step against
the JAX package, on the CPU:

* K3's plain version (the sort-based threshold) against the Pallas kernel
  ``ops/pallas_kernels.py:fused_percentile_mask`` in interpret mode, ties
  planted, at D = 128 (channel) and 144 (12x12 spatial);
* train-mode BatchNorm: outputs, input and affine gradients, running
  statistics, and the frozen-statistics mode;
* ``cross_entropy_2d`` and the label-map branch of ``construct_input``;
* each masking function and the dispatcher, with shared decoder weights
  and draws replayed from the JAX keys (a 4x4 latent, so spatial masking
  has 16 locations);
* the draws themselves: :func:`draw_step` and the key replay.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.config import (
    MaskConfig as JaxMaskConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.models import (
    blocks as jblocks,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.ops import image as jimage
from cooperative_training_and_latent_space_data_augmentation_tpu.ops import losses as jlosses
from cooperative_training_and_latent_space_data_augmentation_tpu.ops import masking as jmasking
from cooperative_training_and_latent_space_data_augmentation_tpu.ops.pallas_kernels import (
    fused_percentile_mask,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
    MaskConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BatchNorm,
    frozen_stats,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import masking
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.image import one_hot
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.losses import (
    cross_entropy_2d,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.percentile_mask import (
    percentile_mask,
    percentile_mask_plain,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)
from torch_port_util import bf16_ulp, random_variables, replay_code_draws, replay_draws

MASK_HW = 64  # a 4x4 latent: 16 spatial locations to mask


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).permute(0, 3, 1, 2)


# ------------------------------------------------------------------- K3
def _saliency_with_ties(n, d, seed):
    rng = np.random.RandomState(seed)
    sal = rng.randn(n, d).astype(np.float32)
    sal[:, 1] = sal[:, 2]                          # a tie anywhere in the row
    sal[:, 3:6] = np.round(sal[:, 3:6])            # more ties, often at 0 and +-1
    sal[0, :] = sal[0, 0]                          # a row of one value
    return sal


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("p", [0.0, 0.1, 1 / 3.0, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("d", [128, 144])
def test_percentile_mask_plain_matches_pallas_kernel(d, p, soft):
    sal = _saliency_with_ties(20, d, seed=d)
    rng = np.random.RandomState(7)
    soft_vals = (0.5 * rng.rand(20, d) if soft else np.zeros((20, d))).astype(np.float32)
    want = np.asarray(fused_percentile_mask(jnp.asarray(sal), jnp.asarray(p, jnp.float32),
                                            jnp.asarray(soft_vals), interpret=True))
    got = percentile_mask(torch.from_numpy(sal), torch.tensor(p, dtype=torch.float32),
                          torch.from_numpy(soft_vals))
    np.testing.assert_array_equal(got.numpy(), want)
    # and it is the JAX package's portable sort-based threshold
    want_sort = np.asarray(jmasking._threshold_mask(
        jnp.asarray(sal), jnp.asarray(p, jnp.float32), d, False, None))
    np.testing.assert_array_equal(percentile_mask_plain(
        torch.from_numpy(sal), torch.tensor(p), torch.zeros(20, d)).numpy(), want_sort)


def test_percentile_mask_tie_semantics():
    """Elements equal to the threshold value stay unmasked
    (tests/test_pallas.py:39-50)."""
    sal = torch.tensor([[5.0, 5.0, 3.0, 1.0]])
    zeros = torch.zeros_like(sal)
    assert percentile_mask(sal, torch.tensor(0.25), zeros).tolist() == [[1, 1, 1, 1]]
    assert percentile_mask(sal, torch.tensor(0.5), zeros).tolist() == [[0, 0, 1, 1]]


@pytest.mark.parametrize("bad", ["shape", "dtype", "p", "d"])
def test_percentile_mask_rejects_bad_input(bad):
    sal, p, soft = torch.randn(2, 8), torch.tensor(0.3), torch.zeros(2, 8)
    if bad == "shape":
        soft = torch.zeros(2, 9)
    elif bad == "dtype":
        sal = sal.double()
    elif bad == "p":
        p = torch.tensor([0.1, 0.2])
    elif bad == "d":
        sal, soft = torch.randn(2, 5000), torch.zeros(2, 5000)
    with pytest.raises((TypeError, ValueError)):
        percentile_mask(sal, p, soft)


# -------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_jax(dtype):
    rng = np.random.RandomState(0)
    n, c, h, w = 3, 6, 5, 7
    x = (rng.randn(n, h, w, c) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(n, h, w, c).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.randn(c).astype(np.float32)
    mean0, var0 = rng.randn(c).astype(np.float32), rng.uniform(0.5, 2, c).astype(np.float32)
    jdt = jnp.dtype(dtype)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}

    def fwd(x_, params):
        return jblocks.BatchNorm().apply({**variables, "params": params}, x_,
                                         use_running_average=False, mutable=["batch_stats"])

    y, ups = fwd(jnp.asarray(x, jdt), variables["params"])
    _, vjp = jax.vjp(lambda x_, p_: fwd(x_, p_)[0], jnp.asarray(x, jdt), variables["params"])
    dx, dparams = vjp(jnp.asarray(dy, jdt))

    bn = BatchNorm(c).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    tdt = getattr(torch, dtype)
    xt = _nchw(x).to(tdt).requires_grad_(True)
    yt = bn(xt)
    yt.backward(_nchw(dy).to(tdt))
    assert yt.dtype == tdt

    def close(got, want, what):
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        got = got.detach().float().numpy()
        atol = 1e-5 * np.abs(want).max() if dtype == "float32" else bf16_ulp(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)

    close(yt.permute(0, 2, 3, 1), y, "output")
    close(xt.grad.permute(0, 2, 3, 1), dx, "input gradient")
    np.testing.assert_allclose(bn.weight.grad.numpy(), np.asarray(dparams["scale"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(dparams["bias"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(ups["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(ups["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-6)


def test_batchnorm_frozen_stats_and_eval():
    bn = BatchNorm(4).train()
    x = torch.randn(2, 4, 3, 3) * 3 + 1
    with frozen_stats(bn):
        y_frozen = bn(x)
    assert bn.update_stats
    assert bn.running_mean.eq(0).all() and bn.running_var.eq(1).all()
    y = bn(x)                      # same batch statistics, now tracked
    torch.testing.assert_close(y, y_frozen, rtol=0, atol=0)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.mean((0, 2, 3)))
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * x.var((0, 2, 3), unbiased=True))
    bn.eval()
    torch.testing.assert_close(bn(x), (x - bn.running_mean[:, None, None])
                               / torch.sqrt(bn.running_var[:, None, None] + 1e-5))


# ----------------------------------------------------- loss and STN input
def test_cross_entropy_and_one_hot_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(2, 9, 11, 4).astype(np.float32) * 3
    label = rng.randint(0, 4, (2, 9, 11)).astype(np.int32)
    want = float(jlosses.cross_entropy_2d(jnp.asarray(logits), jnp.asarray(label)))
    got = float(cross_entropy_2d(_nchw(logits), torch.from_numpy(label)))
    assert abs(got - want) <= 1e-6 * abs(want)
    want_oh = np.asarray(jimage.construct_input(jnp.asarray(label), num_classes=4,
                                                apply_softmax=False, is_labelmap=True))
    got_oh = one_hot(torch.from_numpy(label), 4)
    assert got_oh.dtype == torch.float32
    np.testing.assert_array_equal(got_oh.permute(0, 2, 3, 1).numpy(), want_oh)


# --------------------------------------------------------------- masking
@pytest.fixture(scope="module")
def decoders():
    """The JAX solver's two generation decoders (frozen: stop-gradiented
    parameters, batch statistics, no update) and the port's, on shared
    weights, with a code, an image and labels at 64x64."""
    solver = CooperativeTripletSolver(input_hw=(MASK_HW, MASK_HW))
    params, stats = random_variables(solver, seed=0)
    params = jax.tree.map(jnp.asarray, params)
    stats = jax.tree.map(jnp.asarray, stats)
    trainer = CooperativeTrainer(None, device="cpu")
    trainer.model.load_state_dicts(convert.from_jax(params, stats))
    rng = np.random.RandomState(5)
    lh = MASK_HW // 16
    data = {
        "code": rng.uniform(0, 2, (2, lh, lh, 128)).astype(np.float32),
        "image": rng.uniform(0, 1, (2, MASK_HW, MASK_HW, 1)).astype(np.float32),
        "label": rng.randint(0, 4, (2, MASK_HW, MASK_HW)).astype(np.int32),
    }
    return solver, params, stats, trainer, data


# (decoder, target, loss): the two calls of hard-example generation, plus corr
CASES = [("image_decoder", "image", "mse"), ("segmentation_decoder", "label", "ce"),
         ("segmentation_decoder", "label", "corr"), ("segmentation_decoder", "label", "mse")]


def _jax_masks(solver, params, stats, data, key):
    """Every masking function of the JAX package on every case, one jit."""
    def run(params, stats, data, key):
        k_op = jax.random.split(key)[1]
        out = {"dropout": jmasking.dropout_mask(jnp.asarray(data["code"]), k_op, 0.5)}
        for dec_name, target, loss in CASES:
            dec = solver._frozen_decoder_fn(dec_name, params, stats)
            for kind, fn in (("channel", jmasking.mask_latent_code_channel_wise),
                             ("spatial", jmasking.mask_latent_code_spatial_wise)):
                out[f"{kind}-{dec_name}-{loss}"] = fn(
                    data["code"], dec, data[target], k_op, num_classes=4, percentile=0.5,
                    random=True, loss_name=loss, if_soft=True)
            for mt in ("dropout", "spatial", "channel", "random"):
                cfg = JaxMaskConfig(loss_name=loss, mask_type=mt)
                settings = jmasking.MaskSettings(cfg.loss_name, cfg.mask_type,
                                                 cfg.max_threshold, cfg.random_threshold,
                                                 cfg.if_soft)
                out[f"perturb-{mt}-{dec_name}-{loss}"] = jmasking.perturb_latent_code(
                    data["code"], dec, data[target], key, settings, num_classes=4)
        return out

    return jax.device_get(jax.jit(run)(params, stats, data, key))


@pytest.fixture(scope="module")
def jax_masks(decoders):
    solver, params, stats, _, data = decoders
    key = jax.random.PRNGKey(3)
    return key, _jax_masks(solver, params, stats, data, key)


def _port_target(data, target):
    return (_nchw(data["image"]) if target == "image"
            else torch.from_numpy(data["label"]).long())


def _check_masked(got_masked, got_mask, want, what):
    want_masked, want_mask = (np.asarray(a, np.float32) for a in want)
    want_mask = np.broadcast_to(want_mask, want_masked.shape)
    np.testing.assert_array_equal(
        np.broadcast_to(got_mask.permute(0, 2, 3, 1).numpy(), want_masked.shape), want_mask,
        err_msg=what)
    np.testing.assert_allclose(got_masked.permute(0, 2, 3, 1).numpy(), want_masked,
                               rtol=1e-6, atol=1e-7, err_msg=what)


def test_dropout_mask_matches_jax(decoders, jax_masks):
    _, _, _, _, data = decoders
    key, want = jax_masks
    draws = replay_code_draws(key, MaskConfig(mask_type="dropout"), 2, 128, (4, 4))
    masked, mask = masking.dropout_mask(_nchw(data["code"]), draws.keep, 0.5)
    _check_masked(masked, mask, want["dropout"], "dropout")


@pytest.mark.parametrize("kind", ["channel", "spatial"])
@pytest.mark.parametrize("dec_name,target,loss", CASES)
def test_targeted_masking_matches_jax(decoders, jax_masks, kind, dec_name, target, loss):
    """Saliency through the frozen decoder, K3's plain version, the soft
    values: the masks are equal and the masked codes agree."""
    _, _, _, trainer, data = decoders
    key, want = jax_masks
    draws = replay_code_draws(key, MaskConfig(loss_name=loss, mask_type=kind), 2, 128, (4, 4))
    fn = (masking.mask_latent_code_channel_wise if kind == "channel"
          else masking.mask_latent_code_spatial_wise)
    masked, mask, saliency = fn(_nchw(data["code"]), trainer._frozen_decoder(dec_name),
                                _port_target(data, target), draws.p, draws.soft, loss, 4)
    assert saliency.shape == ((2, 128) if kind == "channel" else (2, 16))
    assert mask.shape == ((2, 128, 1, 1) if kind == "channel" else (2, 1, 4, 4))
    _check_masked(masked, mask, want[f"{kind}-{dec_name}-{loss}"], f"{kind} {dec_name} {loss}")


@pytest.mark.parametrize("mask_type", ["dropout", "spatial", "channel", "random"])
@pytest.mark.parametrize("dec_name,target,loss", CASES[:2])
def test_perturb_latent_code_matches_jax(decoders, jax_masks, mask_type, dec_name, target,
                                         loss):
    _, _, _, trainer, data = decoders
    key, want = jax_masks
    cfg = MaskConfig(loss_name=loss, mask_type=mask_type)
    draws = replay_code_draws(key, cfg, 2, 128, (4, 4))
    masked, mask, saliency = masking.perturb_latent_code(
        _nchw(data["code"]), trainer._frozen_decoder(dec_name), _port_target(data, target),
        cfg, draws, 4)
    assert (saliency is None) == (draws.branch == 0)
    assert not masked.requires_grad and mask.shape == masked.shape
    _check_masked(masked, mask, want[f"perturb-{mask_type}-{dec_name}-{loss}"], mask_type)


def test_generation_leaves_parameters_and_statistics_alone(decoders):
    """The frozen decoder gives no parameter a gradient and moves no
    running statistic, in train mode."""
    _, _, _, trainer, data = decoders
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    code = _nchw(data["code"])
    cfg = MaskConfig(loss_name="ce", mask_type="channel")
    draws = replay_code_draws(jax.random.PRNGKey(0), cfg, 2, 128, (4, 4))
    masking.perturb_latent_code(code, trainer._frozen_decoder("segmentation_decoder"),
                                torch.from_numpy(data["label"]).long(), cfg, draws, 4)
    assert all(p.grad is None for p in trainer.model.parameters())
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_branch_must_fit_the_mask_type(decoders):
    _, _, _, trainer, data = decoders
    draws = replay_code_draws(jax.random.PRNGKey(0), MaskConfig(mask_type="dropout"), 2, 128,
                              (4, 4))
    with pytest.raises(ValueError):
        masking.perturb_latent_code(_nchw(data["code"]), trainer._frozen_decoder("image_decoder"),
                                    _nchw(data["image"]), MaskConfig(mask_type="channel"),
                                    draws, 4)


# ----------------------------------------------------------------- draws
def test_draw_step_shapes_and_ranges():
    lda = LatentDAConfig(image_code=MaskConfig(mask_type="spatial"),
                         shape_code=MaskConfig(loss_name="ce", mask_type="channel"))
    d = draw_step(torch.Generator().manual_seed(0), 3, (64, 48), lda)
    assert d.noise.shape == (3, 1, 64, 48)
    assert d.image.branch == 1 and d.image.soft.shape == (3, 12)
    assert d.shape.branch == 2 and d.shape.soft.shape == (3, 128)
    for c in (d.image, d.shape):
        assert 0 <= float(c.p) < 0.5 and c.soft.min() >= 0 and c.soft.max() < 0.5
    hard = draw_step(torch.Generator().manual_seed(0), 3, (64, 48), LatentDAConfig(
        image_code=MaskConfig(mask_type="dropout"),
        shape_code=MaskConfig(mask_type="channel", random_threshold=False, if_soft=False)))
    assert set(hard.image.keep.unique().tolist()) <= {0.0, 1.0}
    assert float(hard.shape.p) == 0.5 and hard.shape.soft.eq(0).all()
    branches = {draw_step(torch.Generator().manual_seed(s), 1, (32, 32),
                          LatentDAConfig()).image.branch for s in range(30)}
    assert branches == {0, 1, 2}
    assert draw_step(torch.Generator().manual_seed(0), 1, (32, 32), None).image is None


def test_replayed_draws_follow_the_jax_key_schedule():
    """The noise of the replayed draws is the JAX step's ``normal(k_noise)``
    and the branch of a "random" code its ``randint(k_branch)``."""
    key = jax.random.PRNGKey(9)
    d = replay_draws(key, LatentDAConfig(), 2, (32, 32))
    k_noise, k_da, _ = jax.random.split(key, 3)
    want = np.asarray(jax.random.normal(k_noise, (2, 32, 32, 1)))
    np.testing.assert_array_equal(d.noise.permute(0, 2, 3, 1).numpy(), want)
    k_img = jax.random.split(k_da)[0]
    assert d.image.branch == int(jax.random.randint(jax.random.split(k_img)[0], (), 0, 3))
