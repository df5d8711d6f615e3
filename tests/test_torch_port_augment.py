"""The port's augmentation pipeline (``ops/augment.py``, ``ops/spline.py``)
against the JAX package's on the CPU.

The same numpy inputs go through both; the port gets JAX's random draws
replayed from its keys (``torch_port_util.replay_augment_draws``) as raw
uniforms and normals, which its stages scale and shape themselves.  Small
sizes: raw 31x33 phantoms (odd pads), padded to 40x40, cropped to 32x32,
batch 4.

Tolerances, float32 throughout:

- the fields (affine matrix and shift, elastic, coarse elastic, bias v1
  and v2), the FFT blur, the bicubic resize and ``map_coordinates_cubic``:
  ``rtol=1e-5`` and an ``atol`` of 1e-5 of the largest magnitude (sums,
  FFTs and sin/cos/tan/pow round differently in the two libraries);
- the pipeline's images: ``IMAGE_ATOL`` = 5e-5 absolute on the [0, 1]
  scale, except at pixels whose sample coordinate lies within ``UNSURE``
  = 1e-3 of the source frame's edge, where the in-frame test decides
  between the interpolated value and 0;
- the pipeline's labels: equal, except at those pixels and where one of
  JAX's class scores lies within ``UNSURE`` of the 0.5 threshold.  The
  excused pixels are counted and printed.

JAX runs with ``TILED_WARP=0``: the port's warp is the per-pixel gather
(``FUSED_WARP=1``'s arithmetic); JAX's tiled MXU evaluation is a TPU
rewrite of it (at key 0 below its jitted form differs from JAX's own
gather by 0.029 at one pixel of one sample).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from dataclasses import replace
from torch_port_util import replay_augment_draws

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import augment as J
from cooperative_training_and_latent_space_data_augmentation_tpu.ops import spline as JS
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    make_phantom,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import augment as A
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import spline as S

RAW = (31, 33)
PAD = (40, 40)
CROP = (32, 32)
N = 4
FIELD_HW = (40, 36)   # fields alone: not square, so h and w cannot be swapped unseen
KEY = 0               # every gated stage below fires on some samples and not on others
IMAGE_ATOL = 5e-5
UNSURE = 1e-3
POLICIES = ["ACDC_affine_elastic_intensity", "ACDC_affine_all", "Atrial_perturb",
            "elastic_v2"]


def _close(got, want, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


def _sample_keys(policy, hw=FIELD_HW, seed=KEY):
    """Per-sample (k_flip, ..., k_pe2) of ``augment_batch`` for N samples,
    and the port's draws replayed from the same key."""
    key = jax.random.PRNGKey(seed)
    per = [jax.random.split(k, 14) for k in jax.random.split(key, N)]
    return per, replay_augment_draws(key, policy, N, hw)


def _phantoms(seed=0):
    rs = [make_phantom(np.random.RandomState(seed * 100 + s), RAW) for s in range(N)]
    return (np.stack([r[0] for r in rs]).astype(np.float32),
            np.stack([r[1] for r in rs]).astype(np.int32))


# ------------------------------------------------------------------ fields
@pytest.mark.parametrize("policy", [
    A.get_policy("ACDC_affine_elastic_intensity"),
    A.get_policy("Atrial_perturb"),
    replace(A.get_policy("affine"), shear_val=10.0, shift_val=(0.1, 0.2)),
], ids=["acdc", "atrial", "shear"])
def test_affine_inverse_matrix(policy):
    per, d = _sample_keys(policy)
    h, w = FIELD_HW
    mat, trans = A._affine_inverse_matrix(d, policy, h, w)
    for i, keys in enumerate(per):
        want_mat, want_trans = J._affine_inverse_matrix(keys[5], J.AugmentPolicy(
            **policy.__dict__), h, w)
        _close(mat[i], want_mat, f"mat {i}")
        _close(trans[i], want_trans, f"trans {i}")


def test_elastic_field():
    policy = A.get_policy("ACDC_affine_elastic_intensity")
    per, d = _sample_keys(policy)
    dy, dx = A._elastic_field(d, *FIELD_HW)
    for i, keys in enumerate(per):
        want_dy, want_dx = J._elastic_field(keys[6], *FIELD_HW, J.get_policy(
            "ACDC_affine_elastic_intensity"))
        _close(dy[i], want_dy, f"dy {i}")
        _close(dx[i], want_dx, f"dx {i}")


def test_coarse_elastic_field():
    per, d = _sample_keys(A.get_policy("elastic_v2"))
    dy, dx = A._coarse_elastic_field(d, *FIELD_HW)
    for i, keys in enumerate(per):
        want_dy, want_dx = J._coarse_elastic_field(keys[7], *FIELD_HW)
        _close(dy[i], want_dy, f"dy {i}")
        _close(dx[i], want_dx, f"dx {i}")


@pytest.mark.parametrize("policy", [
    A.get_policy("Atrial_perturb"),
    replace(A.get_policy("Atrial_perturb"), multi_control_points=(8, 2, 4)),
], ids=["sorted", "unsorted"])
def test_bias_field_v1_field(policy):
    per, d = _sample_keys(policy)
    got = A.bias_field_v1_field(d.bias1_grids, *FIELD_HW, policy)
    jpol = J.AugmentPolicy(**policy.__dict__)
    for i, keys in enumerate(per):
        k_field, _ = jax.random.split(keys[1])
        _close(got[i], J.bias_field_v1_field(k_field, *FIELD_HW, jpol), f"v1 {i}")


@pytest.mark.parametrize("policy", [
    A.get_policy("ACDC_affine_all"),
    replace(A.get_policy("ACDC_affine_all"), ms_control_point_spacing=(16,)),
], ids=["spacing64", "spacing16"])
def test_bias_field_v2_field(policy):
    per, d = _sample_keys(policy)
    got = A.bias_field_v2_field(d.bias2_knots, *FIELD_HW, policy)
    jpol = J.AugmentPolicy(**policy.__dict__)
    for i, keys in enumerate(per):
        k_field, _ = jax.random.split(keys[2])
        _close(got[i], J.bias_field_v2_field(k_field, *FIELD_HW, jpol), f"v2 {i}")


def test_fft_gaussian_blur():
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (3, *FIELD_HW)).astype(np.float32)
    sigma = np.float32([0.7, 3.0, 8.5])
    got = A.fft_gaussian_blur(torch.from_numpy(x), torch.from_numpy(sigma))
    for i in range(3):
        _close(got[i], J.fft_gaussian_blur(jnp.asarray(x[i]), jnp.asarray(sigma[i])), f"{i}")
    _close(A.fft_gaussian_blur(torch.from_numpy(x), 16.0)[1],
           J.fft_gaussian_blur(jnp.asarray(x[1]), jnp.asarray(16.0)), "scalar sigma")


@pytest.mark.parametrize("src,dst", [((3, 3), (40, 36)), ((2, 2), (224, 224)),
                                     ((8, 4), (40, 40)), ((40, 40), (16, 12))])
def test_bicubic_resize_matches_jax_image_resize(src, dst):
    grid = np.random.RandomState(sum(src + dst)).normal(0, 1, (2, *src)).astype(np.float32)
    got = A.resize_bicubic(torch.from_numpy(grid), dst)
    for i in range(2):
        _close(got[i], jax.image.resize(jnp.asarray(grid[i]), dst, "bicubic"), f"{i}")


@pytest.mark.parametrize("mode", ["mirror", "reflect", "nearest"])
def test_map_coordinates_cubic(mode):
    rng = np.random.RandomState(5)
    img = rng.uniform(0, 1, (20, 17, 3)).astype(np.float32)
    ys = rng.uniform(-6, 26, (9, 11)).astype(np.float32)
    xs = rng.uniform(-6, 23, (9, 11)).astype(np.float32)
    got = S.map_coordinates_cubic(torch.from_numpy(img), torch.from_numpy(ys),
                                  torch.from_numpy(xs), mode=mode)
    want = JS.map_coordinates_cubic(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs),
                                    mode=mode)
    _close(got, want, mode)


def test_warp_image_and_label_matches_jax():
    """The fused warp of one sample on coordinates that leave the frame:
    the image to f32 tolerance, the label equal away from 0.5 and the
    frame's edge (JAX's scores decide)."""
    images, labels = _phantoms(seed=4)
    rng = np.random.RandomState(6)
    ys = (np.arange(32, dtype=np.float32)[:, None] * 1.2 - 3
          + rng.uniform(-1, 1, (32, 32))).astype(np.float32)
    xs = (np.arange(32, dtype=np.float32)[None, :] * 0.9 + 4
          + rng.uniform(-1, 1, (32, 32))).astype(np.float32)
    got_img, got_lbl = A.warp_image_and_label(torch.from_numpy(images[0]),
                                              torch.from_numpy(labels[0]),
                                              torch.from_numpy(ys), torch.from_numpy(xs), 4)
    want_img, want_lbl = J.warp_image_and_label(jnp.asarray(images[0]), jnp.asarray(labels[0]),
                                                jnp.asarray(ys), jnp.asarray(xs), 4)
    h, w = RAW
    big = J._fused_warp_coeffs(jnp.asarray(images[0]), jnp.asarray(labels[0]), 4)
    scores = np.asarray(J._fused_warp_gather_eval(big, *J._fused_warp_prep(
        jnp.asarray(ys), jnp.asarray(xs), h, w)))[..., 1:]
    edge = np.min([np.abs(ys), np.abs(ys - (h - 1)), np.abs(xs), np.abs(xs - (w - 1))],
                  axis=0) <= UNSURE
    unsure = edge | (np.abs(scores - 0.5) <= UNSURE).any(-1)
    assert (ys < 0).any() and (ys > h - 1).any()
    err = np.abs(got_img.numpy() - np.asarray(want_img))[..., 0]
    assert (err[~edge] <= IMAGE_ATOL).all(), err.max()
    differ = got_lbl.numpy() != np.asarray(want_lbl)
    assert not (differ & ~unsure).any(), np.argwhere(differ & ~unsure)


@pytest.mark.parametrize("mode", ["mirror", "reflect"])
def test_prefilter_matrix_and_coefficients(mode):
    np.testing.assert_array_equal(S.prefilter_matrix(23, mode), JS.prefilter_matrix(23, mode))
    img = np.random.RandomState(2).uniform(0, 1, (23, 19, 2)).astype(np.float32)
    got = S.spline_coefficients(torch.from_numpy(img).permute(2, 0, 1), mode).permute(1, 2, 0)
    _close(got, JS.spline_coefficients(jnp.asarray(img), mode), mode)


# ------------------------------------------------------------------- draws
@pytest.mark.parametrize("name", POLICIES + ["no_aug", "gamma", "ACDC_affine_perturb"])
def test_draw_augment_has_the_replayed_layout(name):
    """draw_augment draws exactly the fields JAX's key schedule yields for
    the policy, in the same shapes and dtypes (None where JAX draws nothing)."""
    policy = A.get_policy(name)
    mine = A.draw_augment(torch.Generator().manual_seed(0), policy, N, PAD)
    want = replay_augment_draws(jax.random.PRNGKey(0), policy, N, PAD)
    for f in A.AugmentDraws.__dataclass_fields__:
        a, b = getattr(mine, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if isinstance(b, tuple):
            assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b], f
        elif b is not None:
            assert (a.shape, a.dtype) == (b.shape, b.dtype), f


def test_draw_augment_refuses_a_device_generator():
    class FakeGenerator:
        device = torch.device("meta")

    with pytest.raises(ValueError):
        A.draw_augment(FakeGenerator(), A.get_policy("ACDC_affine"), N, PAD)


# ---------------------------------------------------------------- pipeline
def _jax_unsure(key, images, labels, policy):
    """JAX's own (edge, label) unsure masks for the augmented half: the
    sample coordinates and the gather's class scores of its pre-warp."""
    keys = jax.random.split(key, N)
    img, lbl, ya, xa = jax.vmap(lambda k, i, l: J._augment_pre_warp(
        k, i, l, policy, PAD, CROP))(keys, jnp.asarray(images), jnp.asarray(labels))
    if ya is None:
        none = np.zeros((N, *CROP), bool)
        return none, none
    h, w = PAD
    big = jax.vmap(lambda i, l: J._fused_warp_coeffs(i, l, 4))(img, lbl)
    out = jax.vmap(J._fused_warp_gather_eval)(big, *J._fused_warp_prep(ya, xa, h, w))
    ya, xa, scores = np.asarray(ya), np.asarray(xa), np.asarray(out)[..., 1:]
    edge = np.min([np.abs(ya), np.abs(ya - (h - 1)), np.abs(xa), np.abs(xa - (w - 1))],
                  axis=0) <= UNSURE
    return edge, edge | (np.abs(scores - 0.5) <= UNSURE).any(-1)


@pytest.mark.parametrize("name", POLICIES)
def test_train_pipeline_matches_jax(name, monkeypatch):
    monkeypatch.setenv("TILED_WARP", "0")
    policy = A.get_policy(name)
    images, labels = _phantoms()
    key = jax.random.PRNGKey(KEY)
    draws = replay_augment_draws(key, policy, N, PAD)
    for gate, prob in A.GATES.items():
        u = getattr(draws, gate)
        if u is not None and getattr(policy, prob) < 1:
            fired = u < getattr(policy, prob)
            assert fired.any() and not fired.all(), (name, gate, u)
    want = J.make_batch_train_pipeline(name, PAD, CROP)(key, jnp.asarray(images),
                                                         jnp.asarray(labels))
    got = A.make_batch_train_pipeline(name, PAD, CROP)(draws, torch.from_numpy(images),
                                                       torch.from_numpy(labels))
    want_img, want_lbl = np.asarray(want["image"]), np.asarray(want["label"])
    got_img, got_lbl = got["image"].numpy(), got["label"].numpy()
    assert got_img.shape == want_img.shape == (2 * N, *CROP, 1)
    assert got_lbl.shape == want_lbl.shape and got_lbl.dtype == want_lbl.dtype == np.int32

    edge, unsure = _jax_unsure(key, images, labels, J.get_policy(name))
    edge = np.concatenate([edge, np.zeros_like(edge)])
    unsure = np.concatenate([unsure, np.zeros_like(unsure)])
    err = np.abs(got_img - want_img)[..., 0]
    bad_img = (err > IMAGE_ATOL) & ~edge
    bad_lbl = (got_lbl != want_lbl) & ~unsure
    print(f"{name}: image max err {err[~edge].max():.3g} ({int(edge.sum())} pixels near the "
          f"frame's edge, {int((err > IMAGE_ATOL).sum())} beyond the tolerance); labels "
          f"{int((got_lbl != want_lbl).sum())} differ, {int(unsure.sum())} unsure")
    assert not bad_img.any(), np.argwhere(bad_img)
    assert not bad_lbl.any(), np.argwhere(bad_lbl)
    # the original half is the eval transform: exact
    np.testing.assert_array_equal(got_lbl[N:], want_lbl[N:])


def test_eval_transform_matches_jax():
    images, labels = _phantoms(seed=1)
    want_img, want_lbl = J.make_batch_eval_transform(PAD, CROP)(jnp.asarray(images),
                                                                jnp.asarray(labels))
    got_img, got_lbl = A.make_batch_eval_transform(PAD, CROP)(torch.from_numpy(images),
                                                              torch.from_numpy(labels))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))
    assert got_lbl.dtype == torch.int32
    # odd pads put the extra pixel on the leading side, as in JAX
    got_pad = A.pad_to(torch.from_numpy(labels), PAD).numpy()
    want_pad = np.stack([np.asarray(J.pad_to(jnp.asarray(lb), PAD)) for lb in labels])
    np.testing.assert_array_equal(got_pad, want_pad)


def test_pipeline_variants_agree():
    """``keep_orig=False`` is the augmented half; the indexed pipeline is
    the pipeline on the gathered samples; ``make_batch_augment`` is the
    augmented half too."""
    name = "ACDC_affine_elastic_intensity"
    images, labels = _phantoms(seed=2)
    draws = A.draw_augment(torch.Generator().manual_seed(3), A.get_policy(name), N, PAD)
    imgs, lbls = torch.from_numpy(images), torch.from_numpy(labels)
    full = A.make_batch_train_pipeline(name, PAD, CROP)(draws, imgs, lbls)
    aug = A.make_batch_train_pipeline(name, PAD, CROP, keep_orig=False)(draws, imgs, lbls)
    assert torch.equal(aug["image"], full["image"][:N])
    assert torch.equal(aug["label"], full["label"][:N])
    a_img, a_lbl = A.make_batch_augment(name, PAD, CROP)(draws, imgs, lbls)
    assert torch.equal(a_img, full["image"][:N]) and torch.equal(a_lbl, full["label"][:N])
    idx = torch.tensor([3, 0, 2, 1])
    allx = torch.cat([imgs, imgs.flip(1)])
    ally = torch.cat([lbls, lbls.flip(1)])
    indexed = A.make_batch_train_pipeline_indexed(name, PAD, CROP)(draws, allx, ally, idx)
    direct = A.make_batch_train_pipeline(name, PAD, CROP)(draws, imgs[idx], lbls[idx])
    assert torch.equal(indexed["image"], direct["image"])
    assert torch.equal(indexed["label"], direct["label"])


def test_augmented_batch_feeds_the_train_step():
    """The pipeline's output is what ``CooperativeTrainer.train_step`` takes:
    one step on it at 32x32 gives finite losses."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
        LatentDAConfig,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
        CooperativeTrainer,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
        draw_step,
    )

    name = "ACDC_affine_elastic_intensity"
    images, labels = _phantoms(seed=3)
    gen = torch.Generator().manual_seed(4)
    draws = A.draw_augment(gen, A.get_policy(name), N, PAD)
    batch = A.make_batch_train_pipeline(name, PAD, CROP)(draws, torch.from_numpy(images),
                                                         torch.from_numpy(labels))
    lda = LatentDAConfig()
    trainer = CooperativeTrainer(lda, device="cpu")
    metrics = trainer.train_step(batch["image"], batch["label"],
                                 draw_step(gen, 2 * N, CROP, lda))
    assert all(torch.isfinite(v) for v in metrics.values()), metrics
