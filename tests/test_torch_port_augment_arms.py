"""The augmentation's remaining arms (``ops/augment.py``) against the JAX
package's on the CPU: the warp arms ``two_gather`` (JAX's
``FUSED_WARP=0``: ``warp_image`` and ``warp_label`` apart) and
``sequential`` (``SEQ_WARP=1``: the affine resample at the padded size,
then the elastic one composed with the crop), ``eval_transform_sample``,
``make_batch_eval_transform``, ``Transformations``, ``motion_estimation``
(on JAX's normals replayed from its key) and ``clahe``.

JAX reads ``FUSED_WARP``/``SEQ_WARP`` when it traces, so each arm gets a
fresh JAX pipeline under ``monkeypatch`` (as ``tests/test_augment.py``
does), with ``TILED_WARP=0`` as in ``test_torch_port_augment.py``.  The
sizes and tolerances are that file's: raw 31x33 phantoms padded to 40x40
and cropped to 32x32, batch 4, JAX's draws replayed; images within
``IMAGE_ATOL`` = 5e-5, labels equal, except at the pixels
``augment.unsure_pixels(warp=...)`` marks (a sample coordinate within
1e-3 of the frame's edge, a class score within 1e-3 of 0.5, and for the
sequential arm a second-resample coordinate within
``SEQUENTIAL_REACH`` = 9 pixels of a first-resample pixel that is
unsure), at most ``MAX_UNSURE`` of the augmented half: 2 % for
``two_gather`` (measured 0), 5 % for ``sequential`` (measured 2.2-2.5 %:
at this size one unsure first-resample pixel reaches a 19x19 square, a
third of the crop; no pixel differed at all).  The policies: the main
path's (affine and elastic), an affine one without an elastic field and
the one with every stage.  ``clahe`` is numpy on both sides: exactly
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import one_torch_thread, replay_augment_draws  # noqa: F401 - a fixture

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import augment as J
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    make_phantom,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import augment as A

RAW = (31, 33)
PAD = (40, 40)
CROP = (32, 32)
N = 4
KEY = 0
IMAGE_ATOL = 5e-5
MAX_UNSURE = {"two_gather": 0.02, "sequential": 0.05}
ENV = {"two_gather": {"FUSED_WARP": "0"}, "sequential": {"SEQ_WARP": "1"}}
POLICIES = ["ACDC_affine_elastic_intensity", "Atrial_perturb", "ACDC_affine_all"]


def _phantoms(seed=0):
    rs = [make_phantom(np.random.RandomState(seed * 100 + s), RAW) for s in range(N)]
    return (np.stack([r[0] for r in rs]).astype(np.float32),
            np.stack([r[1] for r in rs]).astype(np.int32))


@pytest.mark.parametrize("warp", ["two_gather", "sequential"])
@pytest.mark.parametrize("name", POLICIES)
def test_warp_arm_matches_jax(name, warp, monkeypatch):
    monkeypatch.setenv("TILED_WARP", "0")
    for k, v in ENV[warp].items():
        monkeypatch.setenv(k, v)
    images, labels = _phantoms()
    key = jax.random.PRNGKey(KEY)
    draws = replay_augment_draws(key, A.get_policy(name), N, PAD)
    want = J.make_batch_train_pipeline(name, PAD, CROP)(key, jnp.asarray(images),
                                                         jnp.asarray(labels))
    imgs, lbls = torch.from_numpy(images), torch.from_numpy(labels)
    got = A.make_batch_train_pipeline(name, PAD, CROP, warp=warp)(draws, imgs, lbls)
    composed = A.make_batch_train_pipeline(name, PAD, CROP)(draws, imgs, lbls)
    want_img, want_lbl = np.asarray(want["image"]), np.asarray(want["label"])
    got_img, got_lbl = got["image"].numpy(), got["label"].numpy()
    assert got_img.shape == want_img.shape == (2 * N, *CROP, 1)
    assert got_lbl.dtype == want_lbl.dtype == np.int32
    edge, unsure = (m.numpy() for m in A.unsure_pixels(draws, imgs, lbls, name, PAD, CROP,
                                                        warp=warp))
    err = np.abs(got_img - want_img)[..., 0]
    share = unsure[:N].mean()
    print(f"{name} {warp}: image max err {err[~edge].max():.3g}, labels differ at "
          f"{int((got_lbl != want_lbl).sum())}, unsure {int(unsure.sum())} ({share:.2%}); "
          f"against the composed arm: {float((got['image'] - composed['image']).abs().max()):.3g}")
    assert not ((err > IMAGE_ATOL) & ~edge).any(), np.argwhere((err > IMAGE_ATOL) & ~edge)
    assert not ((got_lbl != want_lbl) & ~unsure).any()
    assert share <= MAX_UNSURE[warp]
    np.testing.assert_array_equal(got_lbl[N:], want_lbl[N:])
    policy = A.get_policy(name)
    if warp == "sequential" and (policy.elastic_prob or policy.elastic_prob_v2):
        # two resamples blur: not the composed arm's output (without an
        # elastic field the second one samples the nodes, and they agree)
        assert float((got["image"] - composed["image"]).abs().max()) > 1e-3


def test_warp_arms_refuse_an_unknown_name():
    with pytest.raises(ValueError):
        A.make_batch_train_pipeline("ACDC_affine_elastic_intensity", PAD, CROP, warp="tiled")


@pytest.mark.parametrize("with_label", [True, False])
def test_eval_transform_sample_matches_jax(with_label):
    """One sample against JAX's (run op by op, unjitted: its normalisation
    rounds apart from the jitted one, so within 1e-5 of the [0, 1] scale)
    and the batch against JAX's jitted one within 1e-6."""
    images, labels = _phantoms(seed=1)
    for i in range(2):
        want = J.eval_transform_sample(jnp.asarray(images[i]),
                                       jnp.asarray(labels[i]) if with_label else None, PAD, CROP)
        got = A.eval_transform_sample(torch.from_numpy(images[i]),
                                      torch.from_numpy(labels[i]) if with_label else None,
                                      PAD, CROP)
        if with_label:
            np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            assert got[1].dtype == torch.int32
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    want_i, want_l = J.make_batch_eval_transform(PAD, CROP)(jnp.asarray(images),
                                                            jnp.asarray(labels))
    got_i, got_l = A.make_batch_eval_transform(PAD, CROP)(torch.from_numpy(images),
                                                          torch.from_numpy(labels))
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_transformations_match_jax(monkeypatch):
    """The four named pipelines: 'train' and 'aug_validate' the batch
    augmentation on JAX's replayed draws, 'validate' and 'test' the eval
    transform."""
    monkeypatch.setenv("TILED_WARP", "0")
    name = "ACDC_affine_elastic_intensity"
    images, labels = _phantoms(seed=2)
    want = J.Transformations(name, PAD, CROP).get_transformation()
    got = A.Transformations(name, PAD, CROP).get_transformation()
    assert set(got) == set(want) == {"train", "validate", "test", "aug_validate"}
    imgs, lbls = torch.from_numpy(images), torch.from_numpy(labels)
    key = jax.random.PRNGKey(3)
    draws = replay_augment_draws(key, A.get_policy(name), N, PAD)
    w_img, w_lbl = want["train"](key, jnp.asarray(images), jnp.asarray(labels))
    g_img, g_lbl = got["train"](draws, imgs, lbls)
    edge, unsure = (m.numpy() for m in A.unsure_pixels(draws, imgs, lbls, name, PAD, CROP,
                                                        keep_orig=False))
    err = np.abs(g_img.numpy() - np.asarray(w_img))[..., 0]
    assert not ((err > IMAGE_ATOL) & ~edge).any()
    assert not ((g_lbl.numpy() != np.asarray(w_lbl)) & ~unsure).any()
    assert got["aug_validate"] is got["train"]
    v_img, v_lbl = want["validate"](jnp.asarray(images), jnp.asarray(labels))
    gv_img, gv_lbl = got["validate"](imgs, lbls)
    np.testing.assert_allclose(gv_img.numpy(), np.asarray(v_img), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gv_lbl.numpy(), np.asarray(v_lbl))
    np.testing.assert_allclose(got["test"](imgs).numpy(), np.asarray(want["test"](
        jnp.asarray(images))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shift", [1.0, 2.5])
def test_motion_estimation_matches_jax(shift):
    """On JAX's normals (``normal(key, (n, 2))``, replayed as the draws),
    the shifted stack equals JAX's; ``draw_motion`` draws (n, 2) unit
    normals from a CPU generator."""
    _, labels = _phantoms(seed=3)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = J.motion_estimation(key, jnp.asarray(labels), shift)
        normals = torch.from_numpy(np.array(jax.random.normal(key, (N, 2))))
        got = A.motion_estimation(normals, torch.from_numpy(labels), shift)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
    draws = A.draw_motion(torch.Generator().manual_seed(0), 5)
    assert draws.shape == (5, 2) and draws.dtype == torch.float32


@pytest.mark.parametrize("shape,kw", [((64, 64), {}), ((50, 37), {"clip_limit": 0.03}),
                                      ((32, 48), {"nbins": 64, "tile_grid": (4, 6)})])
def test_clahe_equals_jax(shape, kw):
    rng = np.random.RandomState(sum(shape))
    image = (rng.gamma(2.0, 0.3, shape) * 100).astype(np.float32)
    np.testing.assert_array_equal(A.clahe(image, **kw), J.clahe(image, **kw))
    flat = np.full(shape, 3.0, np.float32)
    np.testing.assert_array_equal(A.clahe(flat), J.clahe(flat))


@pytest.mark.parametrize("flags,check", [
    (["--fused_stn", "--warp", "two_gather"],
     lambda t, b: t.fused_stn and not t.fused_ftn and b == "two_gather"),
    (["--fused_ftn", "--fused_stn", "--warp", "sequential"],
     lambda t, b: t.fused_ftn and not t.fused_stn and b == "sequential"),
])
def test_cli_train_takes_the_fused_and_warp_flags(tmp_path, monkeypatch, flags, check):
    """``cli.train --fused_stn/--fused_ftn --warp`` reach the trainer and the
    batcher, and an epoch trains on the CPU (small phantoms)."""
    import json

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import loader

    warps = []
    batcher = loader.CooperativeBatcher

    def recording(*args, warp="composed", **kw):
        warps.append(warp)
        return batcher(*args, warp=warp, **kw)

    monkeypatch.setattr(loader, "CooperativeBatcher", recording)
    monkeypatch.setattr("cooperative_training_and_latent_space_data_augmentation_tpu_torch."
                        "train.driver.CooperativeBatcher", recording)
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"data": {"pad_size": [40, 40, 1], "crop_size": [32, 32, 1]},
                                "learning": {"batch_size": 4}}))
    args = cli.parse_args(["--json_config_path", str(path), "--device", "cpu", "--synthetic",
                           "--synthetic_train_length", "2", "--synthetic_val_length", "2",
                           "--max_epochs", "1", "--save_dir", str(tmp_path / "runs"), *flags])
    conf, name = cli.load_config(args)
    trainer, result = cli.run(args, conf, name)
    assert check(trainer, warps[0]) and len(result.epochs) == 1
    assert np.isfinite(result.epochs[0].losses).all()
