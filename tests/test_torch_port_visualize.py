"""The port's hard-example visualization (``analysis/visualize.py``)
against the JAX package's.

The JAX side is its ``visualize_hard_examples``' array half, written out
here from its own pieces as its ``corrupt`` (``analysis/visualize.py:
166-171``) composes them: ``fast_predict(train=True)``,
``_frozen_decoder_fn`` and ``ops/masking.py:perturb_latent_code`` with
``MaskSettings(mask_type=method, max_threshold=thr, random_threshold=False,
if_soft=True)``, the keys split as its loop splits them (``rng, k1, k2 =
split(rng, 3)`` a method x threshold).  The port gets the same draws,
replayed from those keys (``torch_port_util.replay_code_draws``).  32x32,
batch 2, float32, random weights drawn with numpy.

Held, for each method and threshold: the dropout masks equal; the
targeted masks equal or swapped only next to their threshold
(``assert_masks_agree`` on the saliencies); where the masks are equal, the
corrupted images and segmentation logits within
``1e-5 + 1e-5 * max|JAX|`` (float32 sums in other orders through one
encoder and one decoder), the entropy maps within twice the logits'
bound (the normalised entropy's gradient in the logits sums to at most 2
in absolute value).  Then the PNG grids, written when matplotlib is
installed, the card-free refusals and ``cli.vis_hard_examples``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.analysis import visualize
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    vis_hard_examples as cli_vis,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from torch_port_util import (  # noqa: F401
    BATCH,
    HW,
    assert_masks_agree,
    make_solver,
    one_torch_thread,
    random_variables,
    replay_code_draws,
    saliency_of,
)

SEED = 5
LATENT = (128, HW // 16, HW // 16)


def _jax_arrays(solver, params, stats, images, labels, rng):
    """{(method, thr): (image, seg logits, entropy, image mask, shape mask,
    image code gradient, shape code gradient)} and each case's keys."""
    from cooperative_training_and_latent_space_data_augmentation_tpu.analysis.visualize import (
        prediction_entropy,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu.ops import masking

    keys = {}
    for method in visualize.METHODS:
        for thr in visualize.THRESHOLDS:
            rng, k1, k2 = jax.random.split(rng, 3)
            keys[(method, thr)] = (k1, k2)

    def run(params, stats, images, labels):
        (z_i, z_s), _, _ = solver.fast_predict(params, stats, images, train=True)
        img_dec = solver._frozen_decoder_fn("image_decoder", params, stats)
        seg_dec = solver._frozen_decoder_fn("segmentation_decoder", params, stats)
        out = {}
        for (method, thr), (k1, k2) in keys.items():
            si = masking.MaskSettings("mse", method, thr, False, True)
            ss = masking.MaskSettings("ce", method, thr, False, True)
            mzi, mask_i = masking.perturb_latent_code(z_i, img_dec, images, k1, si,
                                                      solver.num_classes)
            mzs, mask_s = masking.perturb_latent_code(z_s, seg_dec, labels, k2, ss,
                                                      solver.num_classes)
            g_i = jax.grad(lambda z: masking._task_loss(img_dec, z, images, "mse",
                                                        solver.num_classes))(z_i)
            g_s = jax.grad(lambda z: masking._task_loss(seg_dec, z, labels, "ce",
                                                        solver.num_classes))(z_s)
            out[(method, thr)] = (img_dec(mzi), seg_dec(mzs), mask_i, mask_s, g_i, g_s)
        return out

    out = jax.device_get(jax.jit(run)(params, stats, images, labels))
    return {k: (v[0], v[1], np.asarray(prediction_entropy(v[1])), *v[2:])
            for k, v in out.items()}, keys


@pytest.fixture(scope="module")
def case():
    solver = make_solver()
    params, stats = random_variables(solver, seed=SEED)
    rng = np.random.RandomState(SEED)
    images = rng.uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32)
    labels = rng.randint(0, 4, (BATCH, HW, HW)).astype(np.int32)
    want, keys = _jax_arrays(solver, params, stats, jnp.asarray(images), jnp.asarray(labels),
                             jax.random.PRNGKey(SEED + 1))
    draws = {k: (replay_code_draws(k1, visualize.mask_settings(*k, "mse"), BATCH,
                                   LATENT[0], LATENT[1:]),
                 replay_code_draws(k2, visualize.mask_settings(*k, "ce"), BATCH,
                                   LATENT[0], LATENT[1:]))
             for k, (k1, k2) in keys.items()}
    trainer = CooperativeTrainer(None, device="cpu")
    trainer.model.load_state_dicts(convert.from_jax(params, stats))
    got = visualize.hard_example_arrays(trainer, images, labels, draws=draws)
    return images, labels, trainer, got, want


def _atol(want) -> float:
    return 1e-5 + 1e-5 * float(np.abs(np.asarray(want)).max())


def _close(got, want, what, atol=None):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=_atol(want) if atol is None else atol,
                               err_msg=what)


def _rows(mask_nchw, method):
    """The (N, D) mask of a broadcast code mask: per channel, or per
    location in (h, w) order."""
    m = mask_nchw.numpy()
    return m[:, :, 0, 0] if method == "channel" else m[:, 0].reshape(m.shape[0], -1)


@pytest.mark.parametrize("method", visualize.METHODS)
@pytest.mark.parametrize("thr", visualize.THRESHOLDS)
def test_hard_example_arrays_match_jax(case, method, thr):
    _, _, _, got, want = case
    ex = got[(method, thr)]
    image, seg, ent, mask_i, mask_s, g_i, g_s = want[(method, thr)]
    same = True
    for mask, jax_mask, sal, grad, code in ((ex.image_mask, mask_i, ex.image_saliency, g_i,
                                             "image"),
                                            (ex.shape_mask, mask_s, ex.shape_saliency, g_s,
                                             "shape")):
        jax_nchw = np.transpose(np.asarray(jax_mask), (0, 3, 1, 2))
        if method == "dropout":
            np.testing.assert_array_equal(mask.numpy(), jax_nchw, err_msg=code)
            assert sal is None
            continue
        branch = 2 if method == "channel" else 1
        want_sal = saliency_of(grad, branch)
        _close(sal.numpy(), want_sal, f"{code} saliency")
        got_rows, want_rows = _rows(mask, method), _rows(torch.tensor(jax_nchw), method)
        assert_masks_agree(got_rows, want_rows, sal.numpy(), want_sal, thr, code)
        same &= bool(np.array_equal(got_rows, want_rows))
    assert ex.image.shape == (BATCH, HW, HW, 1) and ex.seg_logits.shape == (BATCH, HW, HW, 4)
    if same:
        _close(ex.image.numpy(), image, "image")
        _close(ex.seg_logits.numpy(), seg, "segmentation logits")
        # the entropy map moves by at most twice the logits' gap: a row of
        # the normalised entropy's gradient in the logits sums to at most 2
        _close(ex.entropy.numpy(), ent, "entropy", atol=2 * _atol(seg))


def test_arrays_leave_the_trainer_as_it_was(case):
    """Parameters, BN statistics and module modes are untouched, and no
    gradient is left on a parameter."""
    images, labels, trainer, _, _ = case
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.model.eval()
    visualize.hard_example_arrays(trainer, images, labels,
                                  generator=torch.Generator().manual_seed(0))
    assert not any(m.training for m in trainer.model.modules())
    trainer.model.train()
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())
    assert all(p.grad is None for p in trainer.model.parameters())


def test_layer_dropout_is_refused():
    trainer = CooperativeTrainer(None, device="cpu", encoder_dropout=0.3)
    with pytest.raises(ValueError, match="layer dropout"):
        visualize.hard_example_arrays(trainer, torch.zeros(1, HW, HW, 1),
                                      torch.zeros(1, HW, HW, dtype=torch.long))


def test_grids_and_plots_are_written(case, tmp_path):
    """The PNG half (matplotlib is in this image; the card's machine has
    none): one grid a method x threshold, and the other plots."""
    pytest.importorskip("matplotlib")
    images, _, _, got, _ = case
    paths = visualize.save_hard_example_grids(got, images, str(tmp_path), 4)
    assert sorted(os.path.basename(p) for p in paths) == sorted(
        f"hard_examples_{m}_thr{t}.png" for m, t in got)
    assert all(os.path.getsize(p) > 0 for p in paths)
    cm = np.array([[5, 1], [2, 7]])
    assert visualize.plot_confusion_matrix(cm, ["a", "b"], str(tmp_path / "cm.png"))
    feats = np.random.RandomState(0).rand(12, 5)
    assert visualize.plot_embedding(feats, np.arange(12) % 3, str(tmp_path / "e.png"))
    assert visualize.plot_intensity_distributions({"x": feats}, str(tmp_path / "i.png"))
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    assert visualize.plot_image(feats, ax=ax) is ax
    plt.close(fig)
    for name in ("cm.png", "e.png", "i.png"):
        assert (tmp_path / name).stat().st_size > 0


def test_cli_writes_arrays_and_grids(tmp_path, capsys):
    """``cli.vis_hard_examples --random_init --device cpu`` (192x192
    slices, as the protocol crops them)."""
    out = tmp_path / "vis"
    paths = cli_vis.main(["--random_init", "--out_dir", str(out), "--device", "cpu",
                          "--n_samples", "2", "--methods", "dropout", "channel",
                          "--thresholds", "0.5"])
    arrays = np.load(out / "hard_examples.npz")
    assert arrays["images"].shape == (2, 192, 192, 1)
    assert arrays["channel_thr0.5_seg_logits"].shape == (2, 192, 192, 4)
    assert np.isfinite(arrays["dropout_thr0.5_entropy"]).all()
    assert len(paths) == 3 and "2 grids" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_vis.main(["--out_dir", str(out), "--device", "cpu"])
