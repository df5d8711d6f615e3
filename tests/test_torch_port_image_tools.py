"""The port's image helpers (``ops/image.py``), dataset helpers
(``data/base.py``) and host-only entries (``cli/preprocess.py``,
``cli/validate_dataset.py``) against the JAX package's.

The random helpers take their draws as operands; the draws are replayed
from JAX's keys as JAX splits them (``shuffle_tensor``: ``randint(rng, (),
1, N)``; in/outpainting: ``k_mask, k_noise = split(rng)``, a key a sample
from ``split(k_mask, N)``, four keys a block from ``split(key, 4 *
n_blocks)``, the noise ``uniform(k_noise, shape)``), so every output must
equal JAX's exactly; the float32 normalisations within 1e-6 of their
scale (a mean, a std or a sum in another order).  The entries run on a
tiny raw NIfTI tree (preprocess) and a tiny synthetic NRRD tree
(validation) beside the root ``cli/`` entries, which must write the same
volumes and print the same report.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import image as J
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    make_synthetic_acdc,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    preprocess as port_preprocess,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    validate_dataset as port_validate,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import base
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import nifti as N
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import image as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.RandomState(0)
X4 = RNG.uniform(-1, 2, (3, 10, 12, 2)).astype(np.float32)  # NHWC
PROBS = RNG.uniform(0, 1, (2, 6, 6, 4)).astype(np.float32)


def _close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=what)


def test_normalisations_match_jax():
    x = torch.from_numpy(X4)
    _close(P.rescale_intensity(x), J.rescale_intensity(jnp.asarray(X4)))
    _close(P.rescale_intensity(x, -1.0, 3.0), J.rescale_intensity(jnp.asarray(X4), -1.0, 3.0))
    _close(P.z_score_intensity(x), J.z_score_intensity(jnp.asarray(X4)))
    for p_norm in (False, True):
        _close(P.unit_norm(x, p_norm), J.unit_norm(jnp.asarray(X4), p_norm))
    for soft in (True, False):
        _close(P.sharpen_predictions(torch.from_numpy(PROBS), 0.5, soft),
               J.sharpen_predictions(jnp.asarray(PROBS), 0.5, soft))
    got = P.filter_unlabelled_predictions(torch.from_numpy(PROBS).requires_grad_(), 0.6)
    assert not got.requires_grad
    np.testing.assert_array_equal(got.numpy(),
                                  J.filter_unlabelled_predictions(jnp.asarray(PROBS), 0.6))


@pytest.mark.parametrize("crop", [(6, 7), (14, 15), (8, 16), (10, 12)])
def test_crop_pad_and_recover_match_jax(crop):
    nhw = X4[..., 0]
    np.testing.assert_array_equal(P.center_crop_or_pad(torch.from_numpy(nhw), crop, 0.5).numpy(),
                                  J.center_crop_or_pad(jnp.asarray(nhw), crop, 0.5))
    for channel_last, arr in ((True, X4), (False, nhw)):
        np.testing.assert_array_equal(
            P.center_crop_or_pad_nhwc(torch.from_numpy(arr), crop, -1.0, channel_last).numpy(),
            J.center_crop_or_pad_nhwc(jnp.asarray(arr), crop, -1.0, channel_last))
    np.testing.assert_array_equal(P.recover_image(torch.from_numpy(nhw), 2, 3, 16, 20).numpy(),
                                  J.recover_image(jnp.asarray(nhw), 2, 3, 16, 20))


def test_shuffle_matches_jax_on_its_draw():
    key = jax.random.PRNGKey(3)
    shift = int(jax.random.randint(key, (), 1, X4.shape[0]))
    np.testing.assert_array_equal(P.shuffle_tensor(torch.from_numpy(X4), shift).numpy(),
                                  J.shuffle_tensor(key, jnp.asarray(X4)))
    gen = torch.Generator().manual_seed(0)
    assert all(1 <= P.draw_shuffle_shift(gen, 3) < 3 for _ in range(20))


def _replay_painting(key, shape, n_blocks, min_frac, max_frac):
    """JAX's in/outpainting draws from ``key`` as (boxes, noise)."""
    n, h, w = shape[:3]
    k_mask, k_noise = jax.random.split(key)
    ranges = ((int(h * min_frac), max(int(h * max_frac), int(h * min_frac) + 1)),
              (int(w * min_frac), max(int(w * max_frac), int(w * min_frac) + 1)),
              (3, h - int(h * max_frac) - 3), (3, w - int(w * max_frac) - 3))
    boxes = np.zeros((n, n_blocks, 4), np.int64)
    for i, k in enumerate(jax.random.split(k_mask, n)):
        keys = jax.random.split(k, n_blocks * 4).reshape(n_blocks, 4, 2)
        for b in range(n_blocks):
            for j, (lo, hi) in enumerate(ranges):
                boxes[i, b, j] = int(jax.random.randint(keys[b, j], (), lo, hi))
    noise = np.array(jax.random.uniform(k_noise, shape, jnp.float32))
    return torch.from_numpy(boxes), torch.from_numpy(noise)


@pytest.mark.parametrize("kind", ["inpainting", "outpainting"])
def test_in_and_outpainting_match_jax_on_its_draws(kind):
    image = RNG.uniform(0, 1, (2, 40, 36, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    fracs = (0.1, 0.25) if kind == "inpainting" else (0.25, 0.4)
    boxes, noise = _replay_painting(key, image.shape, 5, *fracs)
    got = getattr(P, f"random_{kind}")(torch.from_numpy(image), boxes, noise)
    np.testing.assert_array_equal(got.numpy(), getattr(J, f"random_{kind}")(key, jnp.asarray(image)))
    # the port's own draws: boxes inside the JAX package's ranges
    b, nz = getattr(P, f"draw_{kind}")(torch.Generator().manual_seed(1), image.shape)
    assert b.shape == (2, 5, 4) and nz.shape == image.shape
    assert (b[..., 0] >= int(40 * fracs[0])).all() and (b[..., 2] >= 3).all()
    mask = P.block_mask(b, (40, 36))
    assert mask.shape == (2, 40, 36) and set(mask.unique().tolist()) <= {0.0, 1.0}


def test_dataset_helpers_match_jax():
    from cooperative_training_and_latent_space_data_augmentation_tpu.data import base as JB
    from cooperative_training_and_latent_space_data_augmentation_tpu.data.synthetic import (
        SyntheticSegDataset as JaxSynthetic,
    )

    port = SyntheticSegDataset(length=5, pad_size=(32, 32), seed=2)
    jax_ds = JaxSynthetic(length=5, pad_size=(32, 32), seed=2)
    np.testing.assert_array_equal(base.get_all_image_array_from_dataset(port),
                                  JB.get_all_image_array_from_dataset(jax_ds))
    np.testing.assert_array_equal(base.get_mean_image(port), JB.get_mean_image(jax_ds))
    with pytest.raises(ValueError, match="empty"):
        base.get_mean_image(SyntheticSegDataset(length=0, pad_size=(32, 32)))
    other = SyntheticSegDataset(length=3, pad_size=(32, 32), seed=4)
    got, want = base.CombinedDataset(port, other), JB.CombinedDataset(port, other)
    assert len(got) == len(want) == 5
    for i in range(5):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


# ------------------------------------------------------------- the entries
def _root_cli(name):
    spec = importlib.util.spec_from_file_location(f"root_cli_{name}",
                                                  os.path.join(REPO, "cli", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_preprocess_entry_matches_the_root_one(tmp_path, monkeypatch):
    raw = tmp_path / "raw" / "patient002"
    raw.mkdir(parents=True)
    (raw / "Info.cfg").write_text("ED: 1\nES: 2\n")
    rng = np.random.RandomState(3)
    for frame in (1, 2):
        N.write_nifti(str(raw / f"patient002_frame{frame:02d}.nii.gz"),
                      rng.uniform(0, 300, (3, 20, 24)).astype(np.float32), (1.6, 1.4, 8.0))
        N.write_nifti(str(raw / f"patient002_frame{frame:02d}_gt.nii.gz"),
                      rng.randint(0, 4, (3, 20, 24)).astype(np.uint8), (1.6, 1.4, 8.0))
    argv = ["--raw_root", str(tmp_path / "raw"), "--out_root"]
    assert port_preprocess.main(argv + [str(tmp_path / "port")]) == 2
    monkeypatch.setattr("sys.argv", ["preprocess.py"] + argv + [str(tmp_path / "jax")])
    _root_cli("preprocess").main()
    for frame in ("ED", "ES"):
        for kind in ("img", "seg"):
            got = N.read_nrrd(str(tmp_path / "port" / "002" / f"{frame}_{kind}.nrrd"))
            want = N.read_nrrd(str(tmp_path / "jax" / "002" / f"{frame}_{kind}.nrrd"))
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


def test_validate_entry_matches_the_root_one(tmp_path, capsys):
    """Both validators on a synthetic tree of two pids (most split pids
    missing: a NO-GO with FAIL lines) and as an M&Ms root: the same report
    and exit code."""
    tree = str(tmp_path / "acdc")
    make_synthetic_acdc.main(["--out_root", tree, "--pids", "007", "008", "--n_slices", "2",
                              "--hw", "32", "32"])
    capsys.readouterr()
    argv = ["--acdc_root", tree, "--mm_root", tree, "--cvals", "0", "--max_patients", "2"]
    rc_port = port_validate.main(argv)
    report_port = capsys.readouterr().out
    rc_jax = _root_cli("validate_dataset").main(argv)
    report_jax = capsys.readouterr().out
    assert (rc_port, report_port) == (rc_jax, report_jax)
    assert rc_port == 1 and "[FAIL]" in report_port and "[PASS]" in report_port
