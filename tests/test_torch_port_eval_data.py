"""The held-out evaluation's data side against the JAX package's on the CPU:
the split policies (against scikit-learn's ``train_test_split``, which the
JAX package calls), NRRD and NIfTI files written by one package and read
by the other, the preprocessing functions, the synthetic ACDC tree's
writer, and the ACDC and M&Ms datasets on that tree.

Every comparison is exact (``==`` or ``np.array_equal``): these are copies
of host code on the same numpy and scipy, so any difference is a fault.
Inputs are made from seeds with numpy.  The tree is 2 patients x ED/ES
of 10 slices at the writer's 224x224 (about 2 s to write and read).
"""

import gzip
import os

import numpy as np
import pytest
from sklearn.model_selection import train_test_split

from cooperative_training_and_latent_space_data_augmentation_tpu.data import acdc as JA
from cooperative_training_and_latent_space_data_augmentation_tpu.data import mnm as JMM
from cooperative_training_and_latent_space_data_augmentation_tpu.data import nifti as JN
from cooperative_training_and_latent_space_data_augmentation_tpu.data import preprocess as JP
from cooperative_training_and_latent_space_data_augmentation_tpu.data import splits as JSP
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    make_synthetic_acdc as W,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import acdc as A
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import mnm as MM
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import nifti as N
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import preprocess as P
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import splits as SP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIDS = ("007", "008")
CVALS = range(5)
ACDC_IDS = ["standard", "1", "3", "5", "10", "20", "25", "39", "40", "0.1", "0.25", "0.5",
            "0.99", "one_shot", "one_shot_upperbound", "three_shot",
            "three_shot_upperbound", "25_shot_upperbound"]
UKBB_IDS = ["15_shot", "five_shot", "three_shot", "one_shot", "full"]


# ------------------------------------------------------------------- splits
@pytest.mark.parametrize("identifier", ACDC_IDS)
def test_acdc_split_policy_matches_jax(identifier):
    """Every list of every policy equal to the JAX package's (scikit-learn
    1.9.0's draws), cvals 0-4."""
    for cval in CVALS:
        assert SP.get_ACDC_split_policy(identifier, cval) == JSP.get_ACDC_split_policy(
            identifier, cval), (identifier, cval)


@pytest.mark.parametrize("identifier", UKBB_IDS)
def test_ukbb_split_policy_matches_jax(identifier):
    for cval in CVALS:
        assert SP.get_UKBB_split_policy(identifier, cval) == JSP.get_UKBB_split_policy(
            identifier, cval), (identifier, cval)


@pytest.mark.parametrize("identifier", ["45", "50", "two_shot"])
def test_split_policies_refuse_alike(identifier):
    for get in (SP.get_ACDC_split_policy, JSP.get_ACDC_split_policy):
        with pytest.raises(NotImplementedError):
            get(identifier, 0)
    for get in (SP.get_UKBB_split_policy, JSP.get_UKBB_split_policy):
        with pytest.raises(NotImplementedError):
            get(identifier, 0)


@pytest.mark.parametrize("n", [2, 7, 40, 100])
def test_train_subset_is_sklearns_train_part(n):
    """``train_subset`` against ``train_test_split``'s train part for int
    and fractional sizes, seeds 0-9."""
    ids = [f"{i:03d}" for i in range(n)]
    sizes = sorted({1, n // 2, n - 1} | {0.5, 0.3, 0.99})
    for seed in range(10):
        for size in sizes:
            if isinstance(size, float) and int(np.floor(size * n)) == 0:
                continue
            want, _ = train_test_split(ids, train_size=size, random_state=seed)
            assert SP.train_subset(ids, size, seed) == want, (n, size, seed)


# ------------------------------------------------------------- NRRD, NIfTI
def _volume(dtype, seed):
    rng = np.random.RandomState(seed)
    if np.dtype(dtype).kind == "f":
        return rng.normal(0, 3, (5, 7, 9)).astype(dtype)
    return rng.randint(0, 100, (5, 7, 9)).astype(dtype)


@pytest.mark.parametrize("fmt", ["nrrd", "nrrd_raw", "nii", "nii.gz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int16", "uint8", "int32"])
def test_volume_files_cross_read(tmp_path, fmt, writer, dtype):
    """A volume written by one package reads back equal, with its spacing,
    in both."""
    vol = _volume(dtype, seed=len(fmt) * 7 + len(dtype))
    spacing = (1.36719, 0.5, 10.0)
    write_mod = N if writer == "port" else JN
    path = str(tmp_path / f"v.{fmt.replace('_raw', '')}")
    if fmt.startswith("nrrd"):
        write_mod.write_nrrd(path, vol, spacing, encoding="raw" if fmt == "nrrd_raw" else "gzip")
        readers = (N.read_nrrd, JN.read_nrrd)
    else:
        write_mod.write_nifti(path, vol, spacing)
        readers = (N.read_nifti, JN.read_nifti)
    (got, got_sp), (want, want_sp) = (r(path) for r in readers)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vol)
    assert got_sp == want_sp
    np.testing.assert_allclose(got_sp, spacing, rtol=1e-6)  # NIfTI stores float32


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("new_spacing", [None, (1.36719, 1.36719, -1.0), (0.9, 1.2, 5.0)])
def test_load_img_label_from_path_matches_jax(tmp_path, normalize, new_spacing):
    img, lbl = _volume("float32", 1), _volume("int16", 2) % 4
    N.write_nifti(str(tmp_path / "img.nii.gz"), img, (1.1, 1.3, 8.0))
    N.write_nrrd(str(tmp_path / "seg.nrrd"), lbl, (1.1, 1.3, 8.0))
    args = (str(tmp_path / "img.nii.gz"), str(tmp_path / "seg.nrrd"), new_spacing, normalize)
    got, want = N.load_img_label_from_path(*args), JN.load_img_label_from_path(*args)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]


# ----------------------------------------------------------- preprocessing
def test_preprocess_functions_match_jax():
    vol = _volume("float32", 5) * 100
    lbl = _volume("int16", 6) % 4
    np.testing.assert_array_equal(P.normalize_minmax_data(vol), JP.normalize_minmax_data(vol))
    np.testing.assert_array_equal(P.swap_labels_acdc(lbl), JP.swap_labels_acdc(lbl))
    for order, arr in ((1, vol), (0, lbl)):
        for target in ((1.36719, 1.36719, -1.0), (0.7, 2.1, 3.0), (1.0, 1.0, 1.0)):
            np.testing.assert_array_equal(
                P.resample_by_spacing(arr, (1.0, 1.0, 1.0), target, order=order),
                JP.resample_by_spacing(arr, (1.0, 1.0, 1.0), target, order=order))
        np.testing.assert_array_equal(
            P.resample_by_ref(arr, (1.0, 1.2, 4.0), (3, 9, 11), (1.5, 0.8, 6.0), order=order),
            JP.resample_by_ref(arr, (1.0, 1.2, 4.0), (3, 9, 11), (1.5, 0.8, 6.0), order=order))


def test_preprocess_acdc_dataset_matches_jax(tmp_path):
    """The raw-ACDC driver on a one-patient NIfTI tree: both packages write
    the same volumes."""
    raw = tmp_path / "raw" / "patient001"
    raw.mkdir(parents=True)
    (raw / "Info.cfg").write_text("ED: 1\nES: 3\n")
    for frame in (1, 3):
        N.write_nifti(str(raw / f"patient001_frame{frame:02d}.nii.gz"),
                      _volume("float32", frame) * 50, (1.5, 1.5, 10.0))
        N.write_nifti(str(raw / f"patient001_frame{frame:02d}_gt.nii.gz"),
                      (_volume("int16", frame + 10) % 4).astype(np.uint8), (1.5, 1.5, 10.0))
    assert P.preprocess_acdc_dataset(str(tmp_path / "raw"), str(tmp_path / "port")) == 2
    assert JP.preprocess_acdc_dataset(str(tmp_path / "raw"), str(tmp_path / "jax")) == 2
    for frame in ("ED", "ES"):
        for kind in ("img", "seg"):
            got = N.read_nrrd(str(tmp_path / "port" / "001" / f"{frame}_{kind}.nrrd"))
            want = N.read_nrrd(str(tmp_path / "jax" / "001" / f"{frame}_{kind}.nrrd"))
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]


# ------------------------------------------------------ the synthetic tree
@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's and the JAX package's writers, pids 007 and 008, ED/ES,
    the defaults (10 slices at 224x224)."""
    root = tmp_path_factory.mktemp("synthetic_acdc")
    port, jax_root = str(root / "port"), str(root / "jax")
    assert W.main(["--out_root", port, "--pids", *PIDS]) == list(PIDS)
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_make_synthetic_acdc", os.path.join(REPO, "cli", "make_synthetic_acdc.py"))
    jax_writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_writer)
    for pid in PIDS:
        for frame in ("ED", "ES"):
            jax_writer.write_patient(jax_root, pid, frame, 10, (224, 224), 4)
    return port, jax_root


def test_writer_output_equals_jaxs(trees):
    """Same arrays and spacings, same header bytes, same payload bytes once
    decompressed (the gzip member's mtime differs from run to run)."""
    port, jax_root = trees
    for pid in PIDS:
        for frame in ("ED", "ES"):
            for kind in ("img", "seg"):
                rel = os.path.join(pid, f"{frame}_{kind}.nrrd")
                got, want = N.read_nrrd(os.path.join(port, rel)), JN.read_nrrd(
                    os.path.join(jax_root, rel))
                assert got[0].dtype == want[0].dtype and got[0].shape == (10, 224, 224)
                assert np.array_equal(got[0], want[0]) and got[1] == want[1]
                with open(os.path.join(port, rel), "rb") as f:
                    g_head, g_body = f.read().split(b"\n\n", 1)
                with open(os.path.join(jax_root, rel), "rb") as f:
                    w_head, w_body = f.read().split(b"\n\n", 1)
                assert g_head == w_head
                assert gzip.decompress(g_body) == gzip.decompress(w_body)


def test_writer_default_pids_match_jax():
    """Every pid the JAX writer's default set names (the split policies of
    data_setting 10, cvals 0-2, and the test list)."""
    need = set(JSP.TEST_LIST)
    for cval in (0, 1, 2):
        for ids in JSP.get_ACDC_split_policy("10", cval).values():
            if isinstance(ids, list):
                need.update(ids)
    assert W.default_pids() == sorted(need)


@pytest.mark.parametrize("frame", ["ED", "ES"])
def test_acdc_dataset_matches_jax(trees, frame):
    """``probe_format_names``, ``scan_dataset`` (ids, the slice index map,
    length), slice access and ``get_patient_data_for_testing`` on the tree."""
    port, _ = trees
    fmts = A.probe_format_names(port, frame)
    assert fmts == JA.probe_format_names(port, frame) == (
        "{p_id}/" + "{frame}_img.nrrd", "{p_id}/" + "{frame}_seg.nrrd")
    kw = dict(root_dir=port, frame=frame, split="test", data_setting="10", cval=0,
              image_format_name=fmts[0], label_format_name=fmts[1])
    got, want = A.CardiacACDCDataset(**kw), JA.CardiacACDCDataset(**kw)
    assert got.patient_ids == want.patient_ids == list(PIDS)
    assert got.index_map == want.index_map and len(got) == len(want) == 20
    for i in (0, 9, 13):
        for k in ("image", "label"):
            np.testing.assert_array_equal(got[i][k], want[i][k])
    for p in range(got.get_patient_num()):
        assert got.get_id(p) == want.get_id(p)
        assert got.get_voxel_spacing(p) == want.get_voxel_spacing(p)
        for crop in ((192, 192), (240, 200)):
            for g, w in zip(got.get_patient_data_for_testing(p, crop_size=crop),
                            want.get_patient_data_for_testing(p, crop_size=crop)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["default", "myocardium_only", "raw"])
def test_mm_dataset_matches_jax(trees, mode):
    """``CardiacMMDataset`` (every patient dir; the ACDC-C settings: no
    resample, no normalisation) on the tree."""
    port, _ = trees
    kw = dict(root_dir=port, frame="ES", image_format_name="{p_id}/{frame}_img.nrrd",
              label_format_name="{p_id}/{frame}_seg.nrrd")
    if mode == "myocardium_only":
        kw["myocardium_only"] = True
    if mode == "raw":
        kw.update(if_resample=False, normalize=False, dataset_name="RandomBias")
    got, want = MM.CardiacMMDataset(**kw), JMM.CardiacMMDataset(**kw)
    assert got.patient_ids == want.patient_ids == list(PIDS)
    assert got.dataset_name == want.dataset_name and got.index_map == want.index_map
    for p in range(got.get_patient_num()):
        for g, w in zip(got.get_patient_data_for_testing(p),
                        want.get_patient_data_for_testing(p)):
            np.testing.assert_array_equal(g, w)
