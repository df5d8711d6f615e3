"""The port's Decathlon prostate data layer, host-side transforms and
``Params`` against the JAX package's on the CPU.

- ``data/host_transforms.py`` (a copy): every function equal to JAX's on
  seeded numpy inputs (exactly: the same numpy/scipy calls);
- ``data/splits.py:train_test_split`` (numpy) equal to scikit-learn's for
  the float and int sizes the split policies use;
- ``data/prostate.py``: the split policy of every identifier and several
  ``cval`` equal to JAX's (which calls scikit-learn) on a fixture tree
  built as ``tests/test_data.py:263-310`` builds it, plus a stray file at
  the root; the dataset's slices, test volumes, ids and the binary mode
  equal to JAX's;
- ``config.Params``: a JSON file's keys as attributes, ``update``,
  ``save`` and ``dict``, as JAX's.
"""

import json

import numpy as np
import pytest
from sklearn.model_selection import train_test_split as sk_train_test_split

from cooperative_training_and_latent_space_data_augmentation_tpu import config as JC
from cooperative_training_and_latent_space_data_augmentation_tpu.data import (
    host_transforms as JH,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.data import prostate as JP
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import config as PC
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import data as PD
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import (
    host_transforms as PH,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import prostate as PP
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    write_nrrd,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
    train_test_split,
)


# ------------------------------------------------------- host transforms
@pytest.mark.parametrize("shape,target", [((20, 24), (16, 30)), ((13, 9), (20, 20)),
                                          ((30, 31), (12, 12)), ((10, 40), (25, 25))])
def test_crop_pad_and_reverse_equal_jax(shape, target):
    rng = np.random.RandomState(sum(shape))
    x = rng.rand(*shape).astype(np.float32)
    for a, kw in ((x, {}), (rng.rand(*shape, 3), {}), (rng.rand(2, *shape), {"chw": True})):
        np.testing.assert_array_equal(PH.crop_pad(a, *target, **kw), JH.crop_pad(a, *target, **kw))
    cropped = JH.crop_pad(x, *target)
    for a in (cropped, np.stack([cropped] * 3), np.stack([np.stack([cropped] * 2)] * 2)):
        np.testing.assert_array_equal(PH.reverse_crop_pad(a, *shape),
                                      JH.reverse_crop_pad(a, *shape))


@pytest.mark.parametrize("interp", ["bilinear", "nearest"])
def test_resize_and_rotate_equal_jax(interp):
    rng = np.random.RandomState(5)
    x = rng.rand(23, 17).astype(np.float32)
    np.testing.assert_array_equal(PH.my_resize(x, (31, 12), interp), JH.my_resize(x, (31, 12),
                                                                                   interp))
    for deg, crop in ((0.0, False), (17.0, False), (-40.0, True), (95.0, True)):
        np.testing.assert_array_equal(PH.my_rotate(x, deg, (30, 30), interp, crop),
                                      JH.my_rotate(x, deg, (30, 30), interp, crop))
    for angle in (0.1, 1.0, 2.0, 4.0):
        assert PH.largest_rotated_rect(20, 30, angle) == JH.largest_rotated_rect(20, 30, angle)


# ----------------------------------------------------- train_test_split
@pytest.mark.parametrize("kw", [{"test_size": 0.1}, {"train_size": 3}, {"train_size": 0.4},
                                {"train_size": 0.5}, {}])
@pytest.mark.parametrize("n", [7, 19, 30])
def test_train_test_split_equals_sklearn(kw, n):
    ids = [f"p{i:02d}" for i in range(n)]
    for seed in (0, 1, 4):
        want = sk_train_test_split(ids, random_state=seed, **kw)
        assert list(train_test_split(ids, random_state=seed, **kw)) == [list(w) for w in want]


# -------------------------------------------------------------- prostate
def _make_prostate_root(tmp_path, n_patients=24, z=3, hw=16):
    """``tests/test_data.py``'s fixture tree (more patients, so that the
    few-shot identifiers have room), with a stray file at its root."""
    rng = np.random.RandomState(0)
    root = tmp_path / "prostate"
    for i in range(1, n_patients + 1):
        d = root / f"patient_{i:02d}"
        d.mkdir(parents=True)
        write_nrrd(str(d / "t2_img.nrrd"), rng.rand(z, hw, hw).astype(np.float32))
        write_nrrd(str(d / "label.nrrd"), rng.randint(0, 3, (z, hw, hw)).astype(np.int16))
    (root / "dataset.json").write_text("{}")
    return str(root)


@pytest.fixture(scope="module")
def prostate_root(tmp_path_factory):
    return _make_prostate_root(tmp_path_factory.mktemp("data"))


@pytest.mark.parametrize("identifier", ["all", "three_shot", "three_shot_upperbound", "full",
                                        "0.5", "2", "7"])
def test_prostate_split_policy_equals_jax(prostate_root, identifier):
    for cval in (1, 2, 3):
        assert (PP.get_prostate_split_policy(prostate_root, identifier, cval)
                == JP.get_prostate_split_policy(prostate_root, identifier, cval)), cval
    assert PD.get_prostate_split_policy is PP.get_prostate_split_policy
    with pytest.raises(ValueError):
        PP.get_prostate_split_policy(prostate_root, identifier, 0)


@pytest.mark.parametrize("split,kw", [("train", {"data_setting": "three_shot"}),
                                      ("validate", {}), ("test", {"binary_segmentation": True}),
                                      ("unlabelled", {"data_setting": "full", "cval": 2})])
def test_prostate_dataset_equals_jax(prostate_root, split, kw):
    args = dict(split=split, pad_size=(16, 16), **kw)
    got, want = PD.ProstateDecathlonDataset(prostate_root, **args), JP.ProstateDecathlonDataset(
        prostate_root, **args)
    assert len(got) == len(want) > 0
    assert got.patient_ids == want.patient_ids and got.dataset_name == want.dataset_name
    assert got.voxelspacing == want.voxelspacing == [0.625, 0.625, 3.6]
    assert got.num_classes == want.num_classes
    for i in range(len(want)):
        for g, w in zip(got.load_data(i), want.load_data(i)):
            np.testing.assert_array_equal(g, w)
    for k in range(want.get_patient_num()):
        assert got.get_id(k) == want.get_id(k)
        for g, w in zip(got.get_patient_data_for_testing(k, crop_size=(12, 20)),
                        want.get_patient_data_for_testing(k, crop_size=(12, 20))):
            np.testing.assert_array_equal(g, w)
    if kw.get("binary_segmentation"):
        assert set(np.unique(got.get_patient_data_for_testing(0)[1])) <= {0, 1}


# ----------------------------------------------------------------- Params
def test_params_round_trip(tmp_path):
    path, more, out = tmp_path / "a.json", tmp_path / "b.json", tmp_path / "c.json"
    path.write_text(json.dumps({"lr": 0.001, "name": "x", "nested": {"k": [1, 2]}}))
    more.write_text(json.dumps({"lr": 0.01, "extra": True}))
    got, want = PC.Params(str(path)), JC.Params(str(path))
    assert got.lr == want.lr == 0.001 and got.nested == {"k": [1, 2]}
    got.update(str(more))
    want.update(str(more))
    assert got.dict == want.dict == {"lr": 0.01, "name": "x", "nested": {"k": [1, 2]},
                                     "extra": True}
    got.save(str(out))
    assert json.loads(out.read_text()) == want.dict
    assert PC.Params(str(out)).dict == got.dict
