"""The held-out evaluation against the JAX package's on the CPU: the volume
metrics, ``RunningSegmentationScore``'s CSVs, the tester, the reader of
JAX checkpoints, and the port's test entry on the seed-40 checkpoint.

Tolerances:

- the metric functions and ``PairwiseMeasures``: within 1e-12 of JAX's
  (copies of the same numpy and scipy code; measured: equal), and the
  same exception on empty masks;
- ``summary.csv`` and ``detail.csv``: byte for byte (the port writes with
  the ``csv`` module what the JAX package writes with pandas);
- ``read_flax_msgpack``: leaf for leaf equal to flax's ``msgpack_restore``
  (same dtype, shape and bits);
- the seed-40 checkpoint
  (``saved/head_to_head/rebuild_seed40_e300/.../best/checkpoints``,
  float32, ``predict(n_iter=2)``) on pids 007 and 008 x ED/ES of the
  synthetic tree, written by the port's writer: each class-volume Dice
  within ``JAX_CPU_ATOL`` = 2e-3 of the JAX package's own CPU evaluation
  of the same checkpoint on the same tree, run here (two float32
  programs on the CPU; a Dice moves 1e-4..1e-3 for each pixel whose
  argmax flips); and within ``TPU_ATOL`` = 0.01 of the matching rows of
  ``saved/head_to_head/rebuild_seed40_e300_eval/ACDC/detail.csv`` (a TPU
  run of the JAX package), their mean of 12 within ``TPU_MEAN_ATOL`` =
  0.003: the JAX package's own CPU run is 0.0063 and 0.0013 from those
  rows, the TPU's convs rounding otherwise.
"""

import os
import types

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization
from torch_port_flax import to_flax
from torch_port_util import one_torch_thread  # noqa: F401 - a fixture

from cooperative_training_and_latent_space_data_augmentation_tpu.data import acdc as JA
from cooperative_training_and_latent_space_data_augmentation_tpu.data.base import (
    ConcatDataset as JConcat,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.data.synthetic import (
    SyntheticSegDataset as JSynthetic,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.eval import metrics as JM
from cooperative_training_and_latent_space_data_augmentation_tpu.eval import (
    pairwise_measures as JPM,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.eval import post_process as JPP
from cooperative_training_and_latent_space_data_augmentation_tpu.eval import tester as JT
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import test as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    make_synthetic_acdc as W,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    read_nrrd,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval import metrics as M
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval import (
    pairwise_measures as PM,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval import post_process as PP
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval import tester as T
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import checkpoint
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED40 = os.path.join(REPO, "saved", "head_to_head", "rebuild_seed40_e300",
                      "train_ACDC_10_n_cls_4", "default", "0", "model", "best", "checkpoints")
SEED40_TPU_CSV = os.path.join(REPO, "saved", "head_to_head", "rebuild_seed40_e300_eval",
                              "ACDC", "detail.csv")
PIDS = ("007", "008")
METRICS = ["Dice", "HD", "ASD", "VolSim", "VolError"]
ATOL = 1e-12
JAX_CPU_ATOL = 2e-3
TPU_ATOL = 0.01
TPU_MEAN_ATOL = 0.003


# ----------------------------------------------------------------- metrics
def _masks(seed, shape):
    """Two overlapping blob masks made from ``seed``."""
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    out = []
    for _ in range(2):
        mask = np.zeros(shape, bool)
        for _ in range(rng.randint(1, 4)):
            c = rng.uniform(0, 1, len(shape)) * np.array(shape)
            r = rng.uniform(2, max(shape) / 3)
            mask |= np.sqrt(((grid - c) ** 2).sum(-1)) < r
        mask ^= rng.rand(*shape) < 0.02
        out.append(mask.astype(np.uint8))
    return out


def _same(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=ATOL, equal_nan=True, err_msg=what)


@pytest.mark.parametrize("seed,shape,spacing", [
    (0, (24, 20), None), (1, (24, 20), (1.36719, 0.7)), (2, (6, 18, 16), None),
    (3, (6, 18, 16), (10.0, 1.36719, 1.36719)), (4, (9, 31, 17), (2.0, 1.0, 0.5))])
def test_metric_functions_match_jax(seed, shape, spacing):
    res, ref = _masks(seed, shape)
    for name in ("dc", "jc", "precision", "recall", "sensitivity", "specificity", "ravd",
                 "volumesimilarity", "volume_sim_index", "VolumeSimIndex"):
        _same(getattr(M, name)(res, ref), getattr(JM, name)(res, ref), name)
    for name in ("hd", "hd95", "asd", "assd", "obj_asd", "obj_assd"):
        for conn in (1, 2):
            _same(getattr(M, name)(res, ref, spacing, conn),
                  getattr(JM, name)(res, ref, spacing, conn), f"{name} {conn}")
    for name in ("obj_fpr", "obj_tpr"):
        for conn in (1, 2):
            _same(getattr(M, name)(res, ref, conn), getattr(JM, name)(res, ref, conn), name)
    _same(M.surface_distances(res, ref, spacing), JM.surface_distances(res, ref, spacing),
          "surface_distances")
    if len(shape) == 3:
        for conn in (1, 2):
            px = None if spacing is None else spacing[1:]
            _same(M.hd_2D_stack(res, ref, px, conn), JM.hd_2D_stack(res, ref, px, conn),
                  "hd_2D_stack")
    labels = res + 2 * ref
    np.testing.assert_array_equal(PP.keep_largest_connected_components(labels, 4),
                                  JPP.keep_largest_connected_components(labels, 4))


def _raised(fn, *args):
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 - the exception itself is compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("which", ["result", "reference", "both"])
def test_metrics_on_empty_masks_match_jax(which):
    """Values or exceptions alike when a mask is empty."""
    res, ref = _masks(5, (5, 16, 16))
    if which in ("result", "both"):
        res = np.zeros_like(res)
    if which in ("reference", "both"):
        ref = np.zeros_like(ref)
    for name in ("dc", "jc", "precision", "recall", "specificity", "ravd",
                 "volumesimilarity", "volume_sim_index"):
        want = _raised(getattr(JM, name), res, ref)
        assert _raised(getattr(M, name), res, ref) == want, name
        if want is None:
            _same(getattr(M, name)(res, ref), getattr(JM, name)(res, ref), name)
    for name in ("hd", "hd95", "asd", "assd", "obj_asd", "obj_assd", "obj_fpr", "obj_tpr",
                 "hd_2D_stack"):
        want = _raised(getattr(JM, name), res, ref)
        assert _raised(getattr(M, name), res, ref) == want, name
        if want is None:
            _same(getattr(M, name)(res, ref), getattr(JM, name)(res, ref), name)


@pytest.mark.parametrize("seed,pixdim", [(6, (1, 1, 1)), (7, (2.0, 1.36719, 0.5))])
def test_pairwise_measures_match_jax(seed, pixdim):
    seg, ref = _masks(seed, (7, 20, 18))
    got = PM.PairwiseMeasures(seg, ref, pixdim=pixdim)
    want = JPM.PairwiseMeasures(seg, ref, pixdim=pixdim)
    assert got.header_str() == want.header_str()
    assert got.to_string("{:.17g}") == want.to_string("{:.17g}")
    empty = np.zeros_like(seg)
    for flag in (False, True):
        g = PM.PairwiseMeasures(empty, ref, pixdim=pixdim, empty=flag,
                                measures=["ppv", "com_dist", "dice", "vol_diff"])
        w = JPM.PairwiseMeasures(empty, ref, pixdim=pixdim, empty=flag,
                                 measures=["ppv", "com_dist", "dice", "vol_diff"])
        assert _raised(g.to_string, "{:.17g}") == _raised(w.to_string, "{:.17g}")
        if _raised(w.to_string, "{:.17g}") is None:
            assert g.to_string("{:.17g}") == w.to_string("{:.17g}")
    reg = seg.astype(np.float64) + np.random.RandomState(seed).normal(0, 0.1, seg.shape)
    assert PM.PairwiseMeasuresRegression(reg, ref).to_string("{:.17g}") == \
        JPM.PairwiseMeasuresRegression(reg, ref).to_string("{:.17g}")
    g_border = PM.MorphologyOps(seg, 8).border_map()
    np.testing.assert_array_equal(g_border, JPM.MorphologyOps(seg, 8).border_map())


# ----------------------------------------------------- the tester and CSVs
class _Volumes:
    """Test volumes whose image is the prediction: slices of class maps
    with the predictor's labels as the image, so an argmax of its one-hot
    is an oracle (``noisy``: the ground truth with pixels flipped,
    classes dropped and added) and ``detail.csv`` holds every kind of
    cell (a class absent from both, from the reference only, from the
    prediction only)."""

    def __init__(self, noisy: bool):
        rng = np.random.RandomState(11)
        self.vols = []
        for i, n in enumerate((4, 13, 7)):
            gt = np.zeros((n, 24, 24), np.int32)
            for c in (1, 2, 3):
                a, b = _masks(20 + 3 * i + c, (n, 24, 24))
                gt[(a > 0) & (gt == 0)] = c
            pred = gt.copy()
            if noisy:
                flip = rng.rand(*gt.shape) < 0.08
                pred[flip] = rng.randint(0, 4, flip.sum())
                if i == 1:
                    gt[gt == 3], pred[pred == 3] = 0, 0    # absent from both
                if i == 2:
                    gt[gt == 2] = 0                        # a false class
                    pred[pred == 1] = 0                    # a missed class
            self.vols.append((pred, gt))
        self.spacings = ([1.36719, 1.36719, -1.0], [1.36719, 1.36719, 10.0], [0.7, 1.3, 5.0])

    def get_patient_num(self):
        return len(self.vols)

    def get_id(self, i):
        return f"{i:03d}_ED"

    def get_voxel_spacing(self, i):
        return list(self.spacings[i])

    def get_patient_data_for_testing(self, i, crop_size=(192, 192)):
        pred, gt = self.vols[i]
        return pred[..., None].astype(np.float32), gt


@pytest.mark.parametrize("noisy", [False, True])
def test_tester_csvs_match_jax_byte_for_byte(tmp_path, noisy):
    """``TestSegmentationNetwork.run`` with the five metrics: the summary,
    ``summary.csv`` and ``detail.csv`` (chunks of 10: volumes of 4, 13 and 7
    slices are padded), top-k and worst-k, as the JAX package's."""
    data = _Volumes(noisy)

    def port_fn(x):
        return F.one_hot(x[..., 0].round().long(), 4).float()

    def jax_fn(x):
        return jax.nn.one_hot(jnp.round(x[..., 0]).astype(jnp.int32), 4)

    got = T.TestSegmentationNetwork(data, port_fn, metrics_list=METRICS,
                                    save_path=str(tmp_path / "port"), device="cpu")
    want = JT.TestSegmentationNetwork(data, jax_fn, metrics_list=METRICS,
                                      save_path=str(tmp_path / "jax"))
    os.makedirs(tmp_path / "port"), os.makedirs(tmp_path / "jax")
    g_sum, w_sum = got.run(), want.run()
    assert list(g_sum) == list(w_sum)
    _same(list(g_sum.values()), list(w_sum.values()), "summary")
    for name in ("summary.csv", "detail.csv"):
        g = (tmp_path / "port" / name).read_bytes()
        w = (tmp_path / "jax" / name).read_bytes()
        assert g == w, (name, g.decode(), w.decode())
    want_rows = want.df.values.tolist()
    assert len(got.rows) == len(want_rows) == 3
    for g, w in zip(got.rows, want_rows):
        assert g[0] == w[0]
        _same(g[1:], w[1:], g[0])
    assert [r["pid"] for r in got.top_k(2)] == [r["pid"] for r in want.top_k(2)]
    assert [r["pid"] for r in got.worst_k(2)] == [r["pid"] for r in want.worst_k(2)]
    for g, w in zip(got.patient_results, want.patient_results):
        np.testing.assert_array_equal(g["pred"], w["pred"])
    txt = M.write_eval_scores_to_disk({"a": got.metric}, str(tmp_path / "p.txt"), ["a"],
                                      METRICS)
    JM.write_eval_scores_to_disk({"a": want.metric}, str(tmp_path / "j.txt"), ["a"], METRICS)
    assert open(txt).read() == open(tmp_path / "j.txt").read()


def test_print_metric_matches_jax(capsys):
    labels = np.random.RandomState(3).randint(0, 4, (2, 16, 16))
    preds = np.random.RandomState(4).randint(0, 4, (2, 16, 16))
    got, want = M.RunningScore(4, device="cpu"), JM.RunningScore(4)
    got.update(labels, preds)
    want.update(labels, preds)
    g = M.print_metric(got, "val")
    g_out = capsys.readouterr().out
    w = JM.print_metric(want, "val")
    assert g_out == capsys.readouterr().out and g == w


def test_tester_saves_predictions_and_soft_predictions(tmp_path):
    """``save_predict`` writes each volume's argmax as NRRD and
    ``save_soft_prediction`` its softmax, as the JAX package's tester."""
    data = _Volumes(True)

    def port_fn(x):
        return F.one_hot(x[..., 0].round().long(), 4).float() * 3.0

    def jax_fn(x):
        return jax.nn.one_hot(jnp.round(x[..., 0]).astype(jnp.int32), 4) * 3.0

    for name, tester in (
            ("port", T.TestSegmentationNetwork(data, port_fn, save_path=str(tmp_path / "port"),
                                               save_predict=True, save_soft_prediction=True,
                                               device="cpu")),
            ("jax", JT.TestSegmentationNetwork(data, jax_fn, save_path=str(tmp_path / "jax"),
                                               save_predict=True, save_soft_prediction=True))):
        os.makedirs(tmp_path / name)
        tester.run()
    for i in range(data.get_patient_num()):
        pid = data.get_id(i)
        g = read_nrrd(str(tmp_path / "port" / "pred" / f"{pid}_pred.nrrd"))
        w = read_nrrd(str(tmp_path / "jax" / "pred" / f"{pid}_pred.nrrd"))
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[0], data.vols[i][0])
        assert g[1] == w[1]
        soft_g = np.load(tmp_path / "port" / "soft" / f"{pid}_soft.npy")
        soft_w = np.load(tmp_path / "jax" / "soft" / f"{pid}_soft.npy")
        np.testing.assert_allclose(soft_g, soft_w, rtol=0, atol=1e-6)


# --------------------------------------------------------- JAX checkpoints
def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("module", MODULE_NAMES)
def test_read_flax_msgpack_matches_flax(module):
    """Leaf for leaf against ``flax.serialization.msgpack_restore`` on the
    seed-40 checkpoint's files (the image encoder's holds 94 leaves)."""
    path = os.path.join(SEED40, f"{module}.msgpack")
    got = convert.read_flax_msgpack(path)
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    g, w = list(_leaves(got)), list(_leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    if module == "image_encoder":
        assert len(g) == 94
    for (p, a), (_, b) in zip(g, w):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, p
        assert a.tobytes() == b.tobytes(), p


def test_read_flax_msgpack_decodes_every_type(tmp_path):
    """Maps, arrays, str, bin, ints of every width, floats, nil, bool and
    flax's ndarray extension, against the msgpack package (and flax for the
    arrays)."""
    tree = {"ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 + 5, -1, -32,
                     -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63],
            "floats": [0.5, -1e300, float("inf")], "nil": None, "bools": [True, False],
            "str": ["", "a", "x" * 31, "y" * 32, "z" * 300, "w" * 70000, "héllo"],
            "bin": [b"", b"\x00\xff" * 200, b"q" * 70000],
            "big_map": {f"k{i}": i for i in range(20)}, "big_array": list(range(20)),
            "arrays": {"f32": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "i64": np.arange(-3, 3, dtype=np.int64),
                       "f16": np.zeros((0, 2), np.float16)}}
    path = tmp_path / "t.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got = convert.read_flax_msgpack(str(path))
    want = serialization.msgpack_restore(path.read_bytes())
    for (p, a), (q, b) in zip(_leaves(got), _leaves(want)):
        assert p == q
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
        else:
            assert a == b and type(a) is type(b), p
    plain = {"f32": 1.5, "neg": -7, "arr": [1, [2, None]]}
    path.write_bytes(msgpack.packb(plain, use_single_float=True))
    assert convert.read_flax_msgpack(str(path)) == msgpack.unpackb(path.read_bytes())
    path.write_bytes(msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="after the tree"):
        convert.read_flax_msgpack(str(path))
    path.write_bytes(msgpack.packb(msgpack.ExtType(2, b"xy")))
    with pytest.raises(ValueError, match="ext type 2"):
        convert.read_flax_msgpack(str(path))


def test_load_jax_checkpoint_matches_flax_restore():
    """``load_jax_checkpoint`` equals ``from_jax`` of the trees flax
    restores, and loads strictly into a predictor."""
    params, stats = {}, {}
    for name in MODULE_NAMES:
        with open(os.path.join(SEED40, f"{name}.msgpack"), "rb") as f:
            tree = serialization.msgpack_restore(f.read())
        params[name], stats[name] = tree["params"], tree["batch_stats"]
    want = convert.from_jax(params, stats)
    got = convert.load_jax_checkpoint(SEED40)
    assert list(got) == list(want)
    for m in want:
        assert list(got[m]) == list(want[m])
        for k in want[m]:
            assert torch.equal(got[m][k], want[m][k]), (m, k)
    CooperativePredictor(device="cpu").load_state_dicts(got)


def test_to_flax_inverts_from_jax():
    """``torch_port_flax.to_flax`` (the card tests' JAX-layout state, made
    without JAX) gives the JAX solver's own tree (every path and shape of
    its initialised params and batch_stats), and ``from_jax`` maps it back
    to the same state dicts, bit for bit."""
    state = CooperativeTripletSolver(input_hw=(32, 32)).init_state(jax.random.PRNGKey(0))
    sd = checkpoint.module_state_dicts(CooperativePredictor(device="cpu", seed=3))
    params, stats = to_flax(sd)

    def shapes(tree, path=()):
        if hasattr(tree, "items"):
            return [x for k, v in tree.items() for x in shapes(v, path + (k,))]
        return [(path, tuple(np.shape(tree)))]

    assert sorted(shapes(params)) == sorted(shapes(state.params))
    assert sorted(shapes(stats)) == sorted(shapes(state.batch_stats))
    back = convert.from_jax(params, stats)
    for m in sd:
        assert sorted(back[m]) == sorted(sd[m])
        for k in sd[m]:
            assert torch.equal(back[m][k], sd[m][k]), (m, k)


# -------------------------------------------- the seed-40 checkpoint, end to end
def _jax_predict_fn():
    """The JAX package's float32 ``predict(n_iter=2)`` on the seed-40
    checkpoint, as its ``cli/test.py`` builds it."""
    solver = CooperativeTripletSolver(network_type="FCN_16_standard", num_classes=4, n_iter=2)
    params, stats = {}, {}
    for name in MODULE_NAMES:
        with open(os.path.join(SEED40, f"{name}.msgpack"), "rb") as f:
            tree = serialization.msgpack_restore(f.read())
        params[name], stats[name] = tree["params"], tree["batch_stats"]
    predict = solver.make_predict(n_iter=2)
    return lambda images: predict(params, stats, images)


def _dice_rows(path):
    """{pid: [LV, MYO, RV] Dice} of a detail.csv."""
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "patient_id,LV_Dice,MYO_Dice,RV_Dice", lines[0]
    return {ln.split(",")[0]: [float(v) for v in ln.split(",")[1:]] for ln in lines[1:]}


@pytest.fixture(scope="module")
def seed40(tmp_path_factory):
    """The synthetic tree (pids 007, 008) by the port's writer; the JAX
    package's CPU evaluation of the seed-40 checkpoint on it and on the
    ``--synthetic`` phantoms (one compiled predict serves both); the
    port's, through its test entry's functions."""
    root = tmp_path_factory.mktemp("seed40")
    tree, port_dir, jax_dir = str(root / "tree"), str(root / "port"), str(root / "jax")
    W.main(["--out_root", tree, "--pids", *PIDS])
    per_frame = []
    for f in ("ED", "ES"):
        img_fmt, label_fmt = JA.probe_format_names(tree, f)
        per_frame.append(JA.CardiacACDCDataset(
            root_dir=tree, frame=f, split="test", data_setting="10", cval=0,
            image_format_name=img_fmt, label_format_name=label_fmt))
    jax_results = JT.evaluate_cross_domain(
        _jax_predict_fn(), {"ACDC": JConcat(per_frame), "synthetic": JSynthetic(length=10)},
        save_dir=jax_dir)
    argv = ["--checkpoint", SEED40, "--acdc_root", tree, "--device", "cpu", "--n_iter", "2",
            "--save_dir", port_dir]
    port_results = cli.main(argv)
    synthetic = cli.main(["--checkpoint", SEED40, "--synthetic", "--device", "cpu",
                          "--save_dir", port_dir])
    return dict(tree=tree, port_dir=port_dir, jax_dir=jax_dir, jax=jax_results,
                port=port_results, synthetic=synthetic, argv=argv)


def test_seed40_dice_matches_jax_cpu_evaluation(seed40):
    """Each class-volume Dice within JAX_CPU_ATOL of the JAX package's CPU
    evaluation of the same checkpoint on the same tree."""
    got = _dice_rows(os.path.join(seed40["port_dir"], "ACDC", "detail.csv"))
    want = _dice_rows(os.path.join(seed40["jax_dir"], "ACDC", "detail.csv"))
    assert list(got) == list(want) == [f"{p}_{f}" for f in ("ED", "ES") for p in PIDS]
    gap = max(abs(a - b) for pid in want for a, b in zip(got[pid], want[pid]))
    print(f"largest class-volume Dice gap to the JAX CPU evaluation: {gap:.6f}")
    assert gap <= JAX_CPU_ATOL
    for name in ("ACDC",):
        for k, v in seed40["jax"][name].items():
            assert abs(seed40["port"][name][k] - v) <= JAX_CPU_ATOL, k


def test_seed40_dice_matches_the_saved_tpu_evaluation(seed40):
    """Each class-volume Dice within TPU_ATOL of the TPU run's detail.csv,
    the mean of the 12 within TPU_MEAN_ATOL."""
    got = _dice_rows(os.path.join(seed40["port_dir"], "ACDC", "detail.csv"))
    tpu = _dice_rows(SEED40_TPU_CSV)
    gaps = [a - b for pid in got for a, b in zip(got[pid], tpu[pid])]
    mean_gap = np.mean([v for pid in got for v in got[pid]]) - np.mean(
        [v for pid in got for v in tpu[pid]])
    print(f"against the TPU detail.csv: largest gap {max(map(abs, gaps)):.6f}, "
          f"mean gap {mean_gap:.6f}")
    assert max(map(abs, gaps)) <= TPU_ATOL
    assert abs(mean_gap) <= TPU_MEAN_ATOL


def test_seed40_synthetic_cli_run_matches_jax(seed40):
    """``cli.test --synthetic``: the three phantom volumes' mean Dice per
    class within JAX_CPU_ATOL of the JAX package's, and its CSVs written."""
    got, want = seed40["synthetic"]["synthetic"], seed40["jax"]["synthetic"]
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= JAX_CPU_ATOL, (k, got[k], want[k])
    rows = _dice_rows(os.path.join(seed40["port_dir"], "synthetic", "detail.csv"))
    assert list(rows) == ["synthetic_000", "synthetic_001", "synthetic_002"]


def test_cli_reads_pth_checkpoints_and_refuses_bad_arguments(seed40, tmp_path, capsys):
    """``--checkpoint`` of the port's ``.pth`` files (written by
    ``train.checkpoint.save_model``) loads the same weights as the
    ``.msgpack`` directory and evaluates to the same rows; a directory of
    neither raises, as does ``--device cuda`` without a card, and no
    dataset is an error."""
    args = cli.parse_args(seed40["argv"])
    from_msgpack = cli.load_predictor(args)
    pth_dir = checkpoint.save_model(types.SimpleNamespace(model=from_msgpack), str(tmp_path), "best")
    args_pth = cli.parse_args(seed40["argv"][:1] + [pth_dir] + seed40["argv"][2:-1]
                              + [str(tmp_path / "eval")])
    from_pth = cli.load_predictor(args_pth)
    for a, b in zip(from_msgpack.state_dict().values(), from_pth.state_dict().values()):
        assert torch.equal(a, b)
    cli.run(args_pth, from_pth)
    got = (tmp_path / "eval" / "ACDC" / "detail.csv").read_bytes()
    assert got == open(os.path.join(seed40["port_dir"], "ACDC", "detail.csv"), "rb").read()
    with pytest.raises(FileNotFoundError):
        cli.load_predictor(cli.parse_args(["--checkpoint", str(tmp_path), "--device", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.load_predictor(cli.parse_args(["--checkpoint", SEED40]))
    with pytest.raises(SystemExit):
        cli.run(cli.parse_args(["--device", "cpu"]), from_pth)
    capsys.readouterr()
    cli.print_summary({"ACDC": {"LV_Dice_mean": 0.5, "LV_Dice_std": 0.1}})
    assert capsys.readouterr().out == "dataset,LV_Dice_mean\nACDC,0.5\n"
