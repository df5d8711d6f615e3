"""The robustness protocol against the JAX package's on the CPU: the ACDC-C
corruptions, their generator, the methods x cvals aggregation, the test
entry's ``--checkpoint_template`` path and ``cli.train``'s ACDC datasets.

The draws are JAX's, replayed from its keys into the port's
:class:`CorruptionDraws` (:func:`replay_corruption_draws`).  Inputs are
made from seeds with numpy; the trees are the port's synthetic writer's
(3 slices of 224x224 a volume).  Tolerances:

- the corruptions, against ``ops/corruptions.py`` under ``jax.jit`` (as
  the JAX generator runs them), at 64x64, 192x192 and, for ghosting and
  motion, 64x48: spike positions and ghost lines exactly equal; images
  within ``ATOL`` = 1e-5 (bias, spike, ghosting; measured at most 5.5e-7
  on uniform noise) and ``MOTION_ATOL`` = 5e-5 (motion: the copies are
  sampled at coordinates from float32 ``cos``/``sin``, whose last bit
  differs between XLA and PyTorch, and uniform noise has the steepest
  gradients; measured at most 1.44e-5 at 192x192); each test prints its
  largest difference;
- the generator, fed JAX's replayed draws, against the JAX package's
  ``cli/generate_acdc_c.py``: the same files, the same labels (links to
  the same source, or equal copies) and spacing, the images within the
  tolerances above;
- ``aggregated.csv``: byte for byte;
- the template path on the two saved TPU checkpoints
  (``saved/train_ACDC_10_n_cls_4/{method}/0/model/best/checkpoints``)
  over pid 007's ED volume of the synthetic tree and its JAX-generated
  ACDC-C: each class-volume Dice within ``JAX_CPU_ATOL`` = 2e-3 of the
  JAX package's ``evaluate_methods_across_cvals`` on the same files (the
  bound of ``tests/test_torch_port_eval.py``);
- ``cli.train``'s ACDC datasets: the same slices in the same order, equal.
"""

import importlib.util
import os
import shutil
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from torch_port_util import one_torch_thread  # noqa: F401 - a fixture

from cooperative_training_and_latent_space_data_augmentation_tpu.config import (
    ExperimentConfig as JConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.eval import tester as JT
from cooperative_training_and_latent_space_data_augmentation_tpu.ops import corruptions as JC
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    generate_acdc_c as G,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    make_synthetic_acdc as W,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import test as cli_test
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
    train as cli_train,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
    read_nrrd,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.splits import (
    get_ACDC_split_policy,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval import tester as T
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.metrics import (
    write_csv,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import corruptions as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_TEMPLATE = os.path.join(REPO, "saved", "train_ACDC_10_n_cls_4", "{method}", "{cval}",
                            "model", "best", "checkpoints")
METHODS = ("standard_training", "cooperative_training")
ATOL = 1e-5
MOTION_ATOL = 5e-5
JAX_CPU_ATOL = 2e-3
PIDS = ("007", "008")
N_SLICES = 3


def _load(rel_path, name):
    """A script of the JAX package's ``cli/`` loaded by path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, rel_path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _atol(name):
    return MOTION_ATOL if name == "RandomMotion" else ATOL


# ------------------------------------------------------------- draws
def replay_corruption_draws(key, name: str, num_spikes: int = 1, num_ghosts_range=(4, 10),
                            num_transforms: int = 2) -> C.CorruptionDraws:
    """The draws the JAX package's corruption ``name`` makes from ``key``,
    as the port's :class:`CorruptionDraws`: uniforms replayed raw (the
    functions scale them as ``jax.random.uniform`` does)."""
    def u(k, shape=()):
        return torch.from_numpy(np.array(jax.random.uniform(k, shape), np.float32))

    if name == "RandomBias":
        return C.CorruptionDraws(name, coeffs=u(key, (C.n_coefficients(3),)))
    if name == "RandomSpike":
        k_pos, k_int = jax.random.split(key)
        sign = jax.random.rademacher(jax.random.fold_in(k_pos, 1), (num_spikes, 2))
        return C.CorruptionDraws(name, spike_pos=u(k_pos, (num_spikes, 2)),
                                 spike_sign=torch.from_numpy(np.array(sign, np.float32)),
                                 spike_intensity=u(k_int, (num_spikes,)))
    if name == "RandomGhosting":
        k_n, k_i, k_a = jax.random.split(key, 3)
        lo, hi = num_ghosts_range
        return C.CorruptionDraws(name, num_ghosts=int(jax.random.randint(k_n, (), lo, hi + 1)),
                                 ghost_axis=int(jax.random.randint(k_a, (), 0, 2)),
                                 ghost_intensity=u(k_i))
    keys = jax.random.split(key, num_transforms)
    per = [jax.random.split(k, 3) for k in keys]
    return C.CorruptionDraws(
        name, theta=torch.stack([u(k[0]) for k in per]), dy=torch.stack([u(k[1]) for k in per]),
        dx=torch.stack([u(k[2]) for k in per]),
        bounds=u(jax.random.fold_in(key, 7), (num_transforms,)))


def _jax_spike_positions(key, h, w):
    """``ops/corruptions.py:random_spike``'s positions (:70-74), by its own
    jnp expressions."""
    k_pos, _ = jax.random.split(key)
    pos = jax.random.uniform(k_pos, (1, 2), minval=0.05, maxval=0.45)
    sign = jax.random.rademacher(jax.random.fold_in(k_pos, 1), (1, 2))
    ys = (h // 2 + (sign[:, 0] * pos[:, 0] * h)).astype(jnp.int32) % h
    xs = (w // 2 + (sign[:, 1] * pos[:, 1] * w)).astype(jnp.int32) % w
    return np.asarray(ys), np.asarray(xs)


def _jax_ghost_lines(key, n, restore=0.02):
    """``ops/corruptions.py:random_ghosting``'s attenuated lines (:87-104),
    by its own jnp expressions."""
    k_n, _, _ = jax.random.split(key, 3)
    num_ghosts = jax.random.randint(k_n, (), 4, 11)
    idx = jnp.arange(n)
    is_ghost_line = (idx % jnp.maximum(num_ghosts, 1)) == 0
    keep = jnp.abs(idx - n // 2) < jnp.maximum(1, (restore * n)).astype(jnp.int32)
    return np.asarray(is_ghost_line & ~keep)


# -------------------------------------------------------- corruptions
CASES = [(name, hw) for name in C.NAMES for hw in ((64, 64), (192, 192))] + [
    (name, (64, 48)) for name in ("RandomGhosting", "RandomMotion")]


@pytest.mark.parametrize("name,hw", CASES)
def test_corruption_matches_jax(name, hw):
    """One slice, two keys: within the corruption's tolerance of JAX's
    jitted function on replayed draws; spike positions and ghost lines
    equal."""
    fn = jax.jit(JC.CORRUPTIONS[name])
    rng = np.random.RandomState(hw[0] + hw[1])
    img = rng.rand(*hw).astype(np.float32)
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        draws = replay_corruption_draws(key, name)
        want = np.asarray(fn(key, jnp.asarray(img)))
        got = C.CORRUPTIONS[name](draws, torch.from_numpy(img)[None])[0].numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        err = float(np.abs(got - want).max())
        print(f"{name} {hw} key {seed}: largest difference to JAX {err:.3e}")
        assert err <= _atol(name), (name, hw, seed, err)
        if name == "RandomSpike":
            ys, xs = C.spike_positions(draws, *hw)
            assert (ys.tolist(), xs.tolist()) == tuple(a.tolist()
                                                      for a in _jax_spike_positions(key, *hw))
        if name == "RandomGhosting":
            n = hw[0] if draws.ghost_axis == 0 else hw[1]
            assert np.array_equal(C.ghost_lines(draws, n), _jax_ghost_lines(key, n))


@pytest.mark.parametrize("name", C.NAMES)
def test_corrupt_volume_matches_jax(name):
    """A 3-slice stack, one draw shared by the slices, against
    ``corrupt_volume_jit``; each slice rescaled on its own."""
    vol = np.random.RandomState(7).rand(3, 64, 64).astype(np.float32)
    vol[1] *= 0.5
    key = jax.random.PRNGKey(3)
    want = np.asarray(JC.corrupt_volume_jit(key, jnp.asarray(vol), name))
    got = C.corrupt_volume(replay_corruption_draws(key, name), torch.from_numpy(vol)).numpy()
    err = float(np.abs(got - want).max())
    print(f"{name} 3x64x64: largest difference to JAX {err:.3e}")
    assert err <= _atol(name)
    assert np.allclose(got.min(axis=(1, 2)), 0.0, atol=1e-6)
    assert np.allclose(got.max(axis=(1, 2)), 1.0, atol=1e-6)


def test_draws_are_per_corruption_and_reproducible():
    """``draw_corruption`` draws only its corruption's fields, the same
    ones from the same seed; an unknown name is refused."""
    fields = {"RandomBias": {"coeffs"},
              "RandomSpike": {"spike_pos", "spike_sign", "spike_intensity"},
              "RandomGhosting": {"num_ghosts", "ghost_axis", "ghost_intensity"},
              "RandomMotion": {"theta", "dy", "dx", "bounds"}}
    for name in C.NAMES:
        a, b = (vars(C.draw_corruption(torch.Generator().manual_seed(5), name))
                for _ in range(2))
        assert {k for k, v in a.items() if v is not None} == fields[name] | {"name"}
        for k, v in a.items():
            assert torch.equal(v, b[k]) if torch.is_tensor(v) else v == b[k]
    ghost = C.draw_corruption(torch.Generator().manual_seed(0), "RandomGhosting", axis=1)
    assert ghost.ghost_axis == 1 and 4 <= ghost.num_ghosts <= 10
    assert C.draw_corruption(torch.Generator(), "RandomBias").coeffs.shape == (10,)
    with pytest.raises(KeyError):
        C.draw_corruption(torch.Generator(), "RandomBlur")


# ---------------------------------------------------------- generator
@pytest.fixture(scope="module")
def acdc_c(tmp_path_factory):
    """The synthetic tree (pids 007, 008, 3 slices) and ACDC-C for it, seed
    0, all four attacks: by the JAX package's generator, and by the port's
    fed JAX's replayed draws (labels linked), and by the port's with
    ``--copy_labels``."""
    root = tmp_path_factory.mktemp("acdc_c")
    tree = str(root / "tree")
    W.main(["--out_root", tree, "--pids", *PIDS, "--n_slices", str(N_SLICES)])
    out = {"tree": tree, "jax": str(root / "jax"), "port": str(root / "port"),
           "copied": str(root / "copied")}
    jax_gen = _load(os.path.join("cli", "generate_acdc_c.py"), "jax_generate_acdc_c")
    argv = sys.argv
    try:
        sys.argv = ["generate_acdc_c.py", "--acdc_root", tree, "--out_root", out["jax"],
                    "--seeds", "0"]
        jax_gen.main()
    finally:
        sys.argv = argv

    def jax_draws(attack, pid, frame, seed, n, h, w):
        tag = f"{attack}/{pid}/{frame}/{seed}".encode()
        return replay_corruption_draws(jax.random.PRNGKey(zlib.crc32(tag) & 0x7FFFFFFF), attack)

    base = ["--acdc_root", tree, "--seeds", "0", "--device", "cpu"]
    out["written"] = G.generate(G.parse_args(base + ["--out_root", out["port"]]), jax_draws)
    G.generate(G.parse_args(base + ["--out_root", out["copied"], "--copy_labels",
                                    "--attacks", "RandomSpike"]), jax_draws)
    return out


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_generator_matches_jax(acdc_c):
    """Every file JAX's generator writes, the port's writes: the images
    within the corruption's tolerance, with the source spacing; the labels
    linked to the same source file."""
    names = _files(acdc_c["jax"])
    assert names == _files(acdc_c["port"])
    assert len(names) == 2 * len(PIDS) * 2 * len(C.NAMES)
    assert len(acdc_c["written"]) == len(PIDS) * 2 * len(C.NAMES)
    for rel in names:
        want_path, got_path = (os.path.join(acdc_c[k], rel) for k in ("jax", "port"))
        if "_label" in rel:
            assert os.path.islink(got_path)
            assert os.readlink(got_path) == os.readlink(want_path)
            continue
        (want, want_sp), (got, got_sp) = read_nrrd(want_path), read_nrrd(got_path)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        assert got_sp == want_sp
        attack = rel.split(os.sep)[0]
        err = float(np.abs(got - want).max())
        print(f"{rel}: largest difference to JAX's file {err:.3e}")
        assert err <= _atol(attack), rel


def test_generator_copies_labels_and_refuses(acdc_c, tmp_path):
    """``--copy_labels`` copies the source label; no test patient is a
    SystemExit, and ``--device cuda`` without a card raises."""
    for rel in _files(acdc_c["copied"]):
        got = os.path.join(acdc_c["copied"], rel)
        if "_label" in rel:
            assert not os.path.islink(got)
            with open(got, "rb") as f, open(os.readlink(os.path.join(acdc_c["port"], rel)),
                                            "rb") as g:
                assert f.read() == g.read()
    with pytest.raises(SystemExit):
        G.main(["--acdc_root", str(tmp_path), "--out_root", str(tmp_path / "o"),
                "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            G.main(["--acdc_root", acdc_c["tree"], "--out_root", str(tmp_path / "o")])


def test_crop_recover_and_minmax_match_jax():
    """The generator's numpy helpers against JAX's copies, crop and pad."""
    jax_gen = _load(os.path.join("cli", "generate_acdc_c.py"), "jax_generate_acdc_c")
    rng = np.random.RandomState(2)
    for shape in ((3, 220, 200), (2, 100, 150), (1, 192, 192)):
        vol = rng.rand(*shape).astype(np.float32) * 300
        got, want = G.crop_with_offsets(vol, 192), jax_gen.crop_with_offsets(vol, 192)
        assert got[1:] == want[1:] and np.array_equal(got[0], want[0])
        assert np.array_equal(G.recover(got[0], *got[1:]), jax_gen.recover(want[0], *want[1:]))
        assert np.array_equal(G.per_slice_minmax(got[0]), jax_gen.per_slice_minmax(want[0]))


# --------------------------------------------------------- aggregation
@pytest.mark.parametrize("n_cvals", [1, 3])
def test_aggregated_csv_matches_jax_byte_for_byte(tmp_path, n_cvals):
    """Per-run dicts (with ``*_std`` keys, which are not aggregated) to
    ``aggregated.csv``: the port's bytes are pandas'; std empty at 1 cval."""
    rng = np.random.RandomState(n_cvals)
    per_run = {}
    for method in METHODS:
        for cval in range(n_cvals):
            for ds in ("RandomSpike", "ACDC", "RandomBias"):
                per_run[(method, cval, ds)] = {
                    **{f"{c}_Dice_mean": float(rng.rand()) for c in ("RV", "LV", "MYO")},
                    "LV_Dice_std": 0.1}
    JT.aggregate_across_cvals(per_run).to_csv(tmp_path / "jax.csv", index=False)
    write_csv(str(tmp_path / "port.csv"), T.AGG_COLUMNS, T.aggregate_across_cvals(per_run))
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert len(got.splitlines()) == 1 + 3 * 2 * 3
    assert T.aggregate_across_cvals({}) is None


# --------------------------------------------------------- template path
def _jax_predict_fn(ckpt):
    """The JAX package's float32 ``predict(n_iter=2)`` on a msgpack
    checkpoint, as its ``cli/test.py`` builds it."""
    solver = CooperativeTripletSolver(network_type="FCN_16_standard", num_classes=4, n_iter=2)
    params, stats = {}, {}
    for name in MODULE_NAMES:
        with open(os.path.join(ckpt, f"{name}.msgpack"), "rb") as f:
            tree = serialization.msgpack_restore(f.read())
        params[name], stats[name] = tree["params"], tree["batch_stats"]
    predict = solver.make_predict(n_iter=2)
    return lambda images: predict(params, stats, images)


def _detail(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return {ln.split(",")[0]: [float(v) for v in ln.split(",")[1:]] for ln in lines[1:]}


def test_template_path_matches_jax_evaluation(acdc_c, tmp_path, capsys):
    """``cli.test --checkpoint_template`` over the two saved TPU
    checkpoints (and one missing method, reported and skipped) on pid 007's
    ED volume and its JAX-generated ACDC-C, against JAX's
    ``evaluate_methods_across_cvals`` on the same files: every
    class-volume Dice and every aggregated mean within JAX_CPU_ATOL, the
    same rows, n_cvals 1 and std empty; the table printed as CSV is
    ``aggregated.csv``."""
    tree, corrupt = str(tmp_path / "tree"), str(tmp_path / "acdc_c")
    shutil.copytree(os.path.join(acdc_c["tree"], "007"), os.path.join(tree, "007"))
    for attack in C.NAMES:
        shutil.copytree(os.path.join(acdc_c["jax"], attack, "007_0"),
                        os.path.join(corrupt, attack, "007_0"), symlinks=True)
    data = ["--acdc_root", tree, "--acdc_c_root", corrupt, "--frames", "ED", "--cvals", "0"]
    args = cli_test.parse_args(["--checkpoint_template", TPU_TEMPLATE] + data)
    jax_test = _load(os.path.join("cli", "test.py"), "jax_cli_test")
    _, want_agg = JT.evaluate_methods_across_cvals(
        lambda method, cval: _jax_predict_fn(TPU_TEMPLATE.format(method=method, cval=cval)),
        lambda cval: jax_test.build_datasets(args, cval), methods=METHODS, cvals=[0],
        save_dir=str(tmp_path / "jax"))
    capsys.readouterr()
    per_run, rows = cli_test.main(
        ["--checkpoint_template", TPU_TEMPLATE, "--methods", *METHODS, "no_such_method",
         "--device", "cpu", "--save_dir", str(tmp_path / "port")] + data)
    out = capsys.readouterr().out
    assert "no_such_method:" in out and "not found" in out
    datasets = ("ACDC",) + C.NAMES
    assert sorted(per_run) == sorted((m, 0, d) for m in METHODS for d in datasets)
    gaps = []
    for method in METHODS:
        for ds in datasets:
            sub = os.path.join(method, "cv0", ds, "detail.csv")
            got, want = (_detail(os.path.join(tmp_path, side, sub)) for side in ("port", "jax"))
            assert list(got) == list(want) == ["007_ED" if ds == "ACDC" else "007_0_ED"]
            gaps += [abs(a - b) for pid in want for a, b in zip(got[pid], want[pid])]
    print(f"largest class-volume Dice gap to JAX: {max(gaps):.6f}")
    assert max(gaps) <= JAX_CPU_ATOL
    want_rows = want_agg.to_dict("records")
    assert [r[:3] for r in rows] == [(w["dataset"], w["method"], w["metric"]) for w in want_rows]
    for r, w in zip(rows, want_rows):
        assert abs(r[3] - w["mean"]) <= JAX_CPU_ATOL and np.isnan(r[4]) and r[5] == 1
    table = (tmp_path / "port" / "aggregated.csv").read_text()
    assert out.endswith(table) and len(table.splitlines()) == 1 + len(METHODS) * 5 * 3
    with pytest.raises(SystemExit):
        cli_test.main(["--checkpoint_template", str(tmp_path / "{method}" / "{cval}"),
                       "--device", "cpu"] + data)
    with pytest.raises(NotImplementedError):
        cli_test.main(["--checkpoint_template", TPU_TEMPLATE, "--network_type", "UNet_16",
                       "--device", "cpu"] + data)


# ----------------------------------------------------- cli.train on ACDC
def test_train_datasets_match_jax(tmp_path):
    """``cli.train``'s ACDC datasets (the "10" policy of cval 0, both
    frames, names probed from an NRRD tree) against JAX's
    ``cli/train.py:build_datasets``: the same slices in the same order."""
    policy = get_ACDC_split_policy("10", 0)
    tree = str(tmp_path / "tree")
    W.main(["--out_root", tree, "--pids", *policy["train"], *policy["validate"],
            "--n_slices", "2"])
    argv = ["--json_config_path", os.path.join(REPO, "configs", "ACDC", "standard_training.json"),
            "--root_dir", tree, "--seed", "40", "--device", "cpu"]
    args = cli_train.parse_args(argv)
    cfg, name = cli_train.load_config(args)
    assert (cfg.data.root_dir, name) == (tree, "standard_training")
    got = cli_train.build_datasets(cfg, args)
    jax_train = _load(os.path.join("cli", "train.py"), "jax_cli_train")
    jcfg = JConfig.from_json(args.json_config_path)
    jcfg.data.root_dir = tree
    want = jax_train.build_datasets(jcfg, args)
    assert [len(d) for d in got] == [len(d) for d in want] == [
        2 * 2 * len(policy["train"]), 2 * 2 * len(policy["validate"])]
    for g, w in zip(got, want):
        assert [d.patient_ids for d in g.datasets] == [d.patient_ids for d in w.datasets]
        assert [d.frame for d in g.datasets] == ["ES", "ED"]
        for i in range(len(w)):
            a, b = g[i], w[i]
            assert np.array_equal(a["image"], b["image"]) and np.array_equal(a["label"],
                                                                            b["label"])
