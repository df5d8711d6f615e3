"""The port's data-parallel step (``parallel/mesh.py``) on two gloo ranks
on the CPU against the JAX package's sharded step and the port's own
one-process step, the sharded validation and batches, and the mesh's
rules.

Two ranks start through ``parallel.mesh.launch`` (a ``file://`` store
under ``tmp_path``; the rank functions are ``tests/torch_port_ddp_ranks.py``)
while the JAX package's ``shard_train_step`` runs over ``make_mesh(2)`` of
the 8 virtual CPU devices (``tests/conftest.py``).  32x32, batch 4, f32,
the same weights (``torch_port_util.random_variables``) and the same draws
(JAX's keys replayed, one key for each latent-DA branch drawn on both
codes under ``mask_type="random"``, so one compile covers the three).
The tolerances are ``tests/torch_port_ddp_util.py``'s (its docstring).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_ddp_ranks as R
from torch_port_ddp_util import (
    BATCH,
    BRANCHES,
    HW,
    W,
    branch_keys,
    check_against_jax,
    check_against_one,
    check_ranks_equal,
    data,
    jax_sharded_steps,
    one_process,
)
from torch_port_util import (  # noqa: F401
    jax_train_state,
    make_solver,
    one_torch_thread,
    random_variables,
    replay_draws,
    step_configs,
)

from cooperative_training_and_latent_space_data_augmentation_tpu.parallel import mesh as jmesh
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
    EvalBatcher,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel import mesh as pmesh
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.driver import (
    check_mesh_modes,
    eval_dispatch,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)

EVAL = (11, 8, (HW, HW))          # 11 phantoms at batch 8: a tail of 3, padded to 8
TRAIN_BATCHES = (8, 8, (40, 40), (HW, HW), 5)  # 8 phantoms, batch 8 (4 raw + originals)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    solver = make_solver()
    params, stats = random_variables(solver, seed=0)
    image, label = data()
    jlda, lda = step_configs("random")
    keys = branch_keys(lda)
    draws = [replay_draws(jax.random.PRNGKey(k), lda, BATCH, (HW, HW)) for k in keys]
    sd = convert.from_jax(params, stats)
    store = str(tmp_path_factory.mktemp("mesh") / "store")
    # the ranks, the one-process steps and JAX's compile side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(pmesh.launch, R.all_case, W, "cpu", store, args=(
            (lda, sd, torch.from_numpy(image), torch.from_numpy(label), draws, {}),
            (sd, *EVAL), TRAIN_BATCHES))
        ones = pool.submit(lambda: [one_process(lda, sd, image, label, d) for d in draws])
        batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
        jax_out = jax_sharded_steps(solver, jax_train_state(solver, params, stats), batch, keys,
                                    latent_da=jlda)
        ranks, ones = ranks.result(), ones.result()
    return {"lda": lda, "sd": sd, "draws": draws, "jax": jax_out, "ones": ones,
            "steps": [[r[0][i] for r in ranks] for i in range(len(keys))],
            "eval": [r[1] for r in ranks], "batches": [r[2] for r in ranks]}


@pytest.mark.parametrize("branch", range(len(BRANCHES)), ids=BRANCHES)
def test_ddp_step_matches_jax_sharded_step(run, branch):
    metrics, state = run["jax"][branch]
    check_against_jax(run["steps"][branch], metrics, state, BRANCHES[branch])


@pytest.mark.parametrize("branch", range(len(BRANCHES)), ids=BRANCHES)
def test_ddp_step_matches_one_process(run, branch):
    one, moved = run["ones"][branch]
    check_against_one(run["steps"][branch], one, moved, run["sd"], run["lda"],
                      run["draws"][branch], BRANCHES[branch])


@pytest.mark.parametrize("branch", range(len(BRANCHES)), ids=BRANCHES)
def test_ddp_ranks_hold_equal_state(run, branch):
    check_ranks_equal(run["steps"][branch], BRANCHES[branch])


def test_sharded_eval_matches_unsharded(run):
    """11 samples at batch 8: the tail of 3 wrap-padded to 8; each rank
    counts its real rows, and the summed confusion matrix equals the
    one-process one integer for integer (JAX: tests/test_sharding.py:129-157)."""
    (tails0, local0, conf0), (tails1, local1, conf1) = run["eval"]
    assert tails0 == tails1 == [8, 3]
    assert local0 == [4, 3] and local1 == [4, 0]
    assert torch.equal(conf0, conf1)
    model = CooperativePredictor(device="cpu")
    model.load_state_dicts(run["sd"])
    length, batch, hw = EVAL
    plain = EvalBatcher(SyntheticSegDataset(length=length, pad_size=hw), batch, pad_hw=hw,
                        crop_hw=hw, device="cpu")
    want = eval_dispatch(model, plain, n_iter=2).confusion_matrix
    assert torch.equal(conf0, want)
    assert int(want.sum()) == length * hw[0] * hw[1]


def test_sharded_batcher_yields_each_ranks_rows(run):
    """Every rank's train batch is its rows of the global batch (JAX's
    order: the augmented half on rank 0, the originals on rank 1)."""
    want = R.train_batches(None, *TRAIN_BATCHES)
    assert len(want) == len(run["batches"][0]) == len(run["batches"][1]) == 2
    for rank, got in enumerate(run["batches"]):
        for g, w in zip(got, want):
            for k in w:
                b = w[k].shape[0] // W
                assert torch.equal(g[k], w[k][rank * b:(rank + 1) * b]), (rank, k)


def test_eval_batcher_indivisible_batch_rejected():
    mesh = pmesh.Mesh(size=W, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="divide"):
        EvalBatcher(SyntheticSegDataset(length=10, pad_size=(HW, HW)), batch_size=5,
                    pad_hw=(HW, HW), crop_hw=(HW, HW), device="cpu", mesh=mesh)


@pytest.mark.parametrize("n,multiple", [(3, 8), (10, 8), (1, 2), (4, 2)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    """Wrap-padding by tiling, shortfalls larger than n included
    (tests/test_sharding.py:123-126)."""
    batch = {"image": np.arange(n * 2, dtype=np.float32).reshape(n, 2),
             "label": np.arange(n, dtype=np.int32)}
    got, real = pmesh.pad_batch_to_multiple(batch, multiple)
    want, want_real = jmesh.pad_batch_to_multiple(batch, multiple)
    assert real == want_real == n
    assert got["image"].shape[0] % multiple == 0
    for k in batch:
        np.testing.assert_array_equal(got[k], want[k])


def test_backend_rule():
    assert pmesh.backend_for(2, "cpu") == "gloo"
    # this machine has no card: two ranks on "cuda" would share none
    assert pmesh.backend_for(2, "cuda") == ("nccl" if torch.cuda.device_count() >= 2
                                            else "gloo")
    assert pmesh.rank_device(1, "gloo", "cpu") == torch.device("cpu")
    assert pmesh.rank_device(1, "gloo", "cuda") == torch.device("cuda", 0)
    assert pmesh.rank_device(1, "nccl", "cuda") == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(2)


def test_fused_epoch_over_ranks_is_refused(monkeypatch):
    """Where its CUDA graphs cannot capture the ranks' collectives: gloo
    ranks sharing one card.  NCCL ranks (a card each) and CPU ranks (whose
    fused bodies run uncaptured) run it (test_torch_port_ddp_epoch.py)."""
    with pytest.raises(ValueError, match="cannot be captured"):
        check_mesh_modes(2, True, 0, "gloo")
    check_mesh_modes(1, True)
    check_mesh_modes(2, False, 0, "gloo")
    check_mesh_modes(2, True, 0, "nccl")
    check_mesh_modes(2, True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # two ranks share one card
    args = cli.parse_args(["--synthetic", "--n_devices", "2", "--fused_epoch"])
    cfg, name = cli.load_config(args)
    with pytest.raises(ValueError, match="cannot be captured"):
        cli.run(args, cfg, name)


def test_n_devices_without_a_card_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli.parse_args(["--synthetic", "--n_devices", "2"])
    cfg, name = cli.load_config(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(args, cfg, name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.launch(R.step_cases, 2, "cuda")
