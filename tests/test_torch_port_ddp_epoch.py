"""The port's sharded fused epoch on two gloo ranks on the CPU:
``train_network(mesh=, fused_epoch=True)``, and with its pipelined fetch,
the JAX package's ``fused_epoch_runner(mesh=)``.

On the CPU the fused paths run the bodies of their CUDA graphs uncaptured
(``train/graphs.py``), gloo's collectives included, so over the same ranks
they must give the streaming loop's numbers bit for bit: the losses, the
branches, the validation confusion matrices and scores, the best epoch,
the parameters, the BN running statistics and Adam's moments and step.
That is held on the configuration's latent DA (``mask_type="random"`` on
both codes, soft masks; Adam at 1e-3), so each rank's staged step draws
(its rows of the keep masks and soft values) are exercised.

Then the epoch's trajectory against the JAX package's sharded fused
epoch over a 2-device CPU mesh (``tests/test_sharding.py:215-272`` runs
it the same way, against JAX's own streaming loop): the same weights
(``torch_port_util.random_variables``), the same batch orders, JAX's
draws replayed from its key schedule (``torch_port_util.JaxKeys``, the
augmentation with ``TILED_WARP=0``, the gather the port mirrors), at
JAX's bands: every logged loss of every step within rtol 1e-3 and the
parameters after the last epoch within rtol and atol 1e-3 (the running
statistics, which JAX's test leaves out, are held to JAX's through the
streaming loop in test_torch_port_loop.py, and to that loop bit for bit
here).  As in JAX's test the step runs
without latent DA (``make_train_step(latent_da=None)``) and at JAX's
learning rate 1e-4: with latent DA a percentile mask may swap an element
whose saliency lies within rounding of its threshold, which the step
files hold apart (``torch_port_util.check_step_masks``), and at rate 1e-4
an Adam update moves no parameter by more than about 1e-4 a step,
whatever the two frameworks' gradients, so two steps stay inside the
band (measured: the first step's losses within 6e-7 of JAX's, the
second's within 5.7e-4, the parameters within 4e-4).  The JAX runner's
scanned compile takes about 50 s with a cold cache, beside the ranks'
45 s, and the file stays under 90 s alone (62-74 s measured), so it holds
the JAX package's fused epoch itself, not its sharded steps.

Small sizes: phantoms padded to 40x40 and cropped to 32x32, a global batch
of 4 (2 raw slices and their originals; each rank 2 rows, rank 0 the
augmented half), 2 training phantoms (one step an epoch), 5 validation
phantoms (two batches, the second wrap-padded: rank 1 holds no real row
of it), 2 epochs, a periodic checkpoint every epoch.
"""

import concurrent.futures

import jax
import numpy as np
import pytest
import torch
import torch_port_ddp_ranks as R
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture
    JaxKeys,
    jax_train_state,
    make_solver,
    one_torch_thread,
    random_variables,
)

from cooperative_training_and_latent_space_data_augmentation_tpu.data import loader as JL
from cooperative_training_and_latent_space_data_augmentation_tpu.data import synthetic as JS
from cooperative_training_and_latent_space_data_augmentation_tpu.parallel import mesh as jmesh
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
    CooperativeBatcher,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    SyntheticSegDataset,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.augment import (
    get_policy,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel import mesh as pmesh
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.driver import (
    LOSS_KEYS,
    check_mesh_modes,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.profiling import (
    NCCL_GROUP,
    _group,
)

PAD, CROP = (40, 40), (32, 32)
BATCH, W = 4, 2
N_TRAIN, N_VAL = 2, 5
EPOCHS = 2
SEED = 40
POLICY = "ACDC_affine_elastic_intensity"
JAX_RTOL = JAX_ATOL = 1e-3  # tests/test_sharding.py:263-272
BASE = {"data": {"pad_size": [*PAD, 1], "crop_size": [*CROP, 1]},
        "output": {"save_epoch_every_num_epochs": 1}, "n_train": N_TRAIN, "n_val": N_VAL}
# the configuration's latent DA, Adam at 1e-3; and JAX's test's step: no latent DA, 1e-4
LATENT = {**BASE, "name": "latent", "learning": {"batch_size": BATCH, "lr": 1e-3}}
PLAIN = {**BASE, "name": "plain",
         "learning": {"batch_size": BATCH, "lr": 1e-4, "latent_DA": False}}
MODES = {"streaming": {}, "fused": {"fused_epoch": True},
         "pipelined": {"fused_epoch": True, "pipeline_epoch": True}}


def _runs(modes):
    return [(tag, {"max_epochs": EPOCHS, **MODES[tag]}) for tag in modes]


def _jax_draws():
    """JAX's draws of the runs' steps in the loop's call order, replayed
    on the host: (augmentation draws, step draws)."""
    keys, policy = JaxKeys(SEED), get_policy(POLICY)
    for epoch in range(EPOCHS):
        for _ in range(N_TRAIN // (BATCH // 2)):
            keys.augment(epoch, policy, BATCH // 2, PAD)
            keys.step(BATCH, CROP, None)
    return keys.drawn, keys.steps


def _jax_sharded_epochs(solver, params, stats):
    """JAX's ``fused_epoch_runner(mesh=)`` over a 2-device mesh for EPOCHS
    epochs from the same weights, on its ``train_network`` key schedule:
    (each epoch's stacked metrics, the last state in the port's layout)."""
    mesh = jmesh.make_mesh(W)
    batcher = JL.CooperativeBatcher(
        JS.SyntheticSegDataset(length=N_TRAIN, pad_size=PAD, seed=0), batch_size=BATCH,
        policy_name=POLICY, pad_hw=PAD, crop_hw=CROP, seed=SEED, device_cache=True,
        sharding=jmesh.batch_sharding(mesh))
    step = solver.make_train_step(latent_da=None, donate=False)
    runner = batcher.fused_epoch_runner(step.__wrapped__, donate=False, mesh=mesh)
    images, labels = batcher._device_dataset()
    state = jmesh.replicate(mesh, jax_train_state(solver, params, stats))
    rng = jax.random.PRNGKey(SEED + 1)
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TILED_WARP", "0")
        for _ in range(EPOCHS):
            rng, epoch_key = jax.random.split(rng)
            state, rng, stacked = runner(state, images, labels, batcher.epoch_index_matrix(),
                                         epoch_key, rng)
            metrics.append({k: np.asarray(v) for k, v in stacked.items()})
    state = jax.device_get(state)
    return metrics, convert.from_jax(state.params, state.batch_stats)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both configurations' runs on two gloo ranks (one start of the
    ranks) beside JAX's sharded fused epochs."""
    solver = make_solver()
    params, stats = random_variables(solver, seed=0)
    sd = convert.from_jax(params, stats)
    root = tmp_path_factory.mktemp("epochs")
    cases = [(LATENT, sd, str(root / "latent"), _runs(MODES)),
             (PLAIN, sd, str(root / "plain"), _runs(["fused", "pipelined"]), _jax_draws())]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pmesh.launch, R.epoch_cases, W, "cpu", str(root / "store"),
                            args=(cases,))
        jax_out = _jax_sharded_epochs(solver, params, stats)
        ranks = ranks.result()
    return {"ranks": ranks, "jax": jax_out, "sd": sd}


def _same_state(a, b, what):
    (ma, aa), (mb, ab) = a, b
    for name, sd in ma.items():
        for k, v in sd.items():
            assert torch.equal(v, mb[name][k]), (what, name, k)
    for x, y in zip(aa, ab):
        for k, v in x.items():
            assert torch.equal(v, y[k]), (what, k)


def _same_run(a, b, what):
    assert len(a["epochs"]) == len(b["epochs"]) == EPOCHS, what
    for ea, eb in zip(a["epochs"], b["epochs"]):
        epoch, losses, branches, confusion, iou, acc = ea
        assert epoch == eb[0] and branches == eb[2] and (iou, acc) == eb[4:], (what, epoch)
        np.testing.assert_array_equal(losses, eb[1], err_msg=f"{what} epoch {epoch}")
        np.testing.assert_array_equal(confusion, eb[3], err_msg=f"{what} epoch {epoch}")
    assert a["best"] == b["best"], what
    _same_state(a["state"], b["state"], what)


@pytest.mark.parametrize("mode", ["fused", "pipelined"])
def test_sharded_fused_epoch_equals_the_ranks_streaming_run(run, mode):
    """Each rank's fused (pipelined) run equals its streaming run bit for
    bit, and the two ranks hold the same state and log the same numbers;
    rank 0 alone writes."""
    latent = [r[0] for r in run["ranks"]]
    for rank, runs in enumerate(latent):
        _same_run(runs["streaming"], runs[mode], f"rank {rank} {mode}")
        assert runs[mode]["graphs"] == (EPOCHS * N_TRAIN // (BATCH // 2), 0)  # uncaptured
    _same_run(latent[0][mode], latent[1][mode], f"ranks {mode}")
    assert latent[0][mode]["written"] and not latent[1][mode]["written"]


def test_latent_runs_draw_every_code_and_move_the_weights(run):
    """The latent runs perturb both codes at each step, and the weights
    move (so the equality above is not of a frozen state)."""
    streaming = run["ranks"][0][0]["streaming"]
    assert all(set(b) == {"image", "shape"} for e in streaming["epochs"] for b in e[2])
    assert any(not torch.equal(v, run["sd"][n][k])
               for n, sd in streaming["state"][0].items() for k, v in sd.items()
               if "running_" not in k and v.is_floating_point())


@pytest.mark.parametrize("mode", ["fused", "pipelined"])
def test_sharded_fused_epoch_matches_jax_sharded_fused_epoch(run, mode):
    """JAX's draws, no latent DA, Adam at 1e-4: every logged loss of every
    step within rtol 1e-3 of JAX's sharded fused epoch's, and the
    parameters after the last epoch within rtol and atol 1e-3 (the module
    docstring)."""
    jax_metrics, jax_state = run["jax"]
    worst = {"loss": 0.0, "parameter": 0.0}
    for rank, runs in enumerate(run["ranks"]):
        got = runs[1][mode]
        for (epoch, losses, *_), want in zip(got["epochs"], jax_metrics):
            for j, key in enumerate(LOSS_KEYS):
                np.testing.assert_allclose(losses[:, j], want[key], rtol=JAX_RTOL,
                                           err_msg=f"rank {rank} {mode} epoch {epoch} {key}")
                gap = np.abs(losses[:, j] - want[key]) / np.maximum(np.abs(want[key]), 1e-30)
                worst["loss"] = max(worst["loss"], float(gap.max()))
        modules = got["state"][0]
        for name, sd in jax_state.items():
            for k, w in sd.items():
                if "running_" in k:
                    continue
                np.testing.assert_allclose(modules[name][k].numpy(), w.numpy(), rtol=JAX_RTOL,
                                           atol=JAX_ATOL, err_msg=f"{mode} {name}.{k}")
                gap = (modules[name][k] - w).abs().max()
                worst["parameter"] = max(worst["parameter"], float(gap))
    print(f"{mode}: largest relative loss gap {worst['loss']:.3g}, largest parameter gap "
          f"{worst['parameter']:.3g}")
    _same_run(run["ranks"][0][1]["fused"], run["ranks"][0][1]["pipelined"], "plain")


def test_sharded_epoch_refusals(tmp_path, monkeypatch):
    """Over ranks: the K-epoch window always (the JAX package's is
    single-device), the fused epoch where its graphs cannot capture the
    collectives (gloo on the card, ranks sharing it: the message names
    gloo), through ``check_mesh_modes`` and the command line."""
    check_mesh_modes(W, True)                 # the CPU: nothing is captured
    check_mesh_modes(W, True, 0, "nccl")      # a card a rank
    check_mesh_modes(1, True, 2, "gloo")      # one rank: no mesh
    with pytest.raises(ValueError, match="gloo"):
        check_mesh_modes(W, True, 0, "gloo")
    for backend in (None, "nccl", "gloo"):
        with pytest.raises(ValueError, match="multi_epoch"):
            check_mesh_modes(W, True, 2, backend)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)  # two ranks share one card
    base = ["--synthetic", "--n_devices", str(W), "--save_dir", str(tmp_path)]
    for extra, match in ((["--fused_epoch"], "gloo"),
                         (["--fused_epoch", "--multi_epoch", "2", "--device", "cpu"],
                          "multi_epoch")):
        args = cli.parse_args(base + extra)
        cfg, name = cli.load_config(args)
        with pytest.raises(ValueError, match=match):
            cli.run(args, cfg, name)
    assert not list(tmp_path.iterdir())


def test_graphed_fused_epoch_refuses_a_gloo_mesh():
    """The batcher's fused epoch on the card over a gloo mesh is refused
    before anything touches the card, naming the backend (no fallback to
    the streaming step); the capability test: NCCL yes, gloo no."""
    for backend, capturable in (("gloo", False), ("nccl", True)):
        mesh = pmesh.Mesh(size=W, rank=0, device=torch.device("cuda"), backend=backend)
        assert mesh.capturable is capturable
    gloo = pmesh.Mesh(size=W, rank=0, device=torch.device("cuda"), backend="gloo")
    batcher = CooperativeBatcher(SyntheticSegDataset(length=N_TRAIN, pad_size=PAD), BATCH, POLICY,
                                 PAD, CROP, device="cuda", mesh=gloo)
    with pytest.raises(ValueError, match="gloo"):
        batcher.fused_epoch_runner(CooperativeTrainer(None, device="cpu"))
    assert batcher._cached is None


def test_replicate_sharding_and_the_nccl_row():
    """``replicate_sharding`` keeps every row (JAX's ``P()``), beside
    ``batch_sharding``'s rank rows; NCCL's kernels get a row of their own
    in the device-time tables."""
    mesh = pmesh.Mesh(size=W, rank=1, device=torch.device("cpu"))
    t = torch.arange(8)
    assert torch.equal(t[pmesh.replicate_sharding(mesh)], t)
    assert torch.equal(t[pmesh.batch_sharding(mesh, 8)], t[4:])
    assert _group("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)") \
        == NCCL_GROUP
    assert _group("void at::native::reduce_kernel<512, 1>") != NCCL_GROUP


def test_launched_counts_collectives_as_launches():
    """``graphs.launched`` with a mesh's ``calls`` in the ticks: a capture
    ticks ``Mesh.calls`` and runs nothing, a replay runs the graph's
    collectives and ticks nothing; validation's graph captures none (its
    sum over the ranks runs after it, one call a validation)."""
    from collections import Counter
    from types import SimpleNamespace as NS

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        launched,
    )

    step = NS(graphs={"a": NS(launches={"k1": 3}, collectives=600),
                      "b": NS(launches={"k1": 2}, collectives=610)},
              replays=Counter({"a": 4}))  # "b" captured and never replayed
    val = NS(graph=object(), launches={"k1": 5}, collectives=0, replays=2)
    eager = {"k1": 10, "collectives": 600 + 610 + 3}  # the first steps, three validations' sums
    ticks = {"k1": eager["k1"] + 3 + 2 + 5, "collectives": eager["collectives"] + 600 + 610}
    assert launched(ticks, [step], [val]) == {"k1": 10 + 4 * 3 + 2 * 5,
                                              "collectives": eager["collectives"] + 4 * 600}
    assert "collectives" not in launched({"k1": ticks["k1"]}, [step], [val])
