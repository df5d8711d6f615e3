"""The port's whole-state checkpoint (``utils/checkpoint.py``, the JAX
package's orbax checkpoints in the port's own format) and resuming from it
(``train_network(resume_orbax=True)``, ``cli.train --resume_orbax``), on
the CPU at 32x32, f32.

The state after a step round-trips exactly (parameters, buffers, Adam's
moments and step); a state written by rank 0 of a 2-rank run restores into
one process and one written by one process into both ranks, bit for bit;
a step from a restored state equals the step from the state it was saved
from, bit for bit; ``max_to_keep`` and ``latest_step`` keep and report the
steps the JAX package's orbax manager does; ``--resume_orbax`` without a
checkpoint raises ``FileNotFoundError`` (JAX ``train/driver.py:140-141``);
and ``cli.train --n_devices 2 --device cpu`` trains 2 epochs, rank 0 alone
writing, then resumes at epoch 2 from the latest whole-state checkpoint.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_ddp_ranks as R
from torch_port_util import one_torch_thread  # noqa: F401

from cooperative_training_and_latent_space_data_augmentation_tpu.utils import (
    checkpoint as jckpt,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import config as pcfg
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel import mesh as pmesh
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import (
    checkpoint as ckpt,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, BATCH = 32, 4
LDA = pcfg.LatentDAConfig()


def batch_and_draws(seed):
    g = torch.Generator().manual_seed(seed)
    image = torch.rand(BATCH, HW, HW, 1, generator=g)
    label = torch.randint(0, 4, (BATCH, HW, HW), generator=g)
    return image, label, draw_step(g, BATCH, (HW, HW), LDA)


def stepped(seed=0, steps=1):
    trainer = CooperativeTrainer(LDA, device="cpu", seed=seed)
    for s in range(steps):
        trainer.train_step(*batch_and_draws(10 + s))
    return trainer


def assert_same_state(a, b):
    (ma, sa), (mb, sb) = a, b
    for n in ma:
        assert ma[n].keys() == mb[n].keys()
        for k in ma[n]:
            assert torch.equal(ma[n][k], mb[n][k]), (n, k)
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert x.keys() == y.keys() == {"step", "exp_avg", "exp_avg_sq"}
        for k in x:
            assert torch.equal(x[k], y[k]), k


def test_state_after_a_step_round_trips_exactly(tmp_path):
    trainer = stepped(steps=2)
    path = ckpt.save_checkpoint(str(tmp_path), trainer, step=5)
    assert path == os.path.join(str(tmp_path), "5", ckpt.STATE_FILE)
    fresh = CooperativeTrainer(LDA, device="cpu", seed=7)
    assert ckpt.restore_checkpoint(str(tmp_path), fresh) is fresh
    assert_same_state(R.whole_state(fresh), R.whole_state(trainer))
    assert float(fresh.optimizer.state[next(fresh.model.parameters())]["step"]) == 2


def test_a_step_from_the_restored_state_equals_one_from_the_saved(tmp_path):
    trainer = stepped()
    ckpt.save_checkpoint(str(tmp_path), trainer, step=0)
    restored = ckpt.restore_checkpoint(str(tmp_path), CooperativeTrainer(LDA, device="cpu",
                                                                          seed=3))
    nxt = batch_and_draws(20)
    got, want = restored.train_step(*nxt), trainer.train_step(*nxt)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}
    assert_same_state(R.whole_state(restored), R.whole_state(trainer))


def test_restore_refuses_another_network(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), stepped(), step=0)
    other = CooperativeTrainer(LDA, device="cpu", network_type="FCN_16_standard_share_code")
    with pytest.raises(ValueError, match="FCN_16_standard_share_code"):
        ckpt.restore_checkpoint(str(tmp_path), other)


@pytest.mark.parametrize("max_to_keep", [3, 1, None])
def test_max_to_keep_and_latest_step_as_jax_manager(tmp_path, max_to_keep):
    """Steps 0, 1, 2, 4, 7 saved in turn: the steps kept and the latest one
    are the JAX package's orbax manager's."""
    steps = (0, 1, 2, 4, 7)
    trainer = stepped()
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert ckpt.latest_step(port_dir) is None and jckpt.latest_step(jax_dir) is None
    for s in steps:
        ckpt.save_checkpoint(port_dir, trainer, step=s, max_to_keep=max_to_keep)
        jckpt.save_checkpoint(jax_dir, {"w": jnp.full((2,), float(s))}, step=s,
                              max_to_keep=max_to_keep)
    kept = sorted(int(d) for d in os.listdir(jax_dir) if d.isdigit())
    assert ckpt.all_steps(port_dir) == kept
    assert ckpt.latest_step(port_dir) == jckpt.latest_step(jax_dir) == 7
    restored = jckpt.restore_checkpoint(jax_dir, {"w": jnp.zeros((2,))})
    np.testing.assert_array_equal(np.asarray(restored["w"]), [7.0, 7.0])
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(port_dir, trainer, step=steps[0] if max_to_keep else 99)


def test_checkpoint_moves_between_two_ranks_and_one_process(tmp_path):
    """Rank 0's checkpoint of a data-parallel step into one process, and a
    one-process checkpoint into both ranks, bit for bit."""
    sd = {n: dict(getattr(stepped(seed=1).model, n).state_dict()) for n in MODULE_NAMES}
    image, label, draws = batch_and_draws(30)
    two, single = str(tmp_path / "two"), str(tmp_path / "one")
    trainer = stepped(seed=2, steps=2)
    ckpt.save_checkpoint(single, trainer, step=3)
    ranks = pmesh.launch(R.checkpoint_case, 2, "cpu", str(tmp_path / "store"),
                         args=(LDA, sd, two, image, label, draws, single))
    assert_same_state(ranks[0][0], ranks[1][0])
    one = ckpt.restore_checkpoint(two, CooperativeTrainer(LDA, device="cpu", seed=9))
    assert_same_state(R.whole_state(one), ranks[0][0])
    for _, restored in ranks:
        assert_same_state(restored, R.whole_state(trainer))


def tiny_config(tmp_path):
    """configs/ACDC/cooperative_training.json at 40x40 padded, 32x32
    cropped, batch 4, a periodic save every epoch."""
    with open(os.path.join(REPO, "configs", "ACDC", "cooperative_training.json")) as f:
        cfg = json.load(f)
    cfg["data"].update(pad_size=[40, 40, 1], crop_size=[HW, HW, 1])
    cfg["learning"]["batch_size"] = BATCH
    cfg.setdefault("output", {})["save_epoch_every_num_epochs"] = 1
    path = str(tmp_path / "tiny.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def cli_args(tmp_path, *extra):
    return cli.parse_args(["--json_config_path", tiny_config(tmp_path), "--synthetic",
                           "--synthetic_train_length", "4", "--synthetic_val_length", "4",
                           "--device", "cpu", "--save_dir", str(tmp_path / "runs"), "--log",
                           *extra])


def test_resume_orbax_without_a_checkpoint_raises(tmp_path):
    args = cli_args(tmp_path, "--resume_orbax", "--max_epochs", "1")
    cfg, name = cli.load_config(args)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        cli.run(args, cfg, name)


def test_cli_trains_over_two_ranks_and_resumes(tmp_path):
    args = cli_args(tmp_path, "--n_devices", "2", "--max_epochs", "2")
    cfg, name = cli.load_config(args)
    first = cli.run_ranks(args, cfg, name)
    assert [[e.epoch for e in r.epochs] for r in first] == [[0, 1], [0, 1]]
    for a, b in zip(*[r.epochs for r in first]):  # every rank logs the same epoch
        np.testing.assert_array_equal(a.losses, b.losses)
        np.testing.assert_array_equal(a.confusion, b.confusion)
    assert first[1].written == [] and first[0].written
    on_disk = {os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "runs") for f in fs}
    writes = first[0].written
    assert all(any(p == w or p.startswith(w + os.sep) for w in writes) for p in on_disk)
    model_dir = os.path.join(str(tmp_path / "runs"), "train_ACDC_10_n_cls_4", "tiny", "0",
                             "model")
    assert ckpt.all_steps(os.path.join(model_dir, "orbax")) == [0, 1]
    resumed = cli.run_ranks(cli_args(tmp_path, "--n_devices", "2", "--max_epochs", "3",
                                     "--resume_orbax"), cfg, name)
    assert [[e.epoch for e in r.epochs] for r in resumed] == [[2], [2]]
    assert ckpt.all_steps(os.path.join(model_dir, "orbax")) == [0, 1, 2]
