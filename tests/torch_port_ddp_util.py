"""Shared set-up of the port's data-parallel parity tests (not a test
module): the data, the JAX package's sharded step, the port's one-process
step with its own sensitivity, and the checks, whose tolerances are:

against JAX's sharded step JAX's own (``tests/test_sharding.py``: the
losses at rtol 1e-4, the parameters at rtol 1e-3, atol 5e-4), and the
running statistics within 1e-4 of each tensor's scale; against the port's
one-process step the whole-step bounds of the port's step files
(``torch_port_util.check_step_*``): the losses within 1e-4 of their value,
the running statistics within 1e-4 of each tensor's scale, Adam's moments
and the update per tensor in the Frobenius norm within 1e-3 of its norm or
twice the one-process step's own move under N_MOVES input moves of
SENSITIVITY a pixel.  (The one-process step's own gradient moves by 0.8-0.9 %
of its norm under a mere permutation of its batch, which reorders its
sums as the ranks do, so per-element gradient bounds would not hold.)
The masks are equal but where a saliency lies next to its threshold, and
a rank's saliency is W times the one-process one (each rank's loss is its
shard's mean), within 1e-3 of its norm.
"""

import jax
import numpy as np
import torch
import torch_port_ddp_ranks as R
from torch_port_util import LR, N_MOVES, SENSITIVITY, assert_masks_agree, replay_draws

from cooperative_training_and_latent_space_data_augmentation_tpu.parallel import mesh as jmesh
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

HW, BATCH, W = 32, 4, 2
BRANCHES = ("dropout", "spatial", "channel")


def data():
    rng = np.random.RandomState(1)
    image = rng.uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32)
    label = rng.randint(0, 4, (BATCH, HW, HW)).astype(np.int32)
    return image, label


def key_for(lda, image_branch, shape_branch, first=100):
    """The first key at or after ``first`` whose draws take these branches
    on the image and the shape code."""
    k = first
    while True:
        d = replay_draws(jax.random.PRNGKey(k), lda, BATCH, (HW, HW))
        if (d.image.branch, d.shape.branch) == (image_branch, shape_branch):
            return k
        k += 1


def branch_keys(lda):
    """A key for each branch drawn on both codes, in branch order."""
    return [key_for(lda, b, b) for b in range(len(BRANCHES))]


def jax_sharded_steps(solver, state, batch, keys, **step_kw):
    """JAX's step over a 2-device mesh from ``state`` for each key: (the
    metrics, the new state in the port's layout)."""
    step = solver.make_train_step(donate=False, **step_kw)
    mesh = jmesh.make_mesh(W)
    sharded = jmesh.shard_train_step(step.__wrapped__, mesh, donate=False)
    out = []
    for k in keys:
        new, metrics = sharded(jmesh.replicate(mesh, state), jmesh.shard_batch(mesh, batch),
                               jmesh.replicate(mesh, jax.random.PRNGKey(k)))
        new = jax.device_get(new)
        out.append(({k: float(v) for k, v in metrics.items()},
                    convert.from_jax(new.params, new.batch_stats)))
    return out


def moved_images(image, seed=2):
    rng = np.random.RandomState(seed)
    return [(image * (1 + SENSITIVITY * rng.choice([-1, 1], image.shape))).astype(np.float32)
            for _ in range(N_MOVES)]


def one_process(lda, sd, image, label, draws, **trainer_kw):
    """The port's one-process step, and the same step on the moved images
    (its own sensitivity)."""
    lbl = torch.from_numpy(label)
    one = R.one_step(lda, sd, torch.from_numpy(image), lbl, draws, **trainer_kw)
    moved = [R.one_step(lda, sd, torch.from_numpy(m), lbl, draws, **trainer_kw)
             for m in moved_images(image)]
    return one, moved


def merged(ranks, field):
    """The ranks' ``generation`` (branch, mask, saliency) per code, rows
    joined in rank order."""
    out = {}
    for key in ranks[0][field]:
        parts = [r[field][key] for r in ranks]
        sal = None if parts[0][2] is None else torch.cat([p[2] for p in parts])
        out[key] = (parts[0][0], torch.cat([p[1] for p in parts]), sal)
    return out


def check_losses(got, want, rtol, what):
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= rtol * abs(w) + 1e-7, (what, k, got[k], w)


def check_stats(got_state, want_state, what):
    for name, sd in want_state.items():
        for k, w in sd.items():
            if "running_" in k:
                torch.testing.assert_close(got_state[name][k], w, rtol=0,
                                           atol=1e-4 * float(w.abs().max()),
                                           msg=f"{what} {name}.{k}")


def check_against_jax(ranks, jax_metrics, jax_state, what):
    check_losses(ranks[0]["metrics"], jax_metrics, 1e-4, what)
    for name, sd in jax_state.items():
        for k, w in sd.items():
            if "running_" not in k:
                np.testing.assert_allclose(ranks[0]["state"][name][k].numpy(), w.numpy(),
                                           rtol=1e-3, atol=5e-4, err_msg=f"{what} {name}.{k}")
    check_stats(ranks[0]["state"], jax_state, what)


def check_against_one(ranks, one, moved, before, lda, draws, what):
    """The port's whole-step bounds (module docstring)."""
    got = ranks[0]
    check_losses(got["metrics"], one["metrics"], 1e-4, what)
    check_stats(got["state"], one["state"], what)
    mu_bound = {}
    for field in ("mu", "nu"):
        want = one[field]
        top = max(float(v.abs().max()) for sd in want.values() for v in sd.values())
        for name, sd in want.items():
            for k, w in sd.items():
                w64, g64 = w.double(), got[field][name][k].double()
                own = max(float((m[field][name][k].double() - w64).norm()) for m in moved)
                bound = max(1e-3 * float(w64.norm()), 2 * own, 1e-6 * top * np.sqrt(w.numel()))
                gap = float((g64 - w64).norm())
                assert gap <= bound, (what, field, name, k, gap, bound)
                if field == "mu":
                    mu_bound[(name, k)] = bound
    for name, sd in one["mu"].items():
        for k, mu in sd.items():
            old = before[name][k].double()
            u_one = one["state"][name][k].double() - old
            u_got = got["state"][name][k].double() - old
            own = max(float((m["state"][name][k].double() - old - u_one).norm()) for m in moved)
            undetermined = int((mu.abs() <= mu_bound[(name, k)]).sum())
            bound = max(1e-3 * float(u_one.norm()), 2 * own) + 2 * LR * np.sqrt(undetermined)
            assert float((u_got - u_one).norm()) <= bound, (what, "update", name, k)
    ddp_gen, one_gen = merged(ranks, "generation"), one["generation"]
    for key, (branch, mask, sal) in one_gen.items():
        g_branch, g_mask, g_sal = ddp_gen[key]
        assert g_branch == branch == getattr(draws, key).branch, (what, key)
        if sal is None:
            assert torch.equal(g_mask, mask), (what, key)
            continue
        n = mask.shape[0]
        flat = ((lambda m: m[:, :, 0, 0]) if branch == 2
                else (lambda m: m[:, 0].reshape(n, -1)))
        # each rank's loss is its shard's mean: the saliency is W times
        assert float((g_sal / W - sal).norm()) <= 1e-3 * float(sal.norm()), (what, key)
        assert_masks_agree(flat(g_mask).numpy(), flat(mask).numpy(), (g_sal / W).numpy(),
                           sal.numpy(), float(getattr(draws, key).p), f"{what} {key}")


def check_ranks_equal(ranks, what):
    for field in ("state", "mu", "nu"):
        for name, sd in ranks[0][field].items():
            for k, v in sd.items():
                assert torch.equal(v, ranks[1][field][name][k]), (what, field, name, k)
