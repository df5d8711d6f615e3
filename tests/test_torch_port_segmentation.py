"""The port's ``SegmentationSolver``, optimizers and EMA against the JAX
package's, on the CPU.

Both solvers start from the same weights (numpy draws in the JAX layout)
and the same JAX train state, carried over by
``convert.baseline_train_state_from_jax``; batches are 2 x 32 x 32 x 1
with 4 classes, from a numpy seed; the JAX step is its own jitted
``make_train_step``.

Tolerances, f32. A step's loss within 1e-5 of its value. Running
statistics, spectral-norm ``u``/``sigma``, EMA parameters and the clip's
moments after the steps within 1e-5 of each tensor's scale (at least 1;
the moments' own), or twice JAX's own largest move relative to scale
when its input image moves by 1e-7 per pixel (twice, with random signs).
Adam's moments and the parameter updates after the steps are held as
``torch_port_util.check_step_moments_and_update`` holds the cooperative
step's: per tensor, in the Frobenius norm, within 1e-3 of the tensor's
norm or twice JAX's own move when its input image moves by 1e-7 per
pixel, and each element whose ``mu`` lies within that bound of 0 (its
sign undetermined, so Adam may move it by lr either way) may add 2 lr a
step to the update's gap. Learning rates: equal as float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.eval.metrics import (
    RunningScore as JaxRunningScore,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.train.segmentation import (
    SegmentationSolver as JaxSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.utils import schedulers as jsched
from cooperative_training_and_latent_space_data_augmentation_tpu.utils.ema import (
    ExponentialMovingAverage as JaxEMA,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.metrics import (
    RunningScore,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.segmentation import (
    SegmentationSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import schedulers
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils.ema import (
    ExponentialMovingAverage,
)
from test_torch_port_baselines import random_variables
from torch_port_util import one_torch_thread  # noqa: F401

HW, BATCH, CLASSES, LR = 32, 2, 4, 1e-4
N_MOVES = 2           # JAX's own sensitivity: its input image moved +-1e-7 per pixel, twice
MOVE = 1e-7


def _batch(seed=0):
    rng = np.random.RandomState(50 + seed)
    return {"image": rng.rand(BATCH, HW, HW, 1).astype(np.float32),
            "label": rng.randint(0, CLASSES, (BATCH, HW, HW)).astype(np.int32)}


def _with_count(opt_state, count):
    """An optax state with every ``count`` set to ``count``."""
    if isinstance(opt_state, dict):
        return {k: (jnp.asarray(count, jnp.int32) if k == "count" else v)
                for k, v in opt_state.items()}
    if hasattr(opt_state, "_fields"):
        return (opt_state._replace(count=jnp.asarray(count, jnp.int32))
                if "count" in opt_state._fields else opt_state)
    if isinstance(opt_state, tuple):
        return tuple(_with_count(s, count) for s in opt_state)
    return opt_state


def make_pair(network, count=0, **kw):
    """(JAX solver, its state, port solver) on the same weights and state."""
    js = JaxSolver(network, num_classes=CLASSES, learning_rate=LR, **kw)
    params, stats = random_variables(js.model, (1, HW, HW, 1), seed=3, train=False)
    params = jax.tree.map(jnp.asarray, params)
    state = js.init_state(jax.random.PRNGKey(0), input_hw=(HW, HW))
    tree = {"online": params, "ema": params} if js.use_ema else params
    state = state.replace(params=tree, batch_stats=jax.tree.map(jnp.asarray, stats),
                          opt_state=_with_count(js.tx.init(params), count))
    port = SegmentationSolver(network, num_classes=CLASSES, learning_rate=LR, device="cpu", **kw)
    port.load_train_state(convert.baseline_train_state_from_jax(
        port.model, jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats), state.opt_state))
    return js, state, port


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def run_steps(js, state, port, n_steps, batches):
    """``n_steps`` on both sides, and JAX's on moved inputs: returns a
    record of the states, losses and the port's solver."""
    step = js.make_train_step(donate=False)
    key = jax.random.PRNGKey(9)

    def jax_run(scale):
        s, losses = state, []
        for b in batches[:n_steps]:
            moved = {"image": jnp.asarray(b["image"] * scale), "label": jnp.asarray(b["label"])}
            s, m = step(s, moved, key)
            losses.append(float(m["loss/total"]))
        return _host(s), losses

    after, jax_losses = jax_run(1.0)
    signs = [np.random.RandomState(k).randint(0, 2, batches[0]["image"].shape) * 2 - 1
             for k in range(N_MOVES)]
    moved = [jax_run(1.0 + MOVE * sg)[0] for sg in signs]
    port_losses = [float(port.train_step(torch.from_numpy(b["image"]),
                                         torch.from_numpy(b["label"]))["loss/total"])
                   for b in batches[:n_steps]]
    return {"before": _host(state), "after": after, "moved": moved, "jax_losses": jax_losses,
            "port_losses": port_losses, "port": port, "n_steps": n_steps}


def _port_state(rec, state):
    return convert.baseline_train_state_from_jax(rec["port"].model, state.params,
                                                 state.batch_stats, state.opt_state)


def check_losses(rec):
    for i, (g, w) in enumerate(zip(rec["port_losses"], rec["jax_losses"])):
        assert abs(g - w) <= 1e-5 * abs(w), (i, g, w)


def check_close_or_own(got, want, moved, what, floor=1.0):
    """Each tensor of ``got`` against ``want``, element-wise, within 1e-5
    of its scale (its largest |value|, at least ``floor``), or within twice
    JAX's own largest move relative to scale anywhere in ``moved`` (the
    same tensors after JAX's steps on moved inputs): where a sign flip of an
    undetermined update lands is chance, so the whole set's sensitivity is
    the yardstick."""
    scale = {k: max(floor, float(w.abs().max())) for k, w in want.items()}
    own = max(float((m[k] - w).abs().max()) / scale[k] for m in moved for k, w in want.items())
    for k, g in got.items():
        tol = max(1e-5, 2 * own) * scale[k]
        err = float((g - want[k]).abs().max())
        assert err <= tol, (what, k, err, tol)


def check_buffers(rec):
    """Running statistics and SN u/sigma after the steps."""
    check_close_or_own(dict(rec["port"].model.named_buffers()),
                       _port_state(rec, rec["after"]).state_dict,
                       [_port_state(rec, m).state_dict for m in rec["moved"]], "buffers")


def check_moments_and_update(rec):
    port = rec["port"]
    want = _port_state(rec, rec["after"])
    moved = [_port_state(rec, m) for m in rec["moved"]]
    before = _port_state(rec, rec["before"]).state_dict
    adam = port.optimizer.adam
    params = dict(port.model.named_parameters())
    for which in ("exp_avg", "exp_avg_sq"):
        top = max(float(v.abs().max()) for v in getattr(want, which).values())
        for name, p in params.items():
            g = adam.state[p][which].double().numpy()
            w = getattr(want, which)[name].double().numpy()
            own = max(np.linalg.norm(getattr(m, which)[name].double().numpy() - w) for m in moved)
            bound = max(1e-3 * np.linalg.norm(w), 2 * own, 1e-6 * top * np.sqrt(w.size))
            assert np.linalg.norm(g - w) <= bound, (which, name, np.linalg.norm(g - w), bound)
            if which == "exp_avg":
                undetermined = int((np.abs(w) <= bound).sum())
                old = before[name].double().numpy()
                u_jax = want.state_dict[name].double().numpy() - old
                u_port = p.detach().double().numpy() - old
                own_u = max(np.linalg.norm(m.state_dict[name].double().numpy() - old - u_jax)
                            for m in moved)
                u_bound = (max(1e-3 * np.linalg.norm(u_jax), 2 * own_u)
                           + 2 * LR * rec["n_steps"] * np.sqrt(undetermined))
                assert np.linalg.norm(u_port - u_jax) <= u_bound, (
                    name, np.linalg.norm(u_port - u_jax), u_bound)
    assert adam.state[next(iter(params.values()))]["step"] == int(want.step)
    assert port.optimizer.count == want.step


@pytest.mark.parametrize("network", ["UNet_16", "IN_SN_UNet_16"])
def test_three_adam_steps_match_jax(network):
    js, state, port = make_pair(network)
    rec = run_steps(js, state, port, 3, [_batch(i) for i in range(3)])
    check_losses(rec)
    check_buffers(rec)
    check_moments_and_update(rec)


def test_ada_adam_learning_rate_matches_optax():
    """AdaAdam's learning rate at every update count 0..250 with
    steps_per_epoch 2 is the JAX optimizer's ``learning_rate *
    sched(count // steps_per_epoch)`` (``make_optimizer``'s step policy,
    halving every 50 epochs), as float32; then one real step each side of
    the first halving (counts 99 and 100) against JAX's."""
    port = SegmentationSolver("UNet_16", optimizer_name="AdaAdam", steps_per_epoch=2,
                              learning_rate=LR, device="cpu")
    sched = jsched.make_lr_schedule("step", lr_decay_iters=50)
    for count in range(251):
        want = np.float32(LR * sched(jnp.asarray(count) // 2))
        assert np.float32(port.optimizer.lr(count)) == want, (count, port.optimizer.lr(count),
                                                              want)
    for count in (99, 100):
        js, state, port = make_pair("UNet_16", count=count, optimizer_name="AdaAdam",
                                    steps_per_epoch=2)
        rec = run_steps(js, state, port, 1, [_batch(5)])
        check_losses(rec)
        check_moments_and_update(rec)


def test_adam_bound_clip_matches_optax_chain():
    """The clip over five updates against ``optax.chain(clip, adam)``
    (the JAX package's ``make_optimizer(clip=True)``), on gradients that
    grow tenfold each update so that the bound bites: the parameters and
    the clip's ``nu`` after each update."""
    rng = np.random.RandomState(4)
    shapes = {"a": (3, 5), "b": (7,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** i).astype(np.float32) for k, s in shapes.items()}
             for i in range(5)]
    tx = jsched.make_optimizer(1e-2, clip=True)
    jp = jax.tree.map(jnp.asarray, p0)
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = schedulers.make_optimizer(list(tp.values()), 1e-2, clip=True)
    bit = 0
    for g in grads:
        clip_before = jnp.asarray(js[0]["nu"]["a"])
        updates, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, updates)
        for (k, p) in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for i, k in enumerate(tp):
            # each update rounds the parameter once on each side
            ulp = np.spacing(np.float32(np.abs(np.asarray(jp[k])).max()))
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=2 * opt.count * ulp, err_msg=k)
            np.testing.assert_allclose(opt.clip.nu[i].numpy(), np.asarray(js[0]["nu"][k]),
                                       rtol=1e-5, err_msg=k)
        bound = 3 * np.sqrt(np.asarray(clip_before) / (1 - 0.999 ** max(opt.count - 1, 1))) + 0.1
        bit += int(opt.count > 1 and (np.abs(g["a"]) > bound).any())
    assert bit >= 3  # the clip bit on most updates


def test_plateau_scheduler_matches_jax():
    metrics = [1.0, 0.95, 0.949, 0.948, 0.95, 0.96, 0.97, 0.98, 0.99, 0.5, 0.6, 0.6, 0.6, 0.6,
               0.6, 0.6, 0.6]
    for policy in ("plateau", "plateau2"):
        j, p = jsched.make_plateau_scheduler(policy), schedulers.make_plateau_scheduler(policy)
        assert [j.step(m) for m in metrics] == [p.step(m) for m in metrics]


@pytest.mark.parametrize("policy", ["lambda", "step", "step2", "step_warmstart",
                                    "step_warmstart2", "poly"])
def test_lr_policies_match_jax(policy):
    kw = {"lambda": dict(niter=40, niter_decay=60, epoch_count=3), "poly": dict(max_iter=300)}
    kw = kw.get(policy, dict(lr_decay_iters=7))
    j, p = jsched.make_lr_schedule(policy, **kw), schedulers.make_lr_schedule(policy, **kw)
    for step in range(0, 300, 3):
        np.testing.assert_allclose(p(step), float(j(jnp.asarray(step))), rtol=1e-6, atol=1e-7)
    assert schedulers.lr_poly(0.1, 30, 300, 0.9) == jsched.lr_poly(0.1, 30, 300, 0.9)


def test_solver_ema_with_ada_adam_and_clip_matches_jax():
    """The solver's in-step EMA (``d e + (1 - d) p`` after each update) on
    ResUNet_16 with AdaAdam and the clip, three steps: the EMA parameters
    and the clip's moments as the running statistics are held, and a
    predict on the EMA parameters."""
    kw = dict(use_ema=True, ema_decay=0.9, optimizer_name="AdaAdam", clip_grad=True)
    js, state, port = make_pair("ResUNet_16", **kw)
    rec = run_steps(js, state, port, 3, [_batch(i) for i in range(3)])
    check_losses(rec)
    check_moments_and_update(rec)
    want = _port_state(rec, rec["after"])
    moved = [_port_state(rec, m) for m in rec["moved"]]
    check_close_or_own(port.ema_params, want.ema, [m.ema for m in moved], "ema")
    names = [n for n, _ in port.model.named_parameters()]
    check_close_or_own(dict(zip(names, port.optimizer.clip.nu)), want.clip_nu,
                       [m.clip_nu for m in moved], "clip nu", floor=0.0)
    x = _batch(7)["image"]
    after = jax.tree.map(jnp.asarray, rec["after"])
    got = port.predict(torch.from_numpy(x), use_ema_params=True).numpy()
    ref = np.asarray(js.predict(after, jnp.asarray(x), use_ema_params=True))
    assert np.abs(got - ref).max() <= 2e-4 + 4e-6 * np.abs(ref).max()


def test_ema_class_matches_jax():
    """``utils/ema.py``: the shadow after each update (warm-up decay
    ``min(d, (1 + n) / (10 + n))``) within 1e-6 of JAX's, and copy_to,
    store and restore."""
    rng = np.random.RandomState(8)
    seq = [[rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=5).astype(np.float32)]
           for _ in range(6)]
    for use_num in (True, False):
        j = JaxEMA([jnp.asarray(a) for a in seq[0]], 0.99, use_num_updates=use_num)
        p = ExponentialMovingAverage([torch.from_numpy(a) for a in seq[0]], 0.99,
                                     use_num_updates=use_num)
        for params in seq[1:]:
            j.update([jnp.asarray(a) for a in params])
            p.update([torch.from_numpy(a) for a in params])
            for got, want in zip(p.shadow_params, j.shadow_params):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    live = [torch.zeros(4, 3), torch.zeros(5)]
    p.store(live)
    p.copy_to(live)
    for got, want in zip(live, j.copy_to()):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    p.restore(live)
    assert all(not t.any() for t in live)


def test_evaluate_confusion_matrix_matches_jax():
    js, state, port = make_pair("FCN_16")
    x, y = _batch(2)["image"], _batch(2)["label"]
    want = JaxRunningScore(CLASSES)
    js.evaluate(state, jnp.asarray(x), y, want)
    got = RunningScore(CLASSES, device="cpu")
    pred = port.evaluate(torch.from_numpy(x), torch.from_numpy(y), got)
    assert pred.shape == (BATCH, HW, HW)
    np.testing.assert_array_equal(got.confusion_matrix.numpy(), want.confusion_matrix)
