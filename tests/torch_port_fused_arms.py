"""Shared set-up of the fused step arms' parity tests (not a test module).

:func:`run_fused_case` runs one step of the JAX package's
``make_train_step(fused_stn=...)`` or ``(fused_ftn=...)`` and the port's
``CooperativeTrainer(fused_stn=..., fused_ftn=...)`` from the same weights
(``torch_port_util.random_variables``) on the same batch and the replayed
draws, float32 at 32x32, batch :data:`BATCH`.  JAX's optimizer is
``optax.sgd(1.0)``, so its update is minus its gradient (the linear probe
of ``tests/test_cooperative.py``'s fused tests); the port's gradients are
its parameters' ``.grad`` after the step.  :func:`check_fused_case` holds
the two with the tolerances of those JAX tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch_port_util import N_MOVES, SENSITIVITY, jax_train_state, random_variables, replay_draws

from cooperative_training_and_latent_space_data_augmentation_tpu import config as jcfg
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import config as pcfg
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)

HW = 32
BATCH = 4
KEY = 11

# tests/test_cooperative.py:312-430 hold JAX's fused arms to its own
# sequential step: the nine losses at rtol 2e-5, atol 1e-6; the gradients
# per element at rtol 2e-3, atol 2e-4 of the tensor's largest element plus
# a floor of the global gradient scale gmax (1e-5 gmax for the STN batch,
# 8e-4 gmax for the FTN batch); the BN running statistics at rtol 1e-5,
# atol 1e-6.  :func:`check_seq_and_fused` holds the port's arms to the
# port's sequential step with exactly these.
LOSS_RTOL, LOSS_ATOL = 2e-5, 1e-6
GRAD_RTOL, GRAD_SCALE_ATOL = 2e-3, 2e-4
GRAD_FLOOR = {"fused_stn": 1e-5, "fused_ftn": 8e-4}
SEQ_STATS_RTOL, SEQ_STATS_ATOL = 1e-5, 1e-6
# across the two frameworks the gradients and the statistics are held as
# the port's step files hold the sequential step (torch_port_util's
# check_step_moments_and_update on Adam's first moment, 0.1 of the
# gradient after one step, and check_step_running_stats): per tensor in
# the Frobenius norm within 1e-3 of its norm, twice JAX's own move under
# N_MOVES input moves of SENSITIVITY or 1e-6 gmax a sqrt(element);
# statistics within 1e-4 of each tensor's largest element
GRAD_NORM_RTOL, GRAD_NORM_FLOOR = 1e-3, 1e-6
STATS_ATOL = 1e-4


def latent_da(on: bool = True, gen_seg: bool = True):
    """(JAX, port) latent DA configs: ``mask_type="random"`` on both codes
    (the defaults), the shape code only with ``gen_seg``; None when off."""
    if not on:
        return None, None
    scope = ("image code", "shape code") if gen_seg else ("image code",)
    return jcfg.LatentDAConfig(mask_scope=scope), pcfg.LatentDAConfig(mask_scope=scope)


def _data():
    rng = np.random.RandomState(7)
    image = rng.uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32)
    label = rng.randint(0, 4, (BATCH, HW, HW)).astype(np.int32)
    return image, label


@functools.lru_cache(maxsize=1)
def _weights():
    """(params, batch_stats), numpy, the same for every case (the modules'
    shapes do not depend on the arm, ``remat`` or ``separate_training``)."""
    return random_variables(CooperativeTripletSolver(input_hw=(HW, HW)), seed=0)


def run_fused_case(arm: str, lda_on: bool = True, gen_seg: bool = True,
                   separate: bool = False, remat: bool = False):
    """One step of ``arm`` ("fused_stn" or "fused_ftn") in both packages:
    a record of JAX's and the port's losses, gradients and running
    statistics, and JAX's on N_MOVES moved images (its own sensitivity)."""
    jlda, lda = latent_da(lda_on, gen_seg)
    solver = CooperativeTripletSolver(input_hw=(HW, HW), remat=remat)
    solver.tx = optax.sgd(1.0)
    params, stats = _weights()
    image, label = _data()
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    state = jax_train_state(solver, params, stats)
    step = solver.make_train_step(latent_da=jlda, donate=False, separate_training=separate,
                                  **{arm: True})
    key = jax.random.PRNGKey(KEY)
    rng = np.random.RandomState(8)
    moves = [dict(batch, image=jnp.asarray(
        (image * (1 + SENSITIVITY * rng.choice([-1, 1], image.shape))).astype(np.float32)))
        for _ in range(N_MOVES)]

    def host(new):
        """(gradients, running statistics) of a JAX step, in the port's
        layout."""
        new = jax.device_get(new)
        sd = convert.from_jax(jax.tree.map(lambda a, b: a - b, params, new.params),
                              new.batch_stats)
        return ({n: {k: v for k, v in d.items() if "running_" not in k} for n, d in sd.items()},
                {n: {k: v for k, v in d.items() if "running_" in k} for n, d in sd.items()})

    new, metrics = step(state, batch, key)
    rec = {"arm": arm, "metrics": {k: float(v) for k, v in metrics.items()}}
    rec["grads"], rec["stats"] = host(new)
    rec["moved"] = [host(step(state, m, key)[0]) for m in moves]
    trainer = CooperativeTrainer(lda, device="cpu", separate_training=separate, remat=remat,
                                 **{arm: True})
    assert getattr(trainer, arm)
    trainer.model.load_state_dicts(convert.from_jax(params, stats))
    draws = replay_draws(key, lda, BATCH, (HW, HW))
    got = trainer.train_step(torch.from_numpy(image), torch.from_numpy(label), draws)
    rec["port_metrics"] = {k: float(v) for k, v in got.items()}
    rec["port_grads"] = {name: {k: p.grad.clone() for k, p in
                                getattr(trainer.model, name).named_parameters()}
                         for name in MODULE_NAMES}
    rec["port_stats"] = {name: {k: v.clone() for k, v in
                                getattr(trainer.model, name).state_dict().items()
                                if "running_" in k}
                         for name in MODULE_NAMES}
    return rec


def check_fused_case(rec, what=""):
    """The port's step against JAX's: the nine losses at the JAX tests'
    tolerances (the four hard ones also show that generation made JAX's
    hard examples: a mask swapped next to its threshold moves them by
    more), the gradients and the running statistics at the
    cross-framework bounds of the port's step files
    (``check_step_moments_and_update``, ``check_step_running_stats``; see
    the test modules' docstrings)."""
    for k, want in rec["metrics"].items():
        got = rec["port_metrics"][k]
        assert abs(got - want) <= LOSS_ATOL + LOSS_RTOL * abs(want), (what, k, got, want)
    want_g = rec["grads"]
    top = max(float(v.abs().max()) for sd in want_g.values() for v in sd.values())
    own_scale = 2.0
    for name, sd in want_g.items():
        for k, w in sd.items():
            g = rec["port_grads"][name][k]
            own = max(float((m[0][name][k] - w).norm()) for m in rec["moved"])
            bound = max(GRAD_NORM_RTOL * float(w.norm()), own_scale * own,
                        GRAD_NORM_FLOOR * top * np.sqrt(w.numel()))
            gap = float((g - w).norm())
            assert gap <= bound, (what, "grad", name, k, gap, bound)
    for name, sd in rec["stats"].items():
        for k, w in sd.items():
            torch.testing.assert_close(rec["port_stats"][name][k], w, rtol=0,
                                       atol=STATS_ATOL * float(w.abs().max()),
                                       msg=f"{what} stats {name}.{k}")


def port_step(arm, lda_on: bool = True, gen_seg: bool = True, **trainer_kw):
    """One port step from :func:`random_variables`' weights on JAX's
    replayed draws: (metrics, {module: {name: grad}}, {module: {name:
    running statistic}}); ``arm`` None runs the sequential step."""
    _, lda = latent_da(lda_on, gen_seg)
    params, stats = _weights()
    image, label = _data()
    trainer = CooperativeTrainer(lda, device="cpu", **trainer_kw, **({arm: True} if arm else {}))
    trainer.model.load_state_dicts(convert.from_jax(params, stats))
    draws = replay_draws(jax.random.PRNGKey(KEY), lda, BATCH, (HW, HW))
    got = trainer.train_step(torch.from_numpy(image), torch.from_numpy(label), draws)
    return ({k: float(v) for k, v in got.items()},
            {n: {k: p.grad.clone() for k, p in getattr(trainer.model, n).named_parameters()}
             for n in MODULE_NAMES},
            {n: {k: v.clone() for k, v in getattr(trainer.model, n).state_dict().items()
                 if "running_" in k} for n in MODULE_NAMES})


def check_seq_and_fused(arm, seq, fused, what=""):
    """The port's fused step against its sequential step with the
    tolerances of JAX's own fused tests (see above)."""
    (ms, gs, ss), (mf, gf, sf) = seq, fused
    for k, want in ms.items():
        assert abs(mf[k] - want) <= LOSS_ATOL + LOSS_RTOL * abs(want), (what, k, mf[k], want)
    gmax = max(float(v.abs().max()) for sd in gs.values() for v in sd.values())
    floor = GRAD_FLOOR[arm] * gmax + 1e-7
    for n, sd in gs.items():
        for k, w in sd.items():
            torch.testing.assert_close(gf[n][k], w, rtol=GRAD_RTOL,
                                       atol=GRAD_SCALE_ATOL * float(w.abs().max()) + floor,
                                       msg=f"{what} grad {n}.{k}")
    for n, sd in ss.items():
        for k, w in sd.items():
            torch.testing.assert_close(sf[n][k], w, rtol=SEQ_STATS_RTOL, atol=SEQ_STATS_ATOL,
                                       msg=f"{what} stats {n}.{k}")
