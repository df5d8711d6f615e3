"""The port's cooperative train step in bf16 (the main path's precision:
bf16 convs, f32 norms, heads, latents and losses) against the JAX
package's, on the CPU, at 32x32, batch 2.

* ``mask_type="dropout"``, two steps in a row: held to twice the JAX
  package's own bf16 error, as the predictor's bf16 parity is
  (``torch_port_util.assert_bf16_close``).  Over all metrics, over all of
  Adam's ``mu``, over all of ``nu``, over all updates ``p_new - p_old``
  and over all running statistics of a step, the port's largest and mean
  difference from JAX's bf16 step are at most twice those of JAX's bf16
  step from its f32 step (the metrics of both steps together).  The rule
  is taken over each whole set, not per
  scalar or tensor: where JAX's bf16 and f32 results happen to land close,
  one number's own error can be arbitrarily small.  All three start each
  step from the same state (JAX's bf16 state after the step before) with
  the same draws.  Dropout's masks come from the draws alone, so this
  holds every bf16 rounding point of the loss graph and of generation's
  decode without a mask decision in between.
* ``mask_type="random"`` (the main path), the targeted masks drawn from
  the initial state: in bf16 the saliency goes through bf16 convs, so a
  channel or location near the threshold can take the other side in
  either package.  The masks must be equal, or swapped only where the
  saliency lies within twice the port's largest bf16 saliency difference
  of the row's threshold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture
    BATCH,
    HW,
    STEP_KEYS,
    assert_masks_agree,
    bf16_close_sets,
    jax_generation,
    jax_train_state,
    make_solver,
    one_torch_thread,
    random_variables,
    replay_draws,
    saliency_of,
    step_configs,
)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _setup():
    f32, bf16 = make_solver(), make_solver(jnp.bfloat16)
    params, stats = random_variables(f32, seed=0)
    rng = np.random.RandomState(1)
    image = rng.uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32)
    label = rng.randint(0, 4, (BATCH, HW, HW)).astype(np.int32)
    return f32, bf16, params, stats, image, label


@pytest.fixture(scope="module")
def steps():
    f32, bf16, params, stats, image, label = _setup()
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    jlda, lda = step_configs("dropout")
    step16 = bf16.make_train_step(latent_da=jlda, donate=False)
    step32 = f32.make_train_step(latent_da=jlda, donate=False)
    state = jax_train_state(bf16, params, stats)
    trainer = CooperativeTrainer(lda, compute_dtype=torch.bfloat16, device="cpu")
    out = []
    for key_seed in STEP_KEYS:
        key = jax.random.PRNGKey(key_seed)
        new16, m16 = step16(state, batch, key)
        new32, m32 = step32(state, batch, key)
        rec = {"before": _host(state), "bf16": _host(new16), "f32": _host(new32),
               "m16": _host(m16), "m32": _host(m32)}
        trainer.load_train_state(convert.train_state_from_jax(
            rec["before"].params, rec["before"].batch_stats, rec["before"].opt_state))
        draws = replay_draws(key, lda, BATCH, (HW, HW))
        rec["port_metrics"] = trainer.train_step(torch.from_numpy(image),
                                                 torch.from_numpy(label), draws)
        rec["port_moments"] = trainer.adam_moments()
        rec["port_state"] = {name: {k: v.clone() for k, v in getattr(trainer.model, name)
                                    .state_dict().items()} for name in MODULE_NAMES}
        out.append(rec)
        state = new16
    return out


def test_bf16_metrics(steps):
    """The 20 metrics of the two steps together (ten scalars per step are
    too few for a largest and a mean of their own)."""
    bf16_close_sets([(float(rec["port_metrics"][k]), rec["m16"][k], rec["m32"][k])
                 for rec in steps for k in rec["m16"]], "metrics")


def _ts(state):
    return convert.train_state_from_jax(state.params, state.batch_stats, state.opt_state)


@pytest.mark.parametrize("i", [0, 1])
def test_bf16_adam_moments(steps, i):
    rec = steps[i]
    got_mu, got_nu = rec["port_moments"]
    w16, w32 = _ts(rec["bf16"]), _ts(rec["f32"])
    for what, got, a16, a32 in (("mu", got_mu, w16.exp_avg, w32.exp_avg),
                                ("nu", got_nu, w16.exp_avg_sq, w32.exp_avg_sq)):
        bf16_close_sets([(got[name][k], a16[name][k], a32[name][k])
                     for name in a16 for k in a16[name]], what)


@pytest.mark.parametrize("i", [0, 1])
def test_bf16_update_and_running_stats(steps, i):
    rec = steps[i]
    before, w16, w32 = _ts(rec["before"]), _ts(rec["bf16"]), _ts(rec["f32"])
    for stats in (False, True):
        triples = []
        for name, sd in w16.state_dicts.items():
            for k, v in sd.items():
                if ("running_" in k) != stats:
                    continue
                old = 0 if stats else before.state_dicts[name][k].numpy()
                triples.append((rec["port_state"][name][k].numpy() - old, v.numpy() - old,
                                w32.state_dicts[name][k].numpy() - old))
        bf16_close_sets(triples, "running statistics" if stats else "update")


@pytest.fixture(scope="module")
def random_masks():
    """The masks JAX's bf16 generation and the port's bf16 step draw from
    the initial state under each step key, with their saliencies."""
    _, bf16, params, stats, image, label = _setup()
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    jlda, lda = step_configs("random")
    state = jax_train_state(bf16, params, stats)
    gen = jax.jit(lambda p, s, b, k: jax_generation(bf16, jlda, p, s, b, k))
    trainer = CooperativeTrainer(lda, compute_dtype=torch.bfloat16, device="cpu")
    start = convert.train_state_from_jax(params, stats, _host(state.opt_state))
    out = []
    for key_seed in STEP_KEYS:
        key = jax.random.PRNGKey(key_seed)
        trainer.load_train_state(start)
        draws = replay_draws(key, lda, BATCH, (HW, HW))
        trainer.train_step(torch.from_numpy(image), torch.from_numpy(label), draws)
        out.append((draws, dict(trainer.generation),
                    _host(gen(state.params, state.batch_stats, batch, key))))
    return out


def test_bf16_targeted_masks(random_masks):
    targeted = 0
    for draws, port, want in random_masks:
        for name in ("image", "shape"):
            branch = getattr(draws, name).branch
            got_mask = port[name].mask.permute(0, 2, 3, 1).numpy()
            want_mask, want_grad = want[name]
            if branch == 0:
                np.testing.assert_array_equal(got_mask, want_mask)
                continue
            targeted += 1
            n, h, w, c = want_mask.shape
            if branch == 2:
                g2d, w2d = got_mask[:, 0, 0, :], want_mask[:, 0, 0, :]
            else:
                g2d, w2d = got_mask[..., 0].reshape(n, h * w), want_mask[..., 0].reshape(n, h * w)
            assert_masks_agree(g2d, w2d, port[name].saliency.numpy(),
                               saliency_of(want_grad, branch), float(getattr(draws, name).p),
                               name)
    assert targeted >= 2  # the keys draw channel and spatial masking
