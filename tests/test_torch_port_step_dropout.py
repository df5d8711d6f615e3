"""The cooperative step with layer dropout (``encoder_dropout`` 0.3,
``decoder_dropout`` 0.2) against the JAX package's.  JAX's keep masks are
recorded in the order its step runs them
(``torch_port_util.record_jax_dropout``) and replayed into
``StepDraws.dropout``; the port must use exactly as many, the count of its
forward plan (``train.draws.forward_plan``: 4 masks a module forward).
JAX's generation cannot be recomputed outside its step with its dropout
stream, so the masks of generation are held through the hard losses.

Each configuration against the JAX package's on the CPU at 32x32, batch
2, latent DA ``mask_type="random"`` on both codes (the main path's), two
steps (``STEP_KEYS``), each port step from JAX's state before it on JAX's
draws, by ``torch_port_util``'s ``test_variant_*`` checks at the step
files' float32 tolerances: metrics within 1e-4 of their value (the four
hard losses only at steps whose generation masks equal JAX's, the loop
test's rule: a swap near the threshold makes another hard example),
running statistics within 1e-4 of each tensor's scale, Adam's moments and
the update within ``check_step_moments_and_update``'s sensitivity bound,
the generation masks as ``check_step_masks`` holds them, and the number
of dropout masks used.

One bf16 case (``share_code`` with layer dropout and
``separate_training``, latent ``mask_type="dropout"`` so that no saliency
threshold decides a mask) is held to twice JAX's own bf16 error over each
whole set (metrics of both steps; each step's updates; its running
statistics), as test_torch_port_step_bf16.py holds the main path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture, test_variant_* are tests
    BATCH,
    DROPOUT,
    HW,
    STEP_KEYS,
    _data,
    _port_state,
    bf16_close_sets,
    jax_train_state,
    one_torch_thread,
    random_variables,
    record_jax_dropout,
    replay_draws,
    run_variant,
    step_configs,
    test_variant_masks_match_jax,
    test_variant_metrics_match_jax,
    test_variant_moments_and_update_match_jax,
    test_variant_running_stats_match_jax,
)

from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)


@pytest.fixture(scope="module", params=['dropout'])
def variant(request):
    return request.param, run_variant(request.param)


def _host(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def bf16_steps():
    kw = {"network_type": "FCN_16_standard_share_code", **DROPOUT}
    with record_jax_dropout() as recorded:
        f32 = CooperativeTripletSolver(input_hw=(HW, HW), **kw)
        b16 = CooperativeTripletSolver(input_hw=(HW, HW), compute_dtype=jnp.bfloat16, **kw)
        params, stats = random_variables(f32, seed=0)
        image, label, _ = _data()
        batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
        jlda, lda = step_configs("dropout")
        step16 = b16.make_train_step(latent_da=jlda, donate=False, separate_training=True)
        step32 = f32.make_train_step(latent_da=jlda, donate=False, separate_training=True)
        state = jax_train_state(b16, params, stats)
        trainer = CooperativeTrainer(lda, compute_dtype=torch.bfloat16, device="cpu",
                                     separate_training=True, **kw)
        out = []
        for key_seed in STEP_KEYS:
            key = jax.random.PRNGKey(key_seed)
            recorded.clear()
            new16, m16 = step16(state, batch, key)
            jax.effects_barrier()
            masks = list(recorded)
            recorded.clear()
            new32, m32 = step32(state, batch, key)
            jax.effects_barrier()
            assert all(np.array_equal(a, b) for a, b in zip(masks, recorded))
            rec = {"before": _host(state), "bf16": _host(new16), "f32": _host(new32),
                   "m16": _host(m16), "m32": _host(m32)}
            trainer.load_train_state(convert.train_state_from_jax(
                rec["before"].params, rec["before"].batch_stats, rec["before"].opt_state))
            draws = replay_draws(key, lda, BATCH, (HW, HW), dropout=masks)
            rec["port_metrics"] = trainer.train_step(torch.from_numpy(image),
                                                     torch.from_numpy(label), draws)
            rec["port_state"] = _port_state(trainer)
            out.append(rec)
            state = new16
    return out


def test_bf16_variant_matches_jax(bf16_steps):
    bf16_close_sets([(float(rec["port_metrics"][k]), rec["m16"][k], rec["m32"][k])
                 for rec in bf16_steps for k in rec["m16"]], "metrics")
    for rec in bf16_steps:
        ts = [convert.train_state_from_jax(s.params, s.batch_stats, s.opt_state)
              for s in (rec["before"], rec["bf16"], rec["f32"])]
        for stats in (False, True):
            triples = []
            for name, sd in ts[1].state_dicts.items():
                for k, v in sd.items():
                    if ("running_" in k) != stats:
                        continue
                    old = 0 if stats else ts[0].state_dicts[name][k].numpy()
                    triples.append((rec["port_state"][name][k].numpy() - old, v.numpy() - old,
                                    ts[2].state_dicts[name][k].numpy() - old))
            bf16_close_sets(triples, "running statistics" if stats else "update")
