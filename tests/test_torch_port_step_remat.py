"""The cooperative step with ``remat`` (each module forward rematerialised
in the backward by ``torch.utils.checkpoint``, the recompute with BN
statistics frozen) against the JAX package's ``remat=True``, and against
the port's own step without it: parameters, gradients and running
statistics within 1e-6 of each tensor's scale (the recompute runs the same
float32 ops again; the BN statistics must move once), and the launches the
trainer expects on the card grow by the recompute's forwards only.

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
"""

import pytest
import torch
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture, test_variant_* are tests
    BATCH,
    HW,
    _data,
    one_torch_thread,
    random_variables,
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
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)


@pytest.fixture(scope="module", params=['remat'])
def variant(request):
    return request.param, run_variant(request.param)


def test_remat_equals_the_step_without_it():
    """Two port steps with and without ``remat`` from the same weights on
    the same draws: every parameter, gradient and running statistic
    within 1e-6 of the tensor's largest magnitude; and the launches the
    trainer expects on the card grow by the recompute's K1 forwards only."""
    solver = CooperativeTripletSolver(input_hw=(HW, HW))
    params, stats = random_variables(solver, seed=0)
    image, label, _ = _data()
    _, lda = step_configs("random")
    runs = []
    for remat in (False, True):
        trainer = CooperativeTrainer(lda, device="cpu", remat=remat)
        trainer.model.load_state_dicts(convert.from_jax(params, stats))
        gen = torch.Generator().manual_seed(3)
        grads = []
        for _ in range(2):
            draws = draw_step(gen, BATCH, (HW, HW), lda)
            trainer.train_step(torch.from_numpy(image), torch.from_numpy(label), draws)
            grads.append({k: p.grad.clone() for k, p in trainer.model.named_parameters()})
        runs.append((trainer.model.state_dict(), grads, trainer))
    (sd0, g0, t0), (sd1, g1, t1) = runs
    for k, v in sd0.items():
        torch.testing.assert_close(sd1[k], v, rtol=0, atol=1e-6 * float(v.abs().max()) + 1e-12,
                                   msg=k)
    for a, b in zip(g0, g1):
        for k, v in a.items():
            torch.testing.assert_close(b[k], v, rtol=0, atol=1e-6 * float(v.abs().max()) + 1e-12,
                                       msg=k)
    base, more = t0.expected_launches({"image": 1, "shape": 2}), \
        t1.expected_launches({"image": 1, "shape": 2})
    assert more["conv3x3_chw"] == base["conv3x3_chw"] + base["conv3x3_chw_dw"]
    assert {k: v for k, v in more.items() if k != "conv3x3_chw"} == \
        {k: v for k, v in base.items() if k != "conv3x3_chw"}
