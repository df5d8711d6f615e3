"""The port's ``conv_s2=True`` train step against the JAX package's
``PALLAS_CONV_S2=1`` (the encoders' stride-2 downsamples on the phase
kernel, with CHW stage chaining), run in interpret mode on the CPU, at
32x32, batch 2, on shared weights: two cooperative train steps
(``mask_type="channel"`` on both codes, float32) on JAX's replayed draws.
Then one step of the port's ``conv_s2=True`` against its own default
route, and the K4 launch counts of a step.  ``predict(n_iter=2)`` under
the same configuration is held in tests/test_torch_port_predict_s2.py
(split from this file for time).

In NCHW the JAX package's stage chaining is a layout change only, so the
port changes the route of the downsample conv alone; these tests are what
shows that nothing else of the chained path differs.  The step is held as
tests/test_torch_port_step.py holds the default route's (its docstring
says why): metrics within 1e-4, masks equal or swapped only next to the
threshold, running statistics within 1e-4 of scale, Adam's moments and
the update against JAX's own sensitivity to a +-1e-6 move of its input.
"""

import jax
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    conv_chw,
    conv_s2,
    masking,
    percentile_mask,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture
    BATCH,
    HW,
    check_step_masks,
    check_step_metrics,
    check_step_moments_and_update,
    check_step_running_stats,
    make_solver,
    one_torch_thread,
    random_variables,
    replay_draws,
    run_step_case,
    step_configs,
)

MASK_TYPE = "channel"


@pytest.fixture(scope="module")
def case():
    return run_step_case(MASK_TYPE, conv_s2=True)


@pytest.mark.parametrize("i", [0, 1])
def test_metrics_match(case, i):
    check_step_metrics(case[i], f"S2 {MASK_TYPE} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_masks_match(case, i):
    check_step_masks(case[i], MASK_TYPE, f"S2 {MASK_TYPE} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_running_stats_match(case, i):
    check_step_running_stats(case[i], f"S2 {MASK_TYPE} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_adam_moments_and_update_match(case, i):
    check_step_moments_and_update(case[i], f"S2 {MASK_TYPE} step {i + 1}")


def test_step_s2_route_matches_default_route():
    """One f32 step of the port with ``conv_s2=True`` and with ``False``
    from the same weights and draws: metrics within 1e-4 of their value,
    running statistics within 1e-4 of scale."""
    solver = make_solver()
    sds = convert.from_jax(*random_variables(solver, seed=4))
    _, lda = step_configs(MASK_TYPE)
    draws = replay_draws(jax.random.PRNGKey(5), lda, BATCH, (HW, HW))
    rng = np.random.RandomState(6)
    image = torch.from_numpy(rng.uniform(0, 1, (BATCH, HW, HW, 1)).astype(np.float32))
    label = torch.from_numpy(rng.randint(0, 4, (BATCH, HW, HW)))
    out = {}
    for on in (False, True):
        trainer = CooperativeTrainer(lda, device="cpu", conv_s2=on)
        trainer.model.load_state_dicts(sds)
        metrics = trainer.train_step(image, label, draws)
        out[on] = metrics, trainer.model.state_dict()
    for k, w in out[False][0].items():
        assert abs(float(out[True][0][k]) - float(w)) <= 1e-4 * abs(float(w)) + 1e-7, k
    for k, w in out[False][1].items():
        if "running_" in k:
            torch.testing.assert_close(out[True][1][k], w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()), msg=k)


def test_launch_count_formula_matches_the_calls(monkeypatch):
    """``expected_launches`` with ``conv_s2=True`` counts what a step calls,
    per branch pair (the wrappers' CPU calls stand in for launches): two K4
    convs per encoder pass, each with K4dx and K4dw, so 12 of each with
    both codes on; K1's counts stay as the default route's."""
    calls = {}
    for mod, name in ((conv_chw, "conv3x3_chw"), (conv_chw, "conv3x3_chw_dx"),
                      (conv_chw, "conv3x3_chw_dw"), (conv_s2, "conv3x3s2"),
                      (conv_s2, "conv3x3s2_dx"), (conv_s2, "conv3x3s2_dw"),
                      (percentile_mask, "percentile_mask")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: (
            calls.__setitem__(name, calls.get(name, 0) + 1), fn(*a))[1])
    monkeypatch.setattr(masking, "percentile_mask", percentile_mask.percentile_mask)
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
        LatentDAConfig,
        MaskConfig,
    )

    for image_type, shape_type in (("dropout", "spatial"), ("channel", "channel")):
        lda = LatentDAConfig(image_code=MaskConfig("mse", image_type),
                             shape_code=MaskConfig("ce", shape_type))
        trainer = CooperativeTrainer(lda, device="cpu", conv_s2=True)
        draws = replay_draws(jax.random.PRNGKey(0), lda, 2, (32, 32))
        calls.clear()
        trainer.train_step(torch.rand(2, 32, 32, 1), torch.randint(0, 4, (2, 32, 32)), draws)
        want = trainer.expected_launches({"image": draws.image.branch,
                                          "shape": draws.shape.branch})
        assert calls == {k: v for k, v in want.items() if v}, (image_type, shape_type)
    branches = {"image": 1, "shape": 2}
    s2 = CooperativeTrainer(LatentDAConfig(), device="cpu", conv_s2=True)
    default = CooperativeTrainer(LatentDAConfig(), device="cpu")
    assert s2.expected_launches(branches) == {
        "conv3x3_chw": 120, "conv3x3_chw_dx": 102, "conv3x3_chw_dw": 92,
        "percentile_mask": 2, "conv3x3s2": 12, "conv3x3s2_dx": 12, "conv3x3s2_dw": 12,
        "conv3x3_nl": 0, "conv3x3_nl_dx": 0, "conv3x3_nl_dw": 0}
    assert default.expected_launches(branches) == {
        **s2.expected_launches(branches), "conv3x3s2": 0, "conv3x3s2_dx": 0,
        "conv3x3s2_dw": 0}
    plain = CooperativeTrainer(None, device="cpu", conv_s2=True)
    assert plain.expected_launches({})["conv3x3s2"] == 6
