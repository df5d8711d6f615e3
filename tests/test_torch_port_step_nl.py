"""The port's ``conv_nl=True`` train step against the JAX package's
``PALLAS_CONV_NL=1`` (the NL-sublanes kernel on the large-channel 3x3 convs
of the encoders' last two stages and the decoders' first), run in interpret
mode on the CPU, at 32x32, batch 2, on shared weights: one cooperative
train step (``mask_type="channel"`` on both codes, float32) on JAX's
replayed draws.  Then one step of the port's ``conv_nl=True`` against its
own default route, and the K5 launch counts of a step.
``predict(n_iter=2)`` under the same configuration is held in
tests/test_torch_port_predict_nl.py.

JAX runs with ``PALLAS_CONV_MAX_CH=0``: its CHW kernel then leaves the
<=64-channel convs to XLA instead of interpreting each of them (the step
would take several times longer to compile), and its NL kernel, which this
file is about, still runs in interpret mode on every conv it takes.  In
float32 the CHW kernel and XLA's conv compute the same function (the CHW
kernel is held against JAX on its own in tests/test_torch_port_grad.py),
and the port keeps running K1's plain version on those convs.

The step is held as tests/test_torch_port_step.py holds the default
route's (its docstring says why): metrics within 1e-4, masks equal or
swapped only next to the threshold, running statistics within 1e-4 of
scale, Adam's moments and the update against JAX's own sensitivity to a
+-1e-6 move of its input.
"""

import jax
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    conv_chw,
    conv_nl,
    conv_s2,
    masking,
    percentile_mask,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from torch_port_util import (
    BATCH,
    HW,
    check_step_masks,
    check_step_metrics,
    check_step_moments_and_update,
    check_step_running_stats,
    make_solver,
    random_variables,
    replay_draws,
    run_step_case,
    step_configs,
)

MASK_TYPE = "channel"
WHAT = f"NL {MASK_TYPE} step 1"


@pytest.fixture(scope="module")
def case():
    return run_step_case(MASK_TYPE, conv_nl=True, keys=(11,), max_ch=0)


def test_metrics_match(case):
    check_step_metrics(case[0], WHAT)


def test_masks_match(case):
    check_step_masks(case[0], MASK_TYPE, WHAT)


def test_running_stats_match(case):
    check_step_running_stats(case[0], WHAT)


def test_adam_moments_and_update_match(case):
    check_step_moments_and_update(case[0], WHAT)


def test_step_nl_route_matches_default_route():
    """One f32 step of the port with ``conv_nl=True`` and with ``False``
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
        trainer = CooperativeTrainer(lda, device="cpu", conv_nl=on)
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
    """``expected_launches`` with ``conv_nl=True`` counts what a step calls,
    per branch pair (the wrappers' CPU calls stand in for launches): four K5
    convs per encoder pass and one per decoder pass, none in the code
    decoupler; every K5 conv launches dx wherever it runs in the loss graph.
    K1's counts stay as the default route's; with ``conv_s2`` too, K4's
    stay as ``conv_s2``'s."""
    calls = {}
    for mod, name in ((conv_chw, "conv3x3_chw"), (conv_chw, "conv3x3_chw_dx"),
                      (conv_chw, "conv3x3_chw_dw"), (conv_s2, "conv3x3s2"),
                      (conv_s2, "conv3x3s2_dx"), (conv_s2, "conv3x3s2_dw"),
                      (conv_nl, "conv3x3_nl"), (conv_nl, "conv3x3_nl_dx"),
                      (conv_nl, "conv3x3_nl_dw"), (percentile_mask, "percentile_mask")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: (
            calls.__setitem__(name, calls.get(name, 0) + 1), fn(*a))[1])
    monkeypatch.setattr(masking, "percentile_mask", percentile_mask.percentile_mask)
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
        LatentDAConfig,
        MaskConfig,
    )

    for image_type, shape_type, s2 in (("dropout", "spatial", False),
                                       ("channel", "dropout", True)):
        lda = LatentDAConfig(image_code=MaskConfig("mse", image_type),
                             shape_code=MaskConfig("ce", shape_type))
        trainer = CooperativeTrainer(lda, device="cpu", conv_nl=True, conv_s2=s2)
        draws = replay_draws(jax.random.PRNGKey(0), lda, 2, (32, 32))
        calls.clear()
        trainer.train_step(torch.rand(2, 32, 32, 1), torch.randint(0, 4, (2, 32, 32)), draws)
        want = trainer.expected_launches({"image": draws.image.branch,
                                          "shape": draws.shape.branch})
        assert calls == {k: v for k, v in want.items() if v}, (image_type, shape_type)
    nl = CooperativeTrainer(LatentDAConfig(), device="cpu", conv_nl=True)
    default = CooperativeTrainer(LatentDAConfig(), device="cpu")
    for branches, k5 in (({"image": 0, "shape": 0}, (34, 32, 32)),
                         ({"image": 1, "shape": 2}, (36, 34, 32)),
                         ({"image": 2, "shape": 0}, (35, 33, 32))):
        assert nl.expected_launches(branches) == {
            **default.expected_launches(branches),
            "conv3x3_nl": k5[0], "conv3x3_nl_dx": k5[1], "conv3x3_nl_dw": k5[2]}
    plain = CooperativeTrainer(None, device="cpu", conv_nl=True)
    assert plain.expected_launches({})["conv3x3_nl"] == 16
