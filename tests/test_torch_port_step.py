"""The port's cooperative train step against the JAX package's
``CooperativeTripletSolver.make_train_step(donate=False)``, float32, on the
CPU, two steps in a row, at 32x32, batch 2: ``mask_type`` dropout and
spatial here, channel and random in test_torch_port_step_random.py (each
mask type compiles a JAX step of its own, so they are split for time).

Both packages start each step from the same state: step 1 from shared
initial weights, step 2 from JAX's state after step 1, carried into the
port by ``convert.train_state_from_jax`` (Adam's moments and count
included).  The draws are JAX's, replayed from its keys.  The JAX side runs
its stock conv route (the plain reference; the Pallas semantics of K1's
gradients are held in tests/test_torch_port_grad.py).

What is held (torch_port_util.check_step_*), and why so:

* metrics: within 1e-4 of their value;
* the masks each code drew: equal, or swapped only where the two
  saliencies lie within their f32 difference of the threshold;
* running statistics: within 1e-4 of each tensor's scale (up to 40 layers
  of f32 forward; JAX's own deepest variances move by 6e-6 of their scale
  when its input moves by 1e-6);
* Adam's ``mu`` and ``nu`` and the update ``p_new - p_old``: within 1e-3
  of the tensor's norm, or twice what JAX's own move when its input image
  moves by +-1e-6 of each pixel (the largest of six such moves; the
  port's latents lie closer to JAX's than these moves put them),
  whichever is larger.  This step's gradient is not continuous at f32
  rounding: with 2x2 to 8x8 maps at batch 2, each weight gradient of a
  deep layer sums 8 to 128 terms, and a LeakyReLU or ReLU whose input sits
  within rounding of 0 takes the other slope.  Moving JAX's input image by
  1e-7 of itself moves JAX's own ``mu`` by up to 2 % of a tensor's largest
  magnitude (0.7 % in the Frobenius norm), so no fixed 1e-3 bound can hold
  for it, JAX against JAX.  The exact gradients of each op (K1's dx, K2,
  BatchNorm, LeakyReLU) are held tightly in test_torch_port_grad.py and
  test_torch_port_masking.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
    MaskConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    conv_chw,
    percentile_mask,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture
    check_step_masks,
    check_step_metrics,
    check_step_moments_and_update,
    check_step_running_stats,
    jax_train_state,
    make_solver,
    one_torch_thread,
    random_variables,
    replay_draws,
    run_step_case,
)


@pytest.fixture(scope="module", params=["dropout", "spatial"])
def case(request):
    return request.param, run_step_case(request.param)


@pytest.mark.parametrize("i", [0, 1])
def test_metrics_match(case, i):
    mask_type, steps = case
    check_step_metrics(steps[i], f"{mask_type} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_masks_match(case, i):
    mask_type, steps = case
    check_step_masks(steps[i], mask_type, f"{mask_type} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_running_stats_match(case, i):
    mask_type, steps = case
    check_step_running_stats(steps[i], f"{mask_type} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_adam_moments_and_update_match(case, i):
    mask_type, steps = case
    check_step_moments_and_update(steps[i], f"{mask_type} step {i + 1}")


def test_launch_count_formula_matches_the_calls(monkeypatch):
    """``expected_launches`` counts what a step calls, per branch pair: the
    wrappers' CPU calls stand in for launches."""
    calls = {}
    for mod, name in ((conv_chw, "conv3x3_chw"), (conv_chw, "conv3x3_chw_dx"),
                      (conv_chw, "conv3x3_chw_dw"), (percentile_mask, "percentile_mask")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: (
            calls.__setitem__(name, calls.get(name, 0) + 1), fn(*a))[1])
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import masking
    monkeypatch.setattr(masking, "percentile_mask", percentile_mask.percentile_mask)
    for image_type, shape_type in (("dropout", "spatial"), ("channel", "channel"),
                                   ("spatial", "dropout")):
        lda = LatentDAConfig(image_code=MaskConfig("mse", image_type),
                             shape_code=MaskConfig("ce", shape_type))
        trainer = CooperativeTrainer(lda, device="cpu")
        draws = replay_draws(jax.random.PRNGKey(0), lda, 2, (32, 32))
        calls.clear()
        trainer.train_step(torch.rand(2, 32, 32, 1), torch.randint(0, 4, (2, 32, 32)), draws)
        want = trainer.expected_launches({"image": draws.image.branch,
                                          "shape": draws.shape.branch})
        assert calls == {k: v for k, v in want.items() if v}, (image_type, shape_type)
    assert CooperativeTrainer(LatentDAConfig(), device="cpu").expected_launches(
        {"image": 1, "shape": 2}) == {"conv3x3_chw": 120, "conv3x3_chw_dx": 102,
                                      "conv3x3_chw_dw": 92, "percentile_mask": 2,
                                      "conv3x3s2": 0, "conv3x3s2_dx": 0, "conv3x3s2_dw": 0,
                                      "conv3x3_nl": 0, "conv3x3_nl_dx": 0, "conv3x3_nl_dw": 0}


def test_train_state_round_trip():
    """``train_state_from_jax`` carries parameters, running statistics and
    Adam's moments and count into the trainer."""
    solver = make_solver()
    params, stats = random_variables(solver, seed=0)
    state = jax_train_state(solver, params, stats)
    rng = np.random.RandomState(4)
    mu = jax.tree.map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32), state.params)
    nu = jax.tree.map(lambda a: jnp.asarray(rng.rand(*a.shape), jnp.float32), state.params)
    opt = (state.opt_state[0]._replace(count=jnp.asarray(3), mu=mu, nu=nu),) + state.opt_state[1:]
    ts = convert.train_state_from_jax(params, stats, opt)
    assert ts.step == 3
    trainer = CooperativeTrainer(None, device="cpu")
    trainer.load_train_state(ts)
    got_mu, got_nu = trainer.adam_moments()
    want_mu = convert.from_jax(mu, stats)
    for name, sd in got_mu.items():
        for k, v in sd.items():
            torch.testing.assert_close(v, want_mu[name][k], rtol=0, atol=0)
    assert all(float(st["step"]) == 3 for st in trainer.optimizer.state.values())
    for name, sd in convert.from_jax(params, stats).items():
        got = getattr(trainer.model, name).state_dict()
        for k, v in sd.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    assert sum(len(sd) for sd in got_nu.values()) == sum(1 for _ in trainer.model.parameters())
