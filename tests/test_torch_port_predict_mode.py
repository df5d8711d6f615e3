"""``predict`` and ``slow_refinement`` compute in eval mode whatever mode
the modules are in, as the JAX package always predicts with
``train=False``: on a model in train mode (as ``CooperativeTrainer`` keeps
it) they give the eval-mode result, leave every BatchNorm buffer bit for
bit as it was, and give each module its own mode back, also when the call
raises.
"""

import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)


def _model(conv_s2):
    """A predictor with moved running statistics (so batch and running
    statistics differ), modules in mixed modes."""
    model = CooperativePredictor(device="cpu", seed=3, conv_s2=conv_s2)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return model


def _snapshot(model):
    return ({k: v.clone() for k, v in model.named_buffers()},
            {name: m.training for name, m in model.named_modules()})


def _assert_unchanged(model, snapshot):
    buffers, modes = snapshot
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    assert {name: m.training for name, m in model.named_modules()} == modes


X = torch.rand((2, 32, 32, 1), generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("conv_s2", [False, True])
@pytest.mark.parametrize("n_iter,softmax", [(1, False), (2, False), (2, True)])
def test_predict_in_train_mode_equals_eval_mode(conv_s2, n_iter, softmax):
    model = _model(conv_s2)
    want = model.eval().predict(X, n_iter=n_iter, softmax=softmax)
    model.train()
    model.shape_decoder.eval()            # modes are restored module by module
    before = _snapshot(model)
    got = model.predict(X, n_iter=n_iter, softmax=softmax)
    assert torch.equal(got, want)
    _assert_unchanged(model, before)


@pytest.mark.parametrize("conv_s2", [False, True])
@pytest.mark.parametrize("n_steps,auto_stop,tol", [(1, False, 1e-4), (2, True, 1e-4),
                                                   (2, True, 1e3)])
def test_slow_refinement_in_train_mode_equals_eval_mode(conv_s2, n_steps, auto_stop, tol):
    model = _model(conv_s2)
    logits = torch.randn((2, 32, 32, 4), generator=torch.Generator().manual_seed(2))
    want, want_int = model.eval().slow_refinement(logits, n_steps, auto_stop, tol,
                                                  save_internal_predicts=True)
    model.train()
    before = _snapshot(model)
    got, got_int = model.slow_refinement(logits, n_steps, auto_stop, tol,
                                         save_internal_predicts=True)
    assert torch.equal(got, want)
    assert sorted(got_int) == sorted(want_int)
    for k in got_int:
        assert torch.equal(got_int[k][0], want_int[k][0])
    _assert_unchanged(model, before)


def test_modes_come_back_when_the_call_raises():
    model = _model(False).train()
    model.image_encoder.code_decoupler.eval()
    before = _snapshot(model)
    with pytest.raises(ValueError):                  # 3 channels: the encoder takes 1
        model.predict(torch.rand(2, 32, 32, 3))
    _assert_unchanged(model, before)


def test_trainer_predict_leaves_its_statistics_and_mode():
    """The trainer keeps its model in train mode; predicting from it (as a
    validation pass does) is the eval-mode prediction and the step that
    follows still updates the statistics."""
    trainer = CooperativeTrainer(LatentDAConfig(), device="cpu", seed=0)
    before = _snapshot(trainer.model)
    got = trainer.model.predict(X, n_iter=2)
    _assert_unchanged(trainer.model, before)
    assert all(m.training for m in trainer.model.modules())
    eval_copy = CooperativePredictor(device="cpu", seed=0)
    eval_copy.load_state_dict(trainer.model.state_dict())
    assert torch.equal(got, eval_copy.predict(X, n_iter=2))
