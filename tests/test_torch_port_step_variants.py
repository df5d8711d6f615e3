"""The cooperative step's network types against the JAX package's:
``FCN_16_standard_share_code`` (z_i := z_s, the image decoded from the
filtered code) and ``FCN_16_standard_w_o_filter`` (z_s := z_i, segmented
from the unfiltered code; the code decoupler gets zero gradients, and Adam
zero moments, as in optax).

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

Then the step's ops' remaining branches (``construct_input``'s label
smoothing and image concatenation, ``cross_entropy_2d``'s class weights and
soft targets) against the JAX package's, and ``cli.train`` accepting every
configuration (with layer dropout and remat together it trains an epoch).
The other configurations: test_torch_port_step_separate.py,
test_torch_port_step_dropout.py, test_torch_port_step_remat.py.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture, test_variant_* are tests
    DROPOUT,
    one_torch_thread,
    run_variant,
    test_variant_masks_match_jax,
    test_variant_metrics_match_jax,
    test_variant_moments_and_update_match_jax,
    test_variant_running_stats_match_jax,
)

from cooperative_training_and_latent_space_data_augmentation_tpu.ops import image as JI
from cooperative_training_and_latent_space_data_augmentation_tpu.ops import losses as JL
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (
    MODULE_NAMES,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import train as cli
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
    MaskConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import image as I
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import losses as L
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    masking,
    percentile_mask,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)


@pytest.fixture(scope="module", params=['share_code', 'w_o_filter'])
def variant(request):
    return request.param, run_variant(request.param)


# ------------------------------------------------------- launch counts
@pytest.mark.parametrize("config", [
    {"separate_training": True}, {"network_type": "FCN_16_standard_share_code"},
    {"network_type": "FCN_16_standard_w_o_filter"}, DROPOUT, {"remat": True},
    {"saliency_bn_update": True}])
def test_launch_count_formula_matches_the_calls(monkeypatch, config):
    """``expected_launches`` counts what a step of each configuration
    calls, for three branch pairs: the wrappers' CPU calls stand in for
    launches (as in test_torch_port_step.py)."""
    calls = {}
    for mod, name in ((conv_chw, "conv3x3_chw"), (conv_chw, "conv3x3_chw_dx"),
                      (conv_chw, "conv3x3_chw_dw"), (percentile_mask, "percentile_mask")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: (
            calls.__setitem__(name, calls.get(name, 0) + 1), fn(*a))[1])
    monkeypatch.setattr(masking, "percentile_mask", percentile_mask.percentile_mask)
    gen = torch.Generator().manual_seed(0)
    for image_type, shape_type in (("dropout", "spatial"), ("channel", "channel"),
                                   ("spatial", "dropout")):
        lda = LatentDAConfig(image_code=MaskConfig("mse", image_type),
                             shape_code=MaskConfig("ce", shape_type))
        trainer = CooperativeTrainer(lda, device="cpu", **config)
        draws = draw_step(gen, 2, (32, 32), lda, **trainer.draw_kwargs())
        calls.clear()
        trainer.train_step(torch.rand(2, 32, 32, 1), torch.randint(0, 4, (2, 32, 32)), draws)
        want = trainer.expected_launches({"image": draws.image.branch,
                                          "shape": draws.shape.branch})
        assert calls == {k: v for k, v in want.items() if v}, (config, image_type, shape_type)


# ------------------------------------------------------- the ops' branches
def _logits(shape, seed):
    return np.random.RandomState(seed).normal(0, 2, shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def test_construct_input_branches_match_jax():
    """Label smoothing (its strength from the same uniform draw), the image
    concatenation, and the logits branch without softmax: within 1e-6."""
    labels = np.random.RandomState(0).randint(0, 4, (2, 8, 8)).astype(np.int32)
    image = np.random.RandomState(1).uniform(size=(2, 8, 8, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = JI.construct_input(jnp.asarray(labels), num_classes=4, apply_softmax=False,
                              is_labelmap=True, smooth_label=True, rng=key,
                              image=jnp.asarray(image))
    alpha = torch.from_numpy(np.asarray(jax.random.uniform(key, ()))) * 0.1
    got = I.construct_input(torch.from_numpy(labels), num_classes=4, apply_softmax=False,
                            is_labelmap=True, smooth_alpha=alpha, image=_nchw(image))
    np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1), atol=1e-6)
    logits = _logits((2, 8, 8, 4), 2)
    for soft in (True, False):
        want = JI.construct_input(jnp.asarray(logits), apply_softmax=soft, temperature=2.0)
        got = I.construct_input(_nchw(logits), 2.0, apply_softmax=soft)
        np.testing.assert_allclose(got.numpy(), np.moveaxis(np.asarray(want), -1, 1), atol=1e-6)
    alpha = I.draw_smooth_alpha(torch.Generator().manual_seed(0))
    assert alpha.shape == () and 0 <= float(alpha) < 0.1


@pytest.mark.parametrize("weight", [None, (1.0, 2.0, 0.5, 3.0)])
@pytest.mark.parametrize("soft,size_average", [(False, True), (False, False), (True, True)])
def test_cross_entropy_branches_match_jax(weight, soft, size_average):
    """Hard labels (mean and sum) and soft (logit) targets, with and
    without class weights: within 1e-5 of JAX's value, relative
    (``size_average`` reaches the hard-label branch only)."""
    logits = _logits((2, 8, 8, 4), 3)
    target = (_logits((2, 8, 8, 4), 4) if soft
              else np.random.RandomState(5).randint(0, 4, (2, 8, 8)).astype(np.int32))
    want = float(JL.cross_entropy_2d(jnp.asarray(logits), jnp.asarray(target), weight=weight,
                                     size_average=size_average))
    t = _nchw(target) if soft else torch.from_numpy(target)
    got = float(L.cross_entropy_2d(_nchw(logits), t, weight=weight, size_average=size_average))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


# ------------------------------------------------------------- the entry
@pytest.mark.parametrize("overrides,flags,check", [
    ({"segmentation_model": {"network_type": "FCN_16_standard_share_code"}}, [],
     lambda t: t.model.network_type == "FCN_16_standard_share_code"),
    ({"segmentation_model": {"network_type": "FCN_16_standard_w_o_filter"}}, [],
     lambda t: t.model.network_type == "FCN_16_standard_w_o_filter"),
    ({"segmentation_model": DROPOUT}, [],
     lambda t: set(t.dropout_sites) == set(MODULE_NAMES)),
    ({"learning": {"separate_training": True}}, [], lambda t: t.separate_training),
    ({}, ["--remat"], lambda t: t.remat),
    ({}, ["--saliency_bn_update"], lambda t: t.saliency_bn_update),
])
def test_cli_accepts_each_configuration(tmp_path, overrides, flags, check):
    """``cli.train`` builds each configuration's trainer from a JSON file
    and its flags; with layer dropout and remat together it also trains an
    epoch on the CPU (small phantoms)."""
    cfg = {"data": {"pad_size": [40, 40, 1], "crop_size": [32, 32, 1]},
           "learning": {"batch_size": 4}}
    for section, values in overrides.items():
        cfg.setdefault(section, {}).update(values)
    path = tmp_path / "variant.json"
    path.write_text(json.dumps(cfg))
    args = cli.parse_args(["--json_config_path", str(path), "--device", "cpu", "--synthetic",
                           "--synthetic_train_length", "2", "--synthetic_val_length", "2",
                           "--max_epochs", "1", "--save_dir", str(tmp_path / "runs"), *flags])
    conf, name = cli.load_config(args)
    trainer = cli.build_trainer(conf, args)
    assert check(trainer)
    if overrides.get("segmentation_model") == DROPOUT:
        args.remat = True
        trainer, result = cli.run(args, conf, name)
        assert trainer.remat and len(result.epochs) == 1
        assert np.isfinite(result.epochs[0].losses).all()
