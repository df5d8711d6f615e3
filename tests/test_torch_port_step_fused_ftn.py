"""``CooperativeTrainer(fused_ftn=True)`` (the JAX package's ``FUSED_FTN``)
against the JAX package's fused FTN arm and against the port's
sequential step, and the fused arms' launch counts.

As ``test_torch_port_step_fused.py`` holds ``fused_stn`` (see its
docstring for the tolerances and why): JAX's
``make_train_step(fused_ftn=True)`` with the shape code on and off and
with and without ``separate_training`` (three of the four here, the
fourth in ``test_torch_port_step_fused_more.py``), one step on JAX's
replayed draws, float32, 32x32, batch 4; the nine losses at the JAX
tests' tolerances, gradients and statistics at the port's cross-framework
bounds.  The port takes JAX's fused order (a value-only encoder pre-pass
feeds generation, then the stacked 2N FTN pass, then the STN passes in
sequence), so it is held to JAX's fused arm, not to JAX's sequential step:
the pre-pass latents equal the standard half's only to f32 reordering.
"""

import pytest
import torch
import torch_port_fused_arms as F
from torch_port_util import one_torch_thread  # noqa: F401 - a fixture

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
    MaskConfig,
)
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
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)


@pytest.mark.parametrize("gen_seg,separate", [(True, False), (True, True), (False, False)])
def test_fused_ftn_matches_jax(gen_seg, separate):
    rec = F.run_fused_case("fused_ftn", gen_seg=gen_seg, separate=separate)
    F.check_fused_case(rec, f"fused_ftn gen_seg={gen_seg} separate={separate}")


SEQ_CASES = [
    (True, {}), (True, {"separate_training": True}), (False, {}),
    (False, {"separate_training": True}), (True, {"remat": True}),
    (True, {"saliency_bn_update": True}),
    (True, {"network_type": "FCN_16_standard_w_o_filter"}),
    (True, {"conv_s2": True, "conv_nl": True}),
]


@pytest.mark.parametrize("gen_seg,kw", SEQ_CASES)
def test_fused_ftn_matches_the_sequential_step(gen_seg, kw):
    """The JAX tests' tolerances of the fused FTN arm against the
    sequential step, on the port alone (with ``saliency_bn_update`` the
    decoders' statistics move in JAX's fused order: generation's first)."""
    seq = F.port_step(None, True, gen_seg, **kw)
    fused = F.port_step("fused_ftn", True, gen_seg, **kw)
    F.check_seq_and_fused("fused_ftn", seq, fused, f"{gen_seg} {kw}")


# ------------------------------------------------------- launch counts
@pytest.mark.parametrize("config", [
    {"fused_stn": True}, {"fused_stn": True, "separate_training": True},
    {"fused_stn": True, "remat": True, "conv_s2": True, "conv_nl": True},
    {"fused_ftn": True}, {"fused_ftn": True, "separate_training": True},
    {"fused_ftn": True, "remat": True, "conv_s2": True, "conv_nl": True},
    {"fused_ftn": True, "saliency_bn_update": True}])
def test_fused_launch_count_formula_matches_the_calls(monkeypatch, config):
    """``expected_launches`` counts what a fused step calls, for two
    branch pairs and with latent DA off: the wrappers' CPU calls stand in
    for launches (as in test_torch_port_step_variants.py)."""
    calls = {}
    for mod, name in ((conv_chw, "conv3x3_chw"), (conv_chw, "conv3x3_chw_dx"),
                      (conv_chw, "conv3x3_chw_dw"), (percentile_mask, "percentile_mask"),
                      (conv_s2, "conv3x3s2"), (conv_s2, "conv3x3s2_dx"),
                      (conv_s2, "conv3x3s2_dw"), (conv_nl, "conv3x3_nl"),
                      (conv_nl, "conv3x3_nl_dx"), (conv_nl, "conv3x3_nl_dw")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, fn=fn, name=name: (
            calls.__setitem__(name, calls.get(name, 0) + 1), fn(*a))[1])
    monkeypatch.setattr(masking, "percentile_mask", percentile_mask.percentile_mask)
    gen = torch.Generator().manual_seed(0)
    for lda in (LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                               shape_code=MaskConfig("ce", "spatial")),
                LatentDAConfig(image_code=MaskConfig("mse", "dropout"),
                               shape_code=MaskConfig("ce", "channel")), None):
        trainer = CooperativeTrainer(lda, device="cpu", **config)
        draws = draw_step(gen, 2, (32, 32), lda, **trainer.draw_kwargs())
        calls.clear()
        trainer.train_step(torch.rand(2, 32, 32, 1), torch.randint(0, 4, (2, 32, 32)), draws)
        branches = {k: getattr(draws, k).branch if getattr(draws, k) is not None else 0
                    for k in ("image", "shape")}
        want = trainer.expected_launches(branches)
        assert calls == {k: v for k, v in want.items() if v}, (config, lda)
