"""The cooperative step's fused pass arms, ``CooperativeTrainer(fused_stn=True)``
and ``(fused_ftn=True)`` (the JAX package's ``make_train_step(fused_stn=,
fused_ftn=)``, its ``FUSED_STN``/``FUSED_FTN``), against the JAX package's
fused arms and against the port's own sequential step.

Against JAX (``torch_port_fused_arms.run_fused_case``): one step from the same
weights on JAX's replayed draws, float32, 32x32, batch 4, latent DA
``mask_type="random"``.  The parametrisation mirrors
``tests/test_cooperative.py:312-430``: ``fused_stn`` with and without
latent DA and ``separate_training`` (this file: three of the four;
``test_torch_port_step_fused_more.py`` the fourth), ``fused_ftn`` with and
without the shape code and ``separate_training``
(``test_torch_port_step_fused_ftn.py``: three of the four;
``..._more.py`` the fourth and one ``remat`` case).  Each JAX step
compiles in about 25 s, hence three a file.  Held: the nine losses at
those JAX tests' tolerances (rtol 2e-5, atol 1e-6; measured 2e-6 at
most), which also shows that generation made JAX's hard examples.  The
gradients and the BN running statistics are held at the bounds with
which the port's step files hold its sequential step to JAX's, because
the JAX tests' own gradient and statistics tolerances hold within one
framework only: on these weights JAX's sequential step and the port's
part by 1.08x the JAX tests' loosest gradient tolerance (the FTN batch's
8e-4 gmax floor) and by 2x their statistics tolerance, and the port's
fused arms part from JAX's fused arms by the same amounts (1.084x,
1.082x), while JAX's own fused STN arm parts from its sequential step by
2.6x its 1e-5 gmax floor here.  So gradients per tensor within 1e-3 of
their norm or twice JAX's own move under small input moves
(``check_step_moments_and_update``'s bound on Adam's first moment, which
is 0.1 of the gradient after one step), statistics within 1e-4 of each
tensor's largest element (``check_step_running_stats``).

Against the port's sequential step (``check_seq_and_fused``), in every
configuration the arm runs in, including ``remat``, ``saliency_bn_update``
and ``conv_s2``/``conv_nl``: the JAX tests' own tolerances, losses, every
gradient and every running statistic (``fused_stn`` here, ``fused_ftn`` in
``..._fused_ftn.py``).

Then the gates (JAX's ``test_fused_ftn_gates`` and ``make_train_step``'s
rules) and the stacked BatchNorm against P sequential BatchNorms; the
launch counts are in ``..._fused_ftn.py``.
"""

import contextlib

import pytest
import torch
import torch_port_fused_arms as F
from torch_port_util import DROPOUT, one_torch_thread  # noqa: F401 - a fixture

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BatchNorm,
    frozen_stats,
    stacked_flags,
    stacked_passes,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)


# --------------------------------------------------------- against JAX
@pytest.mark.parametrize("lda_on,separate", [(True, False), (True, True), (False, False)])
def test_fused_stn_matches_jax(lda_on, separate):
    rec = F.run_fused_case("fused_stn", lda_on=lda_on, separate=separate)
    F.check_fused_case(rec, f"fused_stn latent_da={lda_on} separate={separate}")


# ------------------------------------- against the port's sequential step
SEQ_CASES = [
    (True, True, {}), (True, True, {"separate_training": True}), (False, True, {}),
    (False, True, {"separate_training": True}), (True, True, {"remat": True}),
    (True, True, {"saliency_bn_update": True}),
    (True, True, {"network_type": "FCN_16_standard_share_code"}),
    (True, False, {"conv_s2": True, "conv_nl": True}),
]


@pytest.mark.parametrize("lda_on,gen_seg,kw", SEQ_CASES)
def test_fused_stn_matches_the_sequential_step(lda_on, gen_seg, kw):
    """Stacking changes no loss, gradient or statistic beyond f32
    reordering: the JAX tests' tolerances of a fused arm against the
    sequential step, on the port alone."""
    seq = F.port_step(None, lda_on, gen_seg, **kw)
    fused = F.port_step("fused_stn", lda_on, gen_seg, **kw)
    F.check_seq_and_fused("fused_stn", seq, fused, f"{lda_on} {gen_seg} {kw}")


# ---------------------------------------------------------------- gates
def test_fused_gates():
    """JAX's ``make_train_step`` rules (``:588-606``, ``:822-824``): both
    arms off with layer dropout; ``fused_ftn`` only with latent DA on the
    image code; ``fused_ftn`` wins when both are asked for."""
    lda = LatentDAConfig()
    both = CooperativeTrainer(lda, device="cpu", fused_stn=True, fused_ftn=True)
    assert both.fused_ftn and not both.fused_stn
    for kw in ({"fused_stn": True}, {"fused_ftn": True}):
        t = CooperativeTrainer(lda, device="cpu", **DROPOUT, **kw)
        assert not t.fused_stn and not t.fused_ftn, kw
    assert not CooperativeTrainer(None, device="cpu", fused_ftn=True).fused_ftn
    shape_only = CooperativeTrainer(LatentDAConfig(mask_scope=("shape code",)), device="cpu",
                                    fused_ftn=True)
    assert not shape_only.fused_ftn
    assert CooperativeTrainer(None, device="cpu", fused_stn=True).fused_stn


def test_fused_ftn_without_an_image_pass_trains_sequentially():
    """JAX's ``test_fused_ftn_gates``: with the shape code only, the step
    runs (finite) and its hard seg loss is zero (no hard image pass)."""
    lda = LatentDAConfig(mask_scope=("shape code",))
    t = CooperativeTrainer(lda, device="cpu", fused_ftn=True)
    draws = draw_step(torch.Generator().manual_seed(1), 2, (32, 32), lda)
    m = t.train_step(torch.rand(2, 32, 32, 1), torch.randint(0, 4, (2, 32, 32)), draws)
    assert torch.isfinite(m["loss/total"]) and float(m["loss/hard/seg"]) == 0.0


# ---------------------------------------------------- stacked BatchNorm
@pytest.mark.parametrize("flags", [(True, True, False, False), (True, False), (False, True, True)])
@pytest.mark.parametrize("layout", ["nchw", "nc_hw"])
def test_stacked_batchnorm_matches_sequential_passes(flags, layout):
    """A train-mode BatchNorm on P stacked passes under ``stacked_passes``
    gives each pass the output of a sequential call on it (frozen where
    its flag is False) and the running statistics after those calls, in
    order; under ``frozen_stats`` none move; the flags are restored."""
    p, n, c = len(flags), 3, 5
    gen = torch.Generator().manual_seed(len(flags))
    shape = (p * n, c, 6, 7) if layout == "nchw" else (p * n, c, 42)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    seq, stk = BatchNorm(c), BatchNorm(c)
    for bn in (seq, stk):
        bn.weight.data = torch.rand(c, generator=torch.Generator().manual_seed(1)) + 0.5
        bn.bias.data = torch.randn(c, generator=torch.Generator().manual_seed(2))
        bn.train()
    want = []
    for i, track in enumerate(flags):
        with frozen_stats(seq) if not track else contextlib.nullcontext():
            want.append(seq(x[i * n:(i + 1) * n]))
    with stacked_passes(stk, update_flags=flags):
        assert stacked_flags(stk) == flags
        got = stk(x)
    assert stacked_flags(stk) is None
    torch.testing.assert_close(got, torch.cat(want), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(stk.running_mean, seq.running_mean, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(stk.running_var, seq.running_var, rtol=1e-6, atol=1e-7)
    before = stk.running_mean.clone()
    with stacked_passes(stk, update_flags=flags), frozen_stats(stk):
        stk(x)
    torch.testing.assert_close(stk.running_mean, before, rtol=0, atol=0)
