"""The port's kernels on the card: K1 (forward and dx), K2, K3, the
stride-2 K4, K4dx and K4dw, the large-channel K5 (forward and dx) and
K5dw, and the blocked K6 (forward and dx) and K6dw against their plain
PyTorch versions at the main path's shapes and at edge shapes (ragged
tiles, C_in not a multiple of the staged chunk, every C_out bucket, D not a
multiple of 32, ties), the fixed summation order of K2, K4dw, K5dw and
K6dw, the input checks (no fallback), the launch counts, and the predictor
and the train step on the card against the CPU, with the default route,
with ``conv_s2=True`` and with ``conv_nl=True``.

Needs an NVIDIA GPU with sm_90a and nvcc; without one every test skips.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``--noconftest`` skips tests/conftest.py, which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
"""

import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
    MaskConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_b8
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_nl
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_s2
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    percentile_mask as pmask,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bf16_ulp(scale):
    return 2.0 ** (int(torch.tensor(scale).log2().floor().item()) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [
    (2, 1, 16, 192, 192),    # the image encoder's first conv
    (3, 3, 5, 17, 33),       # ragged tiles in both directions, C_out bucket 16
    (2, 20, 17, 9, 40),      # C_in not a multiple of 8, C_out bucket 32
    (2, 16, 33, 8, 8),       # C_out bucket 64, one partial tile
    (1, 64, 64, 24, 24),
    (2, 7, 1, 1, 1),         # a single pixel: every tap but the centre is padding
])
def test_k1_matches_plain(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, c_in, h * w), generator=gen, device=cuda).to(dt)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device=cuda)
             / (9 * c_in) ** 0.5).to(dt)
    got = conv_chw.conv3x3_chw(x, w_all, h, w)
    want = conv_chw.conv3x3_chw_plain(x, w_all, h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_out, h * w)
    scale = want.float().abs().max().item()
    # bf16: one rounding of the same f32 sum; f32: another summation order
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def test_k1_rejects_bad_input(cuda):
    x = torch.randn(2, 4, 64, device=cuda)
    w_all = torch.randn(8, 36, device=cuda)
    with pytest.raises(TypeError):
        conv_chw.conv3x3_chw(x.double(), w_all.double(), 8, 8)
    with pytest.raises(ValueError):
        conv_chw.conv3x3_chw(torch.randn(2, 64, 4, device=cuda).transpose(1, 2), w_all, 8, 8)
    with pytest.raises(ValueError):
        conv_chw.conv3x3_chw(x, w_all.cpu(), 8, 8)
    with pytest.raises(ValueError):
        conv_chw.conv3x3_chw(x, torch.randn(65, 36, device=cuda), 8, 8)


def test_k1_counts_launches(cuda):
    x = torch.randn(1, 2, 16, device=cuda)
    w_all = torch.randn(3, 18, device=cuda)
    before = conv_chw.conv3x3_chw.launches
    conv_chw.conv3x3_chw(x, w_all, 4, 4)
    conv_chw.conv3x3_chw_plain(x, w_all, 4, 4)
    assert conv_chw.conv3x3_chw.launches == before + 1


def test_predictor_on_card_matches_cpu(cuda):
    """f32 predict(n_iter=2) through K1 against the plain path on the CPU."""
    gpu = CooperativePredictor(device=cuda, seed=0)
    cpu = CooperativePredictor(device="cpu", seed=0)
    x = torch.rand((2, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    before = conv_chw.conv3x3_chw.launches
    got = gpu.predict(x.to(cuda), n_iter=2).cpu()
    assert conv_chw.conv3x3_chw.launches - before == 26
    want = cpu.predict(x, n_iter=2)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * want.abs().max().item())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [
    (2, 4, 16, 192, 192),    # dx at C_out 4: the shape encoder's first conv
    (3, 3, 5, 17, 33),       # ragged tiles, tiny channel counts
    (2, 20, 17, 9, 40),      # C_in 20 (dx's C_out bucket 32), ragged
    (2, 64, 64, 24, 24),
    (2, 33, 64, 8, 8),       # dx at C_out 33: bucket 64
    (1, 7, 2, 1, 1),
])
def test_k1_dx_matches_plain(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn((n, c_out, h * w), generator=gen, device=cuda).to(dt)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device=cuda)
             / (9 * c_in) ** 0.5).to(dt)
    got = conv_chw.conv3x3_chw_dx(dy, w_all, h, w)
    want = conv_chw.conv3x3_chw_plain(dy, conv_chw.flip_wall(w_all).contiguous(), h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_in, h * w)
    scale = want.float().abs().max().item()
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [
    (20, 16, 16, 192, 192),  # the largest reduction of the step
    (2, 1, 16, 64, 64),      # C_in 1
    (3, 3, 5, 17, 33),       # ragged sub-tiles, C_out not a multiple of 4
    (2, 20, 17, 9, 40),      # C_in over one 16-channel group, C_out bucket 32
    (2, 64, 64, 24, 24),     # four channel groups, bucket 64
    (1, 7, 2, 1, 1),         # one pixel
    (2, 16, 64, 65, 7),      # W over 64 and ragged, narrow
    # the train step's 12 shapes, C_in->C_out @ H^2 (bf16: the tensor-core path)
    (2, 1, 16, 192, 192),
    (2, 4, 16, 192, 192),
    (2, 16, 16, 192, 192),
    (2, 16, 16, 96, 96),
    (2, 16, 32, 96, 96),
    (2, 32, 16, 96, 96),
    (2, 32, 32, 96, 96),
    (2, 32, 32, 48, 48),
    (2, 32, 64, 48, 48),
    (2, 64, 32, 48, 48),
    (2, 64, 64, 48, 48),
    (2, 64, 64, 24, 24),
    (2, 16, 16, 51, 192),    # bands of 2 rows: the last band has one
    (2, 16, 32, 98, 96),     # bands of 3 rows: the last band has two
    (2, 16, 16, 20, 97),     # odd W over 64: rows not 16-byte aligned
    (1, 8, 16, 6, 201),      # odd W over 192: two column windows, unaligned
    (1, 16, 16, 5, 264),     # two column windows, aligned, the second ragged
    (2, 16, 8, 48, 48),      # C_out 8: half an m-tile
    (2, 32, 24, 24, 24),     # C_out 24: one and a half m-tiles
])
def test_k2_matches_plain_and_repeats_bit_for_bit(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((n, c_in, h * w), generator=gen, device=cuda).to(dt)
    dy = torch.randn((n, c_out, h * w), generator=gen, device=cuda).to(dt)
    got = conv_chw.conv3x3_chw_dw(x, dy, h, w)
    again = conv_chw.conv3x3_chw_dw(x, dy, h, w)
    want = conv_chw.conv3x3_chw_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (9 * c_in, c_out)
    # f32 sums of the same products (a bf16 product is exact in f32) in
    # another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, again)


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("n,d", [(20, 128), (20, 144), (3, 37), (2, 1), (1, 4096)])
def test_k3_matches_plain(cuda, n, d, soft):
    gen = torch.Generator(device=cuda).manual_seed(d)
    sal = torch.randn((n, d), generator=gen, device=cuda)
    if d > 8:
        sal[:, 1] = sal[:, 2]
        sal[:, 3:8] = torch.round(sal[:, 3:8])
    vals = (0.5 * torch.rand((n, d), generator=gen, device=cuda) if soft
            else torch.zeros((n, d), device=cuda))
    for p in (0.0, 0.13, 1 / 3, 0.5, 1.0):
        pt = torch.tensor(p, device=cuda)
        got = pmask.percentile_mask(sal, pt, vals)
        assert torch.equal(got, pmask.percentile_mask_plain(sal, pt, vals)), p


def test_k3_tie_semantics(cuda):
    sal = torch.tensor([[5.0, 5.0, 3.0, 1.0]], device=cuda)
    zeros = torch.zeros_like(sal)
    assert pmask.percentile_mask(sal, torch.tensor(0.25, device=cuda), zeros).tolist() == \
        [[1, 1, 1, 1]]
    assert pmask.percentile_mask(sal, torch.tensor(0.5, device=cuda), zeros).tolist() == \
        [[0, 0, 1, 1]]


def test_gradients_refuse_bad_input_without_fallback(cuda):
    x = torch.randn(2, 4, 64, device=cuda, dtype=torch.float64, requires_grad=True)
    with pytest.raises(TypeError):
        conv_chw.conv3x3_chw_ad(x, torch.randn(8, 36, device=cuda, dtype=torch.float64), 8, 8)
    with pytest.raises(ValueError):
        conv_chw.conv3x3_chw_ad(torch.randn(2, 4, 64, device=cuda), torch.randn(8, 36), 8, 8)
    with pytest.raises(ValueError):
        conv_chw.conv3x3_chw_dw(torch.randn(2, 4, 64, device=cuda),
                                torch.randn(2, 65, 64, device=cuda), 8, 8)
    with pytest.raises(ValueError):
        pmask.percentile_mask(torch.randn(2, 8, device=cuda), torch.tensor(0.2),
                              torch.zeros(2, 8, device=cuda))


def test_gradient_launches_are_counted(cuda):
    conv = conv_chw.Conv(3, 8, 3, padding=1).to(cuda)
    before = (conv_chw.conv3x3_chw.launches, conv_chw.conv3x3_chw_dx.launches,
              conv_chw.conv3x3_chw_dw.launches)
    conv(torch.randn(2, 3, 8, 8, device=cuda, requires_grad=True)).sum().backward()
    after = (conv_chw.conv3x3_chw.launches, conv_chw.conv3x3_chw_dx.launches,
             conv_chw.conv3x3_chw_dw.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


def test_generation_launches_no_k2(cuda):
    """Hard-example generation differentiates only with respect to the
    code: K1 forward and dx launch, K2 does not; a targeted branch
    launches K3 once."""
    lda = LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                         shape_code=MaskConfig("ce", "spatial"))
    trainer = CooperativeTrainer(lda, device=cuda, seed=0)
    draws = draw_step(torch.Generator().manual_seed(0), 2, (32, 32), lda, device=cuda)
    image = torch.rand((2, 1, 32, 32), device=cuda)
    label = torch.randint(0, 4, (2, 32, 32), device=cuda)
    _, (z_i, z_s) = trainer.standard_training(image, label, image)
    before = (conv_chw.conv3x3_chw_dw.launches, conv_chw.conv3x3_chw_dx.launches,
              pmask.percentile_mask.launches)
    trainer.hard_example_generation(z_i, z_s, image, label, draws)
    torch.cuda.synchronize()
    assert conv_chw.conv3x3_chw_dw.launches == before[0]
    assert conv_chw.conv3x3_chw_dx.launches - before[1] == 14
    assert pmask.percentile_mask.launches - before[2] == 2
    assert all(p.grad is None for p in trainer.model.parameters())


@pytest.mark.parametrize("conv_s2_on", [False, True])
def test_train_step_on_card_matches_cpu(cuda, conv_s2_on):
    """An f32 step through K1, K2 and K3 (and K4, K4dx, K4dw with
    ``conv_s2``) against the plain path on the CPU: losses within 1e-4;
    Adam's first moment within twice what the CPU step's own moves when its
    input image moves by +-1e-6 of each pixel (this step's gradient is not
    continuous at f32 rounding: a LeakyReLU or ReLU at 0 takes the other
    slope; chip_smoke.py's train-check says more)."""
    lda = LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                         shape_code=MaskConfig("ce", "spatial"))
    draws = draw_step(torch.Generator().manual_seed(0), 2, (64, 64), lda)
    gen = torch.Generator().manual_seed(0)
    image = torch.rand((2, 64, 64, 1), generator=gen)
    label = torch.randint(0, 4, (2, 64, 64), generator=gen)

    def step(device, x):
        trainer = CooperativeTrainer(lda, device=device, seed=0, conv_s2=conv_s2_on)
        d = draws.to(device)
        metrics = trainer.train_step(x.to(device), label.to(device), d)
        mu, _ = trainer.adam_moments()
        return metrics, torch.cat([v.detach().cpu().double().flatten()
                                   for m in mu for v in mu[m].values()])

    got, g_mu = step(cuda, image)
    want, c_mu = step("cpu", image)
    sign = torch.randint(0, 2, image.shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    _, m_mu = step("cpu", image * (1 + 1e-6 * sign))
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, k
    assert (g_mu - c_mu).norm() <= 2 * (m_mu - c_mu).norm()


# (N, C_in, C_out, H, W) of the stride-2 kernels: the main path's two shapes
# at the training batch, and edges: ragged tiles in both directions, C_in
# not a multiple of the staged chunk (and over one 16-channel group of K4dx
# and K4dw), every C_out bucket, several output-channel chunks of K4dx, one
# output pixel, W/2 over 64 (K4dw's narrower sub-tiles)
S2_SHAPES = [
    (20, 16, 16, 192, 192), (20, 32, 32, 96, 96), (3, 3, 5, 18, 34),
    (2, 20, 17, 10, 70), (2, 16, 33, 4, 4), (1, 64, 64, 48, 48), (2, 7, 1, 2, 2),
    (2, 4, 8, 6, 140),
]


def _s2_inputs(cuda, n, c_in, c_out, h, w, dt, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((n, c_in, h * w), generator=gen, device=cuda).to(dt)
    dy = torch.randn((n, c_out, (h // 2) * (w // 2)), generator=gen, device=cuda).to(dt)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device=cuda)
             / (9 * c_in) ** 0.5).to(dt)
    return x, dy, w_all


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", S2_SHAPES)
def test_k4_and_k4dx_match_plain(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    x, dy, w_all = _s2_inputs(cuda, n, c_in, c_out, h, w, dt, 3)
    got = conv_s2.conv3x3s2(x, w_all, h, w)
    want = conv_s2.conv3x3s2_plain(x, w_all, h, w)
    got_dx = conv_s2.conv3x3s2_dx(dy, w_all, h, w)
    want_dx = conv_s2.conv3x3s2_dx_plain(dy, w_all, h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_out, (h // 2) * (w // 2))
    assert got_dx.dtype == dt and got_dx.shape == (n, c_in, h * w)
    for g, wt in ((got, want), (got_dx, want_dx)):
        scale = wt.float().abs().max().item()
        # bf16: one rounding of nearly the same f32 sum; f32: another order
        atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
        torch.testing.assert_close(g.float(), wt.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", S2_SHAPES)
def test_k4dw_matches_plain_and_repeats_bit_for_bit(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    x, dy, _ = _s2_inputs(cuda, n, c_in, c_out, h, w, dt, 4)
    got = conv_s2.conv3x3s2_dw(x, dy, h, w)
    again = conv_s2.conv3x3s2_dw(x, dy, h, w)
    want = conv_s2.conv3x3s2_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (9 * c_in, c_out)
    # f32 sums of the same products (a bf16 product is exact in f32) in
    # another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, again)


def test_k4_rejects_bad_input_without_fallback(cuda):
    x = torch.randn(2, 4, 64, device=cuda)
    w_all = torch.randn(8, 36, device=cuda)
    with pytest.raises(TypeError):
        conv_s2.conv3x3s2(x.double(), w_all.double(), 8, 8)
    with pytest.raises(ValueError):
        conv_s2.conv3x3s2(x, w_all.cpu(), 8, 8)
    with pytest.raises(ValueError):
        conv_s2.conv3x3s2(torch.randn(2, 4, 63, device=cuda), w_all, 9, 7)
    with pytest.raises(ValueError):
        conv_s2.conv3x3s2(x, torch.randn(65, 36, device=cuda), 8, 8)
    with pytest.raises(ValueError):
        conv_s2.conv3x3s2_dw(x, torch.randn(2, 65, 16, device=cuda), 8, 8)
    with pytest.raises(ValueError):
        conv_s2.conv3x3s2_dx(torch.randn(2, 8, 16, device=cuda), w_all[:, :35].contiguous(),
                             8, 8)


def test_k4_launches_are_counted(cuda):
    conv = conv_chw.Conv(3, 3, 3, stride=2, padding=1, k4=True).to(cuda)
    fns = (conv_s2.conv3x3s2, conv_s2.conv3x3s2_dx, conv_s2.conv3x3s2_dw)
    before = [f.launches for f in fns]
    conv(torch.randn(2, 3, 8, 8, device=cuda, requires_grad=True)).sum().backward()
    conv_s2.conv3x3s2_plain(torch.randn(1, 3, 16), torch.randn(3, 27), 4, 4)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1]


def test_predictor_s2_on_card_matches_cpu(cuda):
    """f32 predict(n_iter=2) with ``conv_s2`` through K1 and K4 against the
    plain path on the CPU; 4 K4 launches a request."""
    gpu = CooperativePredictor(device=cuda, seed=0, conv_s2=True)
    cpu = CooperativePredictor(device="cpu", seed=0, conv_s2=True)
    x = torch.rand((2, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    before = (conv_chw.conv3x3_chw.launches, conv_s2.conv3x3s2.launches)
    got = gpu.predict(x.to(cuda), n_iter=2).cpu()
    assert (conv_chw.conv3x3_chw.launches - before[0],
            conv_s2.conv3x3s2.launches - before[1]) == (26, 4)
    want = cpu.predict(x, n_iter=2)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * want.abs().max().item())


def test_train_mode_predict_on_card_leaves_buffers(cuda):
    """A trainer's model predicts in eval mode and leaves every buffer bit
    for bit as it was."""
    trainer = CooperativeTrainer(LatentDAConfig(), device=cuda, seed=0, conv_s2=True)
    before = {k: v.clone() for k, v in trainer.model.named_buffers()}
    x = torch.rand((2, 32, 32, 1), device=cuda)
    got = trainer.model.predict(x, n_iter=2)
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.named_buffers())
    assert all(m.training for m in trainer.model.modules())
    trainer.model.eval()
    assert torch.equal(got, trainer.model.predict(x, n_iter=2))


# (N, C_in, C_out, H, W) of K5: the main path's four shapes at the training
# batch, and edges: C_in not a multiple of the 32-channel step (and 9*C_in
# not a multiple of the 64-row dw tile), C_out not a multiple of the
# 64-column tile, tiles that cross images (12x12 = 144 pixels, 2.25 tiles),
# non-square images, the largest channel count, one pixel
NL_SHAPES = [
    (20, 64, 128, 24, 24), (20, 128, 128, 24, 24), (20, 128, 128, 12, 12),
    (20, 128, 64, 24, 24), (3, 72, 136, 7, 11), (2, 100, 200, 5, 3), (2, 256, 64, 6, 6),
    (3, 64, 128, 1, 1),
]


def _nl_inputs(cuda, n, c_in, c_out, h, w, dt, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((n, c_in, h * w), generator=gen, device=cuda).to(dt)
    dy = torch.randn((n, c_out, h * w), generator=gen, device=cuda).to(dt)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device=cuda)
             / (9 * c_in) ** 0.5).to(dt)
    return x, dy, w_all


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", NL_SHAPES)
def test_k5_and_k5dx_match_plain(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    x, dy, w_all = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 5)
    got = conv_nl.conv3x3_nl(x, w_all, h, w)
    want = conv_nl.conv3x3_nl_plain(x, w_all, h, w)
    got_dx = conv_nl.conv3x3_nl_dx(dy, w_all, h, w)
    want_dx = conv_nl.conv3x3_nl_plain(dy, conv_chw.flip_wall(w_all).contiguous(), h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_out, h * w)
    assert got_dx.dtype == dt and got_dx.shape == (n, c_in, h * w)
    for g, wt in ((got, want), (got_dx, want_dx)):
        scale = wt.float().abs().max().item()
        # bf16: one rounding of nearly the same f32 sum (the tensor cores'
        # f32 accumulation); f32: FMAs in another order
        atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
        torch.testing.assert_close(g.float(), wt.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", NL_SHAPES)
def test_k5dw_matches_plain_and_repeats_bit_for_bit(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    x, dy, _ = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 6)
    got = conv_nl.conv3x3_nl_dw(x, dy, h, w)
    again = conv_nl.conv3x3_nl_dw(x, dy, h, w)
    want = conv_nl.conv3x3_nl_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (9 * c_in, c_out)
    # f32 sums of the same products (a bf16 product is exact in f32) in
    # another order
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, again)


def test_k5_rejects_bad_input_without_fallback(cuda):
    x = torch.randn(2, 64, 16, device=cuda)
    w_all = torch.randn(128, 576, device=cuda)
    with pytest.raises(TypeError):
        conv_nl.conv3x3_nl(x.double(), w_all.double(), 4, 4)
    with pytest.raises(ValueError):
        conv_nl.conv3x3_nl(x, w_all.cpu(), 4, 4)
    with pytest.raises(ValueError):
        conv_nl.conv3x3_nl(x, torch.randn(64, 576, device=cuda), 4, 4)
    with pytest.raises(ValueError):
        conv_nl.conv3x3_nl_dw(x, torch.randn(2, 64, 16, device=cuda), 4, 4)


def test_k5_launches_are_counted(cuda):
    conv = conv_chw.Conv(64, 128, 3, padding=1, k5=True).to(cuda)
    fns = (conv_nl.conv3x3_nl, conv_nl.conv3x3_nl_dx, conv_nl.conv3x3_nl_dw)
    before = [f.launches for f in fns]
    conv(torch.randn(2, 64, 4, 4, device=cuda, requires_grad=True)).sum().backward()
    conv_nl.conv3x3_nl_plain(torch.randn(1, 64, 16), torch.randn(128, 576), 4, 4)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1]


def test_predictor_nl_on_card_matches_cpu(cuda):
    """f32 predict(n_iter=2) with ``conv_nl`` through K1 and K5 against the
    plain path on the CPU; 10 K5 launches a request, K1's 26 unchanged."""
    gpu = CooperativePredictor(device=cuda, seed=0, conv_nl=True)
    cpu = CooperativePredictor(device="cpu", seed=0, conv_nl=True)
    x = torch.rand((2, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    before = (conv_chw.conv3x3_chw.launches, conv_nl.conv3x3_nl.launches)
    got = gpu.predict(x.to(cuda), n_iter=2).cpu()
    assert (conv_chw.conv3x3_chw.launches - before[0],
            conv_nl.conv3x3_nl.launches - before[1]) == (26, 10)
    want = cpu.predict(x, n_iter=2)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * want.abs().max().item())


def test_train_step_nl_on_card_matches_cpu(cuda):
    """An f32 step with ``conv_nl`` (K5, its dx and K5dw beside K1-K3)
    against the plain path on the CPU, held as
    test_train_step_on_card_matches_cpu holds the default route's."""
    lda = LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                         shape_code=MaskConfig("ce", "spatial"))
    draws = draw_step(torch.Generator().manual_seed(0), 2, (64, 64), lda)
    gen = torch.Generator().manual_seed(0)
    image = torch.rand((2, 64, 64, 1), generator=gen)
    label = torch.randint(0, 4, (2, 64, 64), generator=gen)

    def step(device, x):
        trainer = CooperativeTrainer(lda, device=device, seed=0, conv_nl=True)
        metrics = trainer.train_step(x.to(device), label.to(device), draws.to(device))
        mu, _ = trainer.adam_moments()
        return metrics, torch.cat([v.detach().cpu().double().flatten()
                                   for m in mu for v in mu[m].values()])

    before = [f.launches for f in (conv_nl.conv3x3_nl, conv_nl.conv3x3_nl_dx,
                                   conv_nl.conv3x3_nl_dw)]
    got, g_mu = step(cuda, image)
    after = [f.launches for f in (conv_nl.conv3x3_nl, conv_nl.conv3x3_nl_dx,
                                  conv_nl.conv3x3_nl_dw)]
    want_launches = CooperativeTrainer(lda, device="cpu", conv_nl=True).expected_launches(
        {"image": draws.image.branch, "shape": draws.shape.branch})
    assert [a - b for a, b in zip(after, before)] == [
        want_launches[k] for k in ("conv3x3_nl", "conv3x3_nl_dx", "conv3x3_nl_dw")]
    want, c_mu = step("cpu", image)
    sign = torch.randint(0, 2, image.shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    _, m_mu = step("cpu", image * (1 + 1e-6 * sign))
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, k
    assert (g_mu - c_mu).norm() <= 2 * (m_mu - c_mu).norm()


# (N, C_in, C_out, H, W) of K6: the five stages of bench_b8_conv at its
# batch, and edges: the gate's smallest C_in and W, C_out not a multiple of
# the 8-channel group, a ragged last run of pixel blocks, two rows
B8_SHAPES = [
    (20, 16, 16, 192, 192), (20, 16, 32, 96, 96), (20, 32, 32, 96, 96), (20, 32, 64, 48, 48),
    (20, 64, 64, 48, 48), (3, 8, 4, 12, 16), (2, 24, 13, 10, 40), (2, 64, 1, 2, 8),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", B8_SHAPES)
def test_k6_and_k6dx_match_plain(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    x, dy, w_all = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 7)
    got = conv_b8.conv3x3_b8(x, w_all, h, w)
    want = conv_b8.conv3x3_b8_plain(x, w_all, h, w)
    got_dx = conv_b8.conv3x3_b8_dx(dy, w_all, h, w)
    want_dx = conv_b8.conv3x3_b8_plain(dy, conv_chw.flip_wall(w_all).contiguous(), h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_out, h * w)
    assert got_dx.dtype == dt and got_dx.shape == (n, c_in, h * w)
    for g, wt in ((got, want), (got_dx, want_dx)):
        scale = wt.float().abs().max().item()
        atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
        torch.testing.assert_close(g.float(), wt.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", B8_SHAPES)
def test_k6dw_matches_plain_and_repeats_bit_for_bit(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    x, dy, _ = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 8)
    got = conv_b8.conv3x3_b8_dw(x, dy, h, w)
    again = conv_b8.conv3x3_b8_dw(x, dy, h, w)
    want = conv_b8.conv3x3_b8_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (9 * c_in, c_out)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, again)


def test_k6_rejects_bad_input_and_counts_launches(cuda):
    x = torch.randn(2, 8, 64, device=cuda)
    w_all = torch.randn(16, 72, device=cuda)
    with pytest.raises(TypeError):
        conv_b8.conv3x3_b8(x.double(), w_all.double(), 8, 8)
    with pytest.raises(ValueError):
        conv_b8.conv3x3_b8(x, w_all.cpu(), 8, 8)
    with pytest.raises(ValueError):
        conv_b8.conv3x3_b8(torch.randn(2, 8, 48, device=cuda), w_all, 8, 6)
    fns = (conv_b8.conv3x3_b8, conv_b8.conv3x3_b8_dx, conv_b8.conv3x3_b8_dw)
    before = [f.launches for f in fns]
    xg = x.clone().requires_grad_(True)
    conv_b8.conv3x3_b8_ad(xg, w_all.clone().requires_grad_(True), 8, 8).sum().backward()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1]
