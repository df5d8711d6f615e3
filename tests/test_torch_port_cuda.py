"""The port's kernels on the card: K1 (forward and dx), K2 and K3 against
their plain PyTorch versions at edge shapes (ragged tiles, C_in not a
multiple of the staged chunk, every C_out bucket, D not a multiple of 32,
ties), K2's fixed summation order, the input checks (no fallback), the
launch counts, and the predictor and the train step on the card against
the CPU.

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
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
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


def test_train_step_on_card_matches_cpu(cuda):
    """An f32 step through K1, K2 and K3 against the plain path on the
    CPU: losses within 1e-4; Adam's first moment within twice what the CPU
    step's own moves when its input image moves by +-1e-6 of each pixel
    (this step's gradient is not continuous at f32 rounding: a LeakyReLU
    or ReLU at 0 takes the other slope; chip_smoke.py's train-check says
    more)."""
    lda = LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                         shape_code=MaskConfig("ce", "spatial"))
    draws = draw_step(torch.Generator().manual_seed(0), 2, (64, 64), lda)
    gen = torch.Generator().manual_seed(0)
    image = torch.rand((2, 64, 64, 1), generator=gen)
    label = torch.randint(0, 4, (2, 64, 64), generator=gen)

    def step(device, x):
        trainer = CooperativeTrainer(lda, device=device, seed=0)
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
