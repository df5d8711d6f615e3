"""Kernel K1 on the card: the CUDA kernel against its plain PyTorch version
at edge shapes (ragged tiles, C_in not a multiple of the staged chunk,
every C_out bucket), its input checks, its launch count, and the predictor
on the card against the CPU.

Needs an NVIDIA GPU with sm_90a and nvcc; without one every test skips.
This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch (``--noconftest`` skips tests/conftest.py, which
imports JAX):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
"""

import pytest
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
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
