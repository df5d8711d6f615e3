"""The port's kernels on the card: K1 (forward and dx), K2, K3, the
stride-2 K4, K4dx and K4dw, the large-channel K5 (forward and dx) and
K5dw, and the blocked K6 (forward and dx) and K6dw against their plain
PyTorch versions at the main path's shapes and at edge shapes (ragged
tiles, C_in not a multiple of the staged chunk, every C_out bucket, D not a
multiple of 32, ties at -0.0 and 0.0, constant rows, p on and one ulp
below an integer threshold), the fixed summation order of K2, K4, K4dx, K4dw,
K5, K5dw, K6 and K6dw, K4, K4dx, K4dw and K5dw on unaligned operands, K4's
and K4dx's routes by dtype and C_in, K4dw, K5dw and K6dw inside the
workspace they report, K6 and
K6dw refusing unaligned bf16 operands, the input checks (no fallback), the
launch counts, the profile scripts' device busy without
``record_function`` ranges, and the predictor and the train step on the
card against the CPU, with the default route, with ``conv_s2=True`` and
with ``conv_nl=True``; the training augmentation pipeline and its warp
on the card against the CPU on the same draws; the ACDC-C corruptions
and their generator on the card against the CPU; ``cli.train``'s start at
seed 40 against the numbers recorded on the CPU of a machine without a
card; and the step's other configurations (``separate_training``, the
two ablation network types, layer dropout, ``remat``, the saliency-BN
arm, the fused pass arms ``fused_stn`` and ``fused_ftn``) on the card
against the CPU and graphed against eager, with K1, K1 dx and K2 at the
stacked batches' N = 80 and two non-capturable eager steps repeating bit
for bit (deterministic cuDNN); the warp arms graphed; and the baselines'
``SegmentationSolver``: an f32 step on the card against the CPU, a bf16
``predict`` of FCN_16 against its f32 twin, and a JAX ``.msgpack``
checkpoint loaded on the card; K1, K1 dx, K2 and K3 at N = 10, a rank's
shard of the batch of 20, and the data-parallel step of two gloo ranks
sharing the card against one process (``parallel/mesh.py``).

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
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import augment
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


def _traced_kernels(fn, tries=3):
    """(names of the device kernels one call of ``fn`` launched, by
    ``torch.profiler``; the call's result).  A profiler session now and
    then delivers no device events (chip_smoke.py's ``device_ms`` meets the
    same), so an empty one is run again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    return names, out


def _bf16_ulp(scale):
    return 2.0 ** (int(torch.tensor(scale).log2().floor().item()) - 7)


# (C_in, C_out, H) of the main path's K1 convs (square images), forward
K1_SHAPES = [(1, 16, 192), (4, 16, 192), (16, 16, 192), (16, 16, 96), (16, 32, 96),
             (32, 16, 96), (32, 32, 96), (32, 32, 48), (32, 64, 48), (64, 32, 48),
             (64, 64, 48), (64, 64, 24)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [
    (2, 1, 16, 192, 192),    # the image encoder's first conv
    (3, 3, 5, 17, 33),       # ragged tiles in both directions, C_out bucket 16
    (2, 20, 17, 9, 40),      # C_in not a multiple of 8, C_out bucket 32
    (2, 16, 33, 8, 8),       # C_out bucket 64, one partial tile
    (1, 64, 64, 24, 24),
    (2, 7, 1, 1, 1),         # a single pixel: every tap but the centre is padding
    (2, 9, 3, 5, 201),       # bf16 tensor cores: C_in 9, four column windows, unaligned
    (2, 40, 48, 7, 136),     # three channel groups; C_out 48: two blocks along C_out
    *[(2, ci, co, h, h) for ci, co, h in K1_SHAPES],   # the main path's shapes
    (160, 64, 64, 24, 24),   # the serving batch: taller bands, more tiles a block
])
def test_k1_matches_plain(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((n, c_in, h * w), generator=gen, device=cuda).to(dt)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device=cuda)
             / (9 * c_in) ** 0.5).to(dt)
    got = conv_chw.conv3x3_chw(x, w_all, h, w)
    again = conv_chw.conv3x3_chw(x, w_all, h, w)
    want = conv_chw.conv3x3_chw_plain(x, w_all, h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_out, h * w)
    scale = want.float().abs().max().item()
    # bf16: one rounding of the same f32 sum; f32: another summation order
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    # no atomics: one summation order per output, so launches repeat bit for bit
    assert torch.equal(got, again)


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
    # the train step's dx shapes: every main-path conv but the image's
    *[(2, ci, co, h, h) for ci, co, h in K1_SHAPES if ci > 1],
])
def test_k1_dx_matches_plain(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn((n, c_out, h * w), generator=gen, device=cuda).to(dt)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device=cuda)
             / (9 * c_in) ** 0.5).to(dt)
    got = conv_chw.conv3x3_chw_dx(dy, w_all, h, w)
    again = conv_chw.conv3x3_chw_dx(dy, w_all, h, w)
    want = conv_chw.conv3x3_chw_plain(dy, conv_chw.flip_wall(w_all).contiguous(), h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_in, h * w)
    scale = want.float().abs().max().item()
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert torch.equal(got, again)


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


K1_CASES = [(*shape, which) for which in ("fwd", "dx", "dw") for shape in K1_SHAPES
            if which != "dx" or shape[0] > 1]   # the image's conv launches no dx


@pytest.mark.parametrize("c_in,c_out,h,which", K1_CASES)
def test_k1_and_k2_at_the_stacked_batch(cuda, c_in, c_out, h, which):
    """K1, K1 dx and K2 at N = 80, the fused STN batch (4 passes of 20;
    the fused FTN's is 40), bf16, at every main-path shape: against the
    plain versions (one bf16 ulp; K2 1e-5 of scale) and bit for bit on a
    repeat (the grids' N axes and K2's per-image slabs at 80)."""
    _check_k1_k2(cuda, 80, c_in, c_out, h, which)


@pytest.mark.parametrize("c_in,c_out,h,which", K1_CASES)
def test_k1_and_k2_at_the_rank_batch(cuda, c_in, c_out, h, which):
    """The same at N = 10, each rank's shard of the batch of 20 over two
    data-parallel ranks (``parallel/mesh.py``)."""
    _check_k1_k2(cuda, 10, c_in, c_out, h, which)


def _check_k1_k2(cuda, n, c_in, c_out, h, which):
    w = h
    dt = torch.bfloat16
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((n, c_in, h * w), generator=gen, device=cuda).to(dt)
    dy = torch.randn((n, c_out, h * w), generator=gen, device=cuda).to(dt)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device=cuda)
             / (9 * c_in) ** 0.5).to(dt)
    fn, plain = {
        "fwd": (lambda: conv_chw.conv3x3_chw(x, w_all, h, w),
                lambda: conv_chw.conv3x3_chw_plain(x, w_all, h, w)),
        "dx": (lambda: conv_chw.conv3x3_chw_dx(dy, w_all, h, w),
               lambda: conv_chw.conv3x3_chw_plain(
                   dy, conv_chw.flip_wall(w_all).contiguous(), h, w)),
        "dw": (lambda: conv_chw.conv3x3_chw_dw(x, dy, h, w),
               lambda: conv_chw.conv3x3_chw_dw_plain(x, dy, h, w)),
    }[which]
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    atol = 1e-5 * scale if which == "dw" else _bf16_ulp(scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    assert torch.equal(got, again)


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("n,d", [
    (20, 128), (20, 144), (3, 37), (2, 1), (1, 4096),   # the main path's shapes and edges
    (10, 128), (10, 144),         # a rank's shard of 20 over two data-parallel ranks
    (20, 31), (33, 32), (1, 33),  # one block a row, padded or not; a second block of 1
    (160, 144),                   # many rows
    (2, 257), (1, 1024), (2, 1025),   # more than one staging pass of 256 entries
])
def test_k3_matches_plain(cuda, n, d, soft):
    """Equal to the sort-based threshold, with ties (also at -0.0 and 0.0)
    and constant rows, at p where f32(D) * p is an integer and one ulp below
    it; two launches bitwise equal."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    sal = torch.randn((n, d), generator=gen, device=cuda)
    if d > 8:
        sal[:, 1] = sal[:, 2]
        sal[:, 3:8] = torch.round(sal[:, 3:8])
        sal[:, 8::7] = -0.0
        sal[:, 9::7] = 0.0
    sal[0] = sal[0, 0].clone()                  # a row of one value
    if n > 2:
        sal[1] = 0.0
        sal[1, ::2] = -0.0                      # a row of zeros of both signs
    vals = (0.5 * torch.rand((n, d), generator=gen, device=cuda) if soft
            else torch.zeros((n, d), device=cuda))
    on_int = [torch.tensor(q, device=cuda) for q in (0.25, 0.5, 1 / 3)]
    assert (torch.floor(d * on_int[1]) == d * on_int[1]) == (d % 2 == 0)
    below = [torch.nextafter(q, torch.zeros_like(q)) for q in on_int]
    for pt in [torch.tensor(q, device=cuda) for q in (0.0, 0.13, 1.0)] + on_int + below:
        got = pmask.percentile_mask(sal, pt, vals)
        assert torch.equal(got, pmask.percentile_mask_plain(sal, pt, vals)), pt.item()
        assert torch.equal(got, pmask.percentile_mask(sal, pt, vals)), pt.item()


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


# the tensor-core K4's tiling (bf16): bands that do not divide
# H/2 (95 and 19 output rows), W/2 over 64 (2 and 3 windows), W/2 not a
# multiple of 8 (35, 17: element-wise staging), C_in 9, 24, 40 (a partial
# 16-channel stage), 64 and 72 (more wall slices than stay resident), every
# C_out bucket (5, 16, 17, 33, 40, 64: one or two m-tiles, one or two blocks
# along C_out), one output row, N = 1, more tiles than blocks (N = 300), and
# the main path's shapes at the serving batch
S2_FWD_SHAPES = [
    (2, 16, 16, 190, 192), (3, 24, 17, 38, 96), (1, 40, 33, 24, 304), (2, 64, 64, 48, 48),
    (2, 16, 5, 20, 70), (3, 24, 40, 10, 34), (1, 72, 16, 12, 32), (2, 9, 16, 8, 16),
    (2, 12, 8, 2, 32), (300, 24, 17, 4, 16), (160, 16, 16, 192, 192), (160, 32, 32, 96, 96),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", S2_FWD_SHAPES)
def test_k4_tiling_matches_plain_and_repeats_bit_for_bit(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    x, _, w_all = _s2_inputs(cuda, n, c_in, c_out, h, w, dt, 5)
    got = conv_s2.conv3x3s2(x, w_all, h, w)
    again = conv_s2.conv3x3s2(x, w_all, h, w)
    want = conv_s2.conv3x3s2_plain(x, w_all, h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_out, (h // 2) * (w // 2))
    scale = want.float().abs().max().item()
    # bf16: one rounding of nearly the same f32 sum; f32: another order
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    # one mma chain (or one thread's sum) per output, no atomics
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [(20, 16, 16, 192, 192), (3, 24, 40, 10, 64)])
def test_k4_on_unaligned_operands(cuda, n, c_in, c_out, h, w, dtype):
    """x, the wall and the output 2 bytes past a 16-byte boundary: the
    tensor-core kernel stages element by element and stores element by
    element, and gives the same outputs."""
    dt = getattr(torch, dtype)
    x, _, w_all = _s2_inputs(cuda, n, c_in, c_out, h, w, dt, 14)
    xu = torch.empty(x.numel() + 1, dtype=dt, device=cuda)[1:].view(x.shape)
    wu = torch.empty(w_all.numel() + 1, dtype=dt, device=cuda)[1:].view(w_all.shape)
    xu.copy_(x)
    wu.copy_(w_all)
    out = torch.empty(n * c_out * (h // 2) * (w // 2) + 1, dtype=dt, device=cuda)[1:]
    conv_s2._launch("conv3x3s2", "unaligned test", xu, xu.data_ptr(), wu.data_ptr(),
                    out.data_ptr(), n, c_in, c_out, h, w)
    want = conv_s2.conv3x3s2_plain(x, w_all, h, w)
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(out.view(want.shape).float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,c_in,kernel", [
    ("bfloat16", 16, "tc::conv3x3s2_mma_kernel"), ("bfloat16", 9, "tc::conv3x3s2_mma_kernel"),
    ("bfloat16", 8, "tc::conv3x3s2_mma_kernel"), ("bfloat16", 3, "tc::conv3x3s2_mma_kernel"),
    ("float32", 16, "conv3x3s2_fwd_kernel"),
])
def test_k4_routes_by_dtype_and_channels(cuda, dtype, c_in, kernel):
    """bf16 of any C_in runs on the tensor cores, f32 on the CUDA cores: one
    launch, of that kernel, in K4's profile row."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
        _group,
    )

    x, _, w_all = _s2_inputs(cuda, 2, c_in, 16, 32, 32, getattr(torch, dtype), 15)
    conv_s2.conv3x3s2(x, w_all, 32, 32)  # built and loaded before the trace
    torch.cuda.synchronize()
    names, _ = _traced_kernels(lambda: conv_s2.conv3x3s2(x, w_all, 32, 32))
    assert len(names) == 1 and kernel in names[0], names
    assert _group(names[0]) == "K4 conv3x3s2", names


# the tensor-core K4dx's tiling (bf16): bands that do not divide H/2 (95 and
# 19 dy rows), W/2 over 64 (2 and 3 windows), W/2 not a multiple of 8 (35,
# 17: element-wise staging and stores), C_out 1, 5, 17, 33 and 64 (padded
# k-steps), C_in 3, 7, 20, 40 and 72 (a partial m-tile, two and three blocks
# along grid.y), one dy pixel, N = 1, more tiles than blocks (N = 300), and
# the main path's shapes at the training and the serving batch
S2_DX_SHAPES = [
    (2, 16, 16, 190, 192), (3, 24, 17, 38, 96), (1, 40, 33, 24, 304), (2, 72, 64, 48, 48),
    (2, 20, 5, 20, 70), (3, 7, 1, 10, 34), (2, 3, 16, 8, 16), (2, 7, 33, 2, 2),
    (300, 24, 17, 4, 16), (20, 16, 16, 192, 192), (20, 32, 32, 96, 96),
    (160, 16, 16, 192, 192), (160, 32, 32, 96, 96),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", S2_DX_SHAPES)
def test_k4dx_tiling_matches_plain_and_repeats_bit_for_bit(cuda, n, c_in, c_out, h, w, dtype):
    dt = getattr(torch, dtype)
    _, dy, w_all = _s2_inputs(cuda, n, c_in, c_out, h, w, dt, 6)
    got = conv_s2.conv3x3s2_dx(dy, w_all, h, w)
    again = conv_s2.conv3x3s2_dx(dy, w_all, h, w)
    want = conv_s2.conv3x3s2_dx_plain(dy, w_all, h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_in, h * w)
    scale = want.float().abs().max().item()
    # bf16: one rounding of nearly the same f32 sum; f32: another order
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)
    # one mma chain (or one thread's sum) per output, no atomics
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [(20, 16, 16, 192, 192), (3, 24, 40, 10, 64)])
def test_k4dx_on_unaligned_operands(cuda, n, c_in, c_out, h, w, dtype):
    """dy, the wall and dx 2 bytes past a 16-byte boundary: the tensor-core
    kernel stages element by element and stores element by element, and
    gives the same outputs."""
    dt = getattr(torch, dtype)
    _, dy, w_all = _s2_inputs(cuda, n, c_in, c_out, h, w, dt, 16)
    du = torch.empty(dy.numel() + 1, dtype=dt, device=cuda)[1:].view(dy.shape)
    wu = torch.empty(w_all.numel() + 1, dtype=dt, device=cuda)[1:].view(w_all.shape)
    du.copy_(dy)
    wu.copy_(w_all)
    out = torch.empty(n * c_in * h * w + 1, dtype=dt, device=cuda)[1:]
    conv_s2._launch("conv3x3s2_dx", "unaligned test", du, du.data_ptr(), wu.data_ptr(),
                    out.data_ptr(), n, c_in, c_out, h, w)
    want = conv_s2.conv3x3s2_dx_plain(dy, w_all, h, w)
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(out.view(want.shape).float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,c_in,kernel", [
    ("bfloat16", 16, "tc::conv3x3s2_dx_mma_kernel"),
    ("bfloat16", 40, "tc::conv3x3s2_dx_mma_kernel"),
    ("bfloat16", 3, "tc::conv3x3s2_dx_mma_kernel"),
    ("float32", 16, "conv3x3s2_dx_kernel"),
])
def test_k4dx_routes_by_dtype(cuda, dtype, c_in, kernel):
    """bf16 of any C_in runs on the tensor cores, f32 on the CUDA cores: one
    launch, of that kernel, in K4dx's profile row."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
        _group,
    )

    _, dy, w_all = _s2_inputs(cuda, 2, c_in, 16, 32, 32, getattr(torch, dtype), 17)
    conv_s2.conv3x3s2_dx(dy, w_all, 32, 32)  # built and loaded before the trace
    torch.cuda.synchronize()
    names, _ = _traced_kernels(lambda: conv_s2.conv3x3s2_dx(dy, w_all, 32, 32))
    assert len(names) == 1 and kernel in names[0], names
    assert _group(names[0]) == "K4dx conv3x3s2_dx", names


# the tensor-core K4dw's tiling: bands that do not divide H/2 (95 and 19
# output rows), W/2 a multiple of 8 but not of 16 (k-steps padded with dy
# zeros), odd W/2 (17, 35: element-wise staging), C_in not a multiple of 8
# or 16 (12, 24, 40: a last group of 8), every C_out bucket (5, 17, 24, 40,
# 48, 64), N = 1 and 3, rows wider than a window (W/2 = 152, landed; 150,
# element-wise), and the main path's shapes at the serving batch
S2_DW_SHAPES = [
    (20, 16, 16, 190, 192), (3, 16, 24, 38, 96), (2, 16, 16, 20, 80), (3, 16, 5, 14, 34),
    (1, 24, 40, 10, 70), (2, 12, 48, 16, 32), (2, 3, 64, 12, 48), (3, 40, 17, 24, 16),
    (1, 16, 32, 6, 304), (2, 8, 16, 4, 300), (160, 16, 16, 192, 192), (160, 32, 32, 96, 96),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", S2_SHAPES + S2_DW_SHAPES)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [(20, 16, 16, 192, 192), (3, 24, 40, 10, 64)])
def test_k4dw_on_unaligned_operands(cuda, n, c_in, c_out, h, w, dtype):
    """x and dy that start 2 bytes past a 16-byte boundary: the kernel
    stages them element by element and gives the same sums."""
    dt = getattr(torch, dtype)
    x, dy, _ = _s2_inputs(cuda, n, c_in, c_out, h, w, dt, 12)
    xu = torch.empty(x.numel() + 1, dtype=dt, device=cuda)[1:].view(x.shape)
    dyu = torch.empty(dy.numel() + 1, dtype=dt, device=cuda)[1:].view(dy.shape)
    xu.copy_(x)
    dyu.copy_(dy)
    got = conv_s2.conv3x3s2_dw(xu, dyu, h, w)
    want = conv_s2.conv3x3s2_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, conv_s2.conv3x3s2_dw(xu, dyu, h, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [
    (20, 16, 16, 192, 192), (20, 32, 32, 96, 96), (160, 32, 32, 96, 96), (3, 40, 17, 24, 16),
    (2, 8, 16, 4, 300),
])
def test_k4dw_stays_inside_its_workspace(cuda, n, c_in, c_out, h, w, dtype):
    """The C function through the port's binding, with the workspace it
    reports for these shapes plus a tail of sentinels: the sums are right
    and the tail is untouched, for either dtype's route."""
    dt = getattr(torch, dtype)
    x, dy, _ = _s2_inputs(cuda, n, c_in, c_out, h, w, dt, 13)
    size = conv_s2._fn("conv3x3s2_dw_workspace")(n, c_in, c_out, h, w, int(dt == torch.bfloat16))
    assert size >= 9 * c_in * c_out
    work = torch.full((size + 4096,), 1234.5, dtype=torch.float32, device=cuda)
    out = torch.empty((9 * c_in, c_out), dtype=torch.float32, device=cuda)
    conv_s2._launch("conv3x3s2_dw", "sentinel test", x, x.data_ptr(), dy.data_ptr(),
                    work.data_ptr(), out.data_ptr(), n, c_in, c_out, h, w)
    want = conv_s2.conv3x3s2_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    assert bool((work[size:] == 1234.5).all())
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_profile_busy_leaves_record_function_ranges_out(cuda):
    """The profile scripts' busy (``profile_predict.device_time``) over
    real traces: a ``record_function`` range around one K1 launch shows on
    the device and is returned apart; busy is the kernel's device time.
    Every one of ten traces is held to that, so a trace that comes back
    without its device events fails the test."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
        _group,
        device_time,
    )

    gen = torch.Generator(device=cuda).manual_seed(16)
    x = torch.randn((4, 16, 96 * 96), generator=gen, device=cuda).to(torch.bfloat16)
    w_all = torch.randn((16, 144), generator=gen, device=cuda).to(torch.bfloat16)
    conv_chw.conv3x3_chw(x, w_all, 96, 96)  # built and loaded before the traces
    torch.cuda.synchronize()
    for trace in range(10):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("k1_range"):
                conv_chw.conv3x3_chw(x, w_all, 96, 96)
            torch.cuda.synchronize()
        device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        k1 = [e.time_range.elapsed_us() for e in device if _group(e.name).startswith("K1 ")]
        seen = (trace, [(e.name, e.is_user_annotation) for e in device])
        assert len(k1) == 1 and k1[0] > 0, seen
        by_group, ranges, _ = device_time(prof.key_averages())
        assert ranges > 0, seen
        assert set(by_group) == {_group("tc::conv3x3_chw_mma_kernel")}, seen
        assert sum(by_group.values()) == pytest.approx(k1[0], rel=1e-3), seen


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
# non-square images, the largest channel count, one pixel.  Then edges of
# the tensor-core forward's tiling: bands that do not divide H (13x13, 24x7,
# H*W not a multiple of 8 at 13x13, so x is staged element-wise; 24x7 lands
# whole rows of odd width, whose 8-pixel groups cross rows), channel stages
# of 32 that do not divide C_in (96 fits, 200 leaves 8; for dx C_out 136
# leaves 8), C_out slices of 32 that do not divide 136, C_out 256, rows too
# wide to land (W 300: column windows), and the serving batch N = 160 at 24^2
NL_SHAPES = [
    (20, 64, 128, 24, 24), (20, 128, 128, 24, 24), (20, 128, 128, 12, 12),
    (20, 128, 64, 24, 24), (3, 72, 136, 7, 11), (2, 100, 200, 5, 3), (2, 256, 64, 6, 6),
    (3, 64, 128, 1, 1),
    (2, 96, 136, 13, 13), (3, 200, 256, 24, 7), (2, 128, 96, 13, 13), (1, 64, 128, 3, 300),
    (160, 128, 128, 24, 24), (160, 64, 128, 24, 24), (160, 128, 128, 12, 12),
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
    """Forward and dx against the plain version, each launched twice: the
    two launches agree bit for bit (no atomics, a fixed order of sums)."""
    dt = getattr(torch, dtype)
    x, dy, w_all = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 5)
    got = conv_nl.conv3x3_nl(x, w_all, h, w)
    again = conv_nl.conv3x3_nl(x, w_all, h, w)
    want = conv_nl.conv3x3_nl_plain(x, w_all, h, w)
    got_dx = conv_nl.conv3x3_nl_dx(dy, w_all, h, w)
    again_dx = conv_nl.conv3x3_nl_dx(dy, w_all, h, w)
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
    assert torch.equal(got, again) and torch.equal(got_dx, again_dx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5dx_reads_the_unflipped_wall(cuda, dtype, monkeypatch):
    """On the card conv3x3_nl_dx folds the flip into the kernel's wall
    reads: no flipped copy of the wall is built."""
    dt = getattr(torch, dtype)
    _, dy, w_all = _nl_inputs(cuda, 2, 64, 128, 24, 24, dt, 7)
    want = conv_nl.conv3x3_nl_plain(dy, conv_chw.flip_wall(w_all).contiguous(), 24, 24)

    def refuse(_w):
        raise AssertionError("flip_wall called on the card")

    monkeypatch.setattr(conv_chw, "flip_wall", refuse)
    got = conv_nl.conv3x3_nl_dx(dy, w_all, 24, 24)
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


# the tensor-core K5dw's tiling where x and dy land by cp.async: bands that
# do not divide H (15 rows as 8 + 7, 14 as 8 + 6, 15 as bands of 2),
# k-steps that cross rows (W 20, 12, 8) or end half past a band (bands of
# 216 and 24 pixels), 32-channel tiles that do not divide C_in 72 and 200 or
# C_out 72, 96 and 136, short bands at N = 3 and 1; and element-wise staging:
# rows too wide to land (W 300 at H*W % 8 == 0: column windows), an odd
# pixel count (N*H*W = 363)
DW_SHAPES = [
    (20, 128, 72, 15, 16), (20, 72, 136, 14, 20), (20, 200, 136, 18, 24), (20, 64, 128, 9, 8),
    (3, 72, 128, 20, 12), (1, 128, 72, 15, 16), (2, 64, 128, 8, 300), (3, 136, 96, 11, 11),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", NL_SHAPES + DW_SHAPES)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [(20, 128, 128, 24, 24), (3, 72, 128, 20, 12)])
def test_k5dw_on_unaligned_operands(cuda, n, c_in, c_out, h, w, dtype):
    """x and dy that start 2 bytes past a 16-byte boundary: the kernel
    stages them element by element and gives the same sums."""
    dt = getattr(torch, dtype)
    x, dy, _ = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 9)
    xu = torch.empty(x.numel() + 1, dtype=dt, device=cuda)[1:].view(x.shape)
    dyu = torch.empty(dy.numel() + 1, dtype=dt, device=cuda)[1:].view(dy.shape)
    xu.copy_(x)
    dyu.copy_(dy)
    got = conv_nl.conv3x3_nl_dw(xu, dyu, h, w)
    want = conv_nl.conv3x3_nl_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, conv_nl.conv3x3_nl_dw(xu, dyu, h, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [
    (20, 64, 128, 24, 24), (20, 128, 128, 12, 12), (160, 128, 128, 24, 24), (3, 72, 128, 20, 12),
    (2, 64, 128, 8, 300),
])
def test_k5dw_stays_inside_its_workspace(cuda, n, c_in, c_out, h, w, dtype):
    """The C function through the port's binding, with the workspace it
    reports for these shapes plus a tail of sentinels: the sums are right
    and the tail is untouched, for either dtype's route."""
    dt = getattr(torch, dtype)
    x, dy, _ = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 10)
    size = conv_nl._fn("conv3x3_nl_dw_workspace")(n, c_in, c_out, h, w)
    assert size >= 9 * c_in * c_out
    work = torch.full((size + 4096,), 1234.5, dtype=torch.float32, device=cuda)
    out = torch.empty((9 * c_in, c_out), dtype=torch.float32, device=cuda)
    conv_nl._launch("conv3x3_nl_dw", "sentinel test", x, x.data_ptr(), dy.data_ptr(),
                    work.data_ptr(), out.data_ptr(), n, c_in, c_out, h, w)
    want = conv_nl.conv3x3_nl_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    assert bool((work[size:] == 1234.5).all())
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * want.abs().max().item())


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


# K6 and K6dx where the tensor-core kernel's tiling is cut unevenly: bands
# of unequal height (48^2 at N = 20 in 13 bands of 4 and 3 rows; 37 rows in
# 13 bands of 3 and 2; 27 rows in 7 bands of 4 and 3 with two tiles a block;
# 21 rows at odd N = 33), odd N, W = 8 (one pixel block a row), W = 520
# (column windows of 5 to 8 blocks), C_in 8, 24, 40 and 12 (partial stages
# of 16; 12 also stages the wall element by element, and so does the dx of
# 12 and 13 channels), C_out 1, 13 and 56 (partial m-tiles), and dx's C_in
# of 1, 13 and 56 (the forward's C_out)
B8_EDGE_SHAPES = [
    (3, 8, 1, 11, 8), (5, 24, 13, 13, 16), (2, 40, 56, 9, 520), (1, 8, 64, 7, 520),
    (3, 64, 13, 19, 40), (7, 16, 56, 5, 8), (2, 12, 20, 6, 16), (20, 24, 40, 48, 48),
    (4, 56, 24, 17, 64), (20, 8, 16, 37, 16), (64, 24, 40, 27, 16), (33, 16, 8, 21, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", B8_SHAPES + B8_EDGE_SHAPES)
def test_k6_and_k6dx_match_plain(cuda, n, c_in, c_out, h, w, dtype):
    """Forward and dx against the plain version, each launched twice: the
    two launches agree bit for bit (one mma chain per output, no atomics)."""
    dt = getattr(torch, dtype)
    x, dy, w_all = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 7)
    got = conv_b8.conv3x3_b8(x, w_all, h, w)
    again = conv_b8.conv3x3_b8(x, w_all, h, w)
    want = conv_b8.conv3x3_b8_plain(x, w_all, h, w)
    got_dx = conv_b8.conv3x3_b8_dx(dy, w_all, h, w)
    again_dx = conv_b8.conv3x3_b8_dx(dy, w_all, h, w)
    want_dx = conv_b8.conv3x3_b8_plain(dy, conv_chw.flip_wall(w_all).contiguous(), h, w)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (n, c_out, h * w)
    assert got_dx.dtype == dt and got_dx.shape == (n, c_in, h * w)
    for g, wt in ((got, want), (got_dx, want_dx)):
        scale = wt.float().abs().max().item()
        atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
        torch.testing.assert_close(g.float(), wt.float(), rtol=0, atol=atol)
    assert torch.equal(got, again) and torch.equal(got_dx, again_dx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6dx_reads_the_unflipped_wall(cuda, dtype, monkeypatch):
    """On the card conv3x3_b8_dx folds the flip into the kernel's wall
    reads: it builds no flipped copy of the wall, and one call launches one
    kernel, K6's."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
        _group,
    )

    dt = getattr(torch, dtype)
    _, dy, w_all = _nl_inputs(cuda, 3, 24, 40, 12, 16, dt, 9)
    want = conv_b8.conv3x3_b8_plain(dy, conv_chw.flip_wall(w_all).contiguous(), 12, 16)
    conv_b8.conv3x3_b8_dx(dy, w_all, 12, 16)  # built and loaded before the trace

    def refuse(_w):
        raise AssertionError("flip_wall called on the card")

    monkeypatch.setattr(conv_chw, "flip_wall", refuse)
    monkeypatch.setattr(conv_b8, "flip_wall", refuse)
    torch.cuda.synchronize()
    names, got = _traced_kernels(lambda: conv_b8.conv3x3_b8_dx(dy, w_all, 12, 16))
    assert len(names) == 1 and _group(names[0]).startswith("K6 "), names
    scale = want.float().abs().max().item()
    atol = _bf16_ulp(scale) if dtype == "bfloat16" else 1e-5 * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def test_k6_refuses_an_unaligned_bf16_input(cuda):
    """The tensor-core K6 lands x in 16-byte pieces: a bf16 x that starts 2
    bytes past a 16-byte boundary is refused, not run another way."""
    x = torch.randn(2 * 8 * 64 + 1, device=cuda).to(torch.bfloat16)[1:].view(2, 8, 64)
    w_all = torch.randn(16, 72, device=cuda).to(torch.bfloat16)
    before = conv_b8.conv3x3_b8.launches
    with pytest.raises(ValueError):
        conv_b8.conv3x3_b8(x, w_all, 8, 8)
    assert conv_b8.conv3x3_b8.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", B8_SHAPES + B8_EDGE_SHAPES)
def test_k6dw_matches_plain_and_repeats_bit_for_bit(cuda, n, c_in, c_out, h, w, dtype):
    """bf16 on the tensor cores at ragged bands and windows (W = 8 and 520:
    odd window widths), C_in of 8, 12, 24 and 40 (partial channel groups)
    and C_out of 1, 13 and 56 (partial m-tiles); f32 on the CUDA cores."""
    dt = getattr(torch, dtype)
    x, dy, _ = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 8)
    got = conv_b8.conv3x3_b8_dw(x, dy, h, w)
    again = conv_b8.conv3x3_b8_dw(x, dy, h, w)
    want = conv_b8.conv3x3_b8_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (9 * c_in, c_out)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert torch.equal(got, again)


def test_k6dw_refuses_unaligned_bf16_operands(cuda):
    """The tensor-core K6dw lands x and dy in 16-byte pieces: a bf16 x or dy
    that starts 2 bytes past a 16-byte boundary is refused before any
    launch, not run another way."""
    x, dy, _ = _nl_inputs(cuda, 2, 16, 16, 8, 16, torch.bfloat16, 14)
    xu = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    dyu = torch.empty(dy.numel() + 1, dtype=dy.dtype, device=cuda)[1:].view(dy.shape)
    xu.copy_(x)
    dyu.copy_(dy)
    before = conv_b8.conv3x3_b8_dw.launches
    for a, d in ((xu, dy), (x, dyu)):
        with pytest.raises(ValueError):
            conv_b8.conv3x3_b8_dw(a, d, 8, 16)
    assert conv_b8.conv3x3_b8_dw.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,c_in,c_out,h,w", [
    (20, 16, 16, 192, 192), (20, 64, 64, 48, 48), (1, 8, 64, 7, 520), (3, 64, 13, 19, 40),
    (2, 64, 1, 2, 8),
])
def test_k6dw_stays_inside_its_workspace(cuda, n, c_in, c_out, h, w, dtype):
    """The C function through the port's binding, with the workspace it
    reports for these shapes plus a tail of sentinels: the sums are right
    and the tail is untouched, for either dtype's route."""
    dt = getattr(torch, dtype)
    x, dy, _ = _nl_inputs(cuda, n, c_in, c_out, h, w, dt, 15)
    size = conv_b8._fn("conv3x3_b8_dw_workspace")(n, c_in, c_out, h, w)
    assert size >= 9 * c_in * c_out
    work = torch.full((size + 4096,), 1234.5, dtype=torch.float32, device=cuda)
    out = torch.empty((9 * c_in, c_out), dtype=torch.float32, device=cuda)
    conv_b8._launch("conv3x3_b8_dw", "sentinel test", x, x.data_ptr(), dy.data_ptr(),
                    work.data_ptr(), out.data_ptr(), n, c_in, c_out, h, w)
    want = conv_b8.conv3x3_b8_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    assert bool((work[size:] == 1234.5).all())
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * want.abs().max().item())


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


# ------------------------------------------------ the augmentation pipeline
def _aug_slices(n, hw):
    import numpy as np

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        make_phantom,
    )

    slices = [make_phantom(np.random.RandomState(2000 + s), hw) for s in range(n)]
    return (torch.from_numpy(np.stack([s[0] for s in slices]).astype(np.float32)),
            torch.from_numpy(np.stack([s[1] for s in slices]).astype(np.int32)))


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("name", ["ACDC_affine_elastic_intensity", "ACDC_affine_all"])
def test_augment_pipeline_on_card_matches_cpu(cuda, name):
    """The training pipeline (10 raw 224x224 slices -> [augmented ||
    original] at 192x192) on the card against the CPU on the same draws,
    by chip_smoke.py's rule: images within 1e-4 and labels equal, except
    where a sample coordinate lies within 1e-3 of the frame's edge or
    (labels) a CPU class score within 1e-3 of 0.5, at most 0.1 % of the
    pixels."""
    smoke = _chip_smoke()
    images, labels = _aug_slices(10, (224, 224))
    policy = augment.get_policy(name)
    draws = augment.draw_augment(torch.Generator().manual_seed(1), policy, 10, (224, 224))
    pipe = augment.make_batch_train_pipeline(name, (224, 224), (192, 192))
    want = pipe(draws, images, labels)
    got = pipe(draws.to(cuda), images.to(cuda), labels.to(cuda))
    assert got["image"].device.type == got["label"].device.type == cuda.type
    edge, unsure = augment.unsure_pixels(draws, images, labels, name, (224, 224), (192, 192),
                                         tol=smoke.AUG_UNSURE)
    smoke.compare_augment(torch, got, want, edge, unsure, name)


def test_warp_on_card_matches_cpu(cuda):
    """The fused image + label warp alone at 192x192, on coordinates that
    rotate, zoom and bend the frame and leave it at the corners, on the card
    against the CPU, by the same rule."""
    smoke = _chip_smoke()
    images, labels = _aug_slices(4, (192, 192))
    ys, xs = torch.meshgrid(torch.arange(192.0), torch.arange(192.0), indexing="ij")
    yc, xc = ys - 95.5, xs - 95.5
    angle = torch.tensor([0.3, -1.2, 2.0, 0.05]).view(-1, 1, 1)
    zoom = torch.tensor([1.1, 0.8, 1.25, 0.95]).view(-1, 1, 1)
    ya = (torch.cos(angle) * yc - torch.sin(angle) * xc) * zoom + 95.5 + 4 * torch.sin(xs / 17)
    xa = (torch.sin(angle) * yc + torch.cos(angle) * xc) * zoom + 95.5 + 3 * torch.cos(ys / 23)
    want_img, want_lbl = augment.warp_image_and_label_batch(images, labels, ya, xa, 4)
    got_img, got_lbl = augment.warp_image_and_label_batch(images.to(cuda), labels.to(cuda),
                                                          ya.to(cuda), xa.to(cuda), 4)
    edge = torch.stack([ya.abs(), (ya - 191).abs(), xa.abs(), (xa - 191).abs()]).amin(0) \
        <= smoke.AUG_UNSURE
    scores = augment._fused_warp_scores(images, labels, ya, xa, 4)[..., 1:]
    unsure = edge | ((scores - 0.5).abs() <= smoke.AUG_UNSURE).any(-1)
    assert bool(((ya < 0) | (ya > 191)).any())
    smoke.compare_augment(torch, {"image": got_img, "label": got_lbl},
                          {"image": want_img, "label": want_lbl}, edge, unsure, "warp")


def test_augment_pipeline_refuses_mixed_devices(cuda):
    """No fallback: draws left on the host with images on the card raise."""
    images, labels = _aug_slices(2, (64, 64))
    name = "ACDC_affine_elastic_intensity"
    draws = augment.draw_augment(torch.Generator().manual_seed(0), augment.get_policy(name), 2,
                                 (64, 64))
    with pytest.raises(RuntimeError):
        augment.make_batch_train_pipeline(name, (64, 64), (48, 48))(
            draws, images.to(cuda), labels.to(cuda))


def test_running_score_on_card_matches_cpu(cuda):
    """The validation metric's confusion update on the card (an
    ``index_add_``, no read back) against the CPU on the same label maps,
    true labels outside [0, C) included."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.metrics import (
        RunningScore,
    )

    gen = torch.Generator().manual_seed(0)
    got, want = RunningScore(4, device=cuda), RunningScore(4, device="cpu")
    for _ in range(3):
        true = torch.randint(-1, 6, (20, 192, 192), generator=gen, dtype=torch.int32)
        pred = torch.randint(0, 4, (20, 192, 192), generator=gen)
        got.update(true.to(cuda), pred.to(cuda))
        want.update(true, pred)
    assert got.confusion_matrix.device.type == cuda.type
    assert torch.equal(got.confusion_matrix.cpu(), want.confusion_matrix)
    assert got.get_scores() == want.get_scores()


def test_one_epoch_loop_on_card_checkpoints_and_loads_back(cuda, tmp_path):
    """``train_network`` for one epoch at 32x32, batch 4, bf16, on the card:
    finite losses, K1 launched; the best checkpoint loads into a predictor
    that validates as the loop did, and a snapshot loads back bit for bit."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
        ExperimentConfig,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
        EvalBatcher,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        SyntheticSegDataset,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (
        checkpoint,
        driver,
    )

    cfg = ExperimentConfig.from_dict({"data": {"pad_size": [40, 40, 1],
                                               "crop_size": [32, 32, 1]},
                                      "learning": {"batch_size": 4, "lr": 1e-3}})
    trainer = CooperativeTrainer(cfg.latent_DA, learning_rate=1e-3,
                                 compute_dtype=torch.bfloat16, device=cuda)
    val = SyntheticSegDataset(length=2, pad_size=(40, 40), seed=1)
    conv_chw.conv3x3_chw.launches = 0
    result = driver.train_network("card", SyntheticSegDataset(length=4, pad_size=(40, 40)),
                                  val, trainer, cfg, str(tmp_path), seed=0, max_epochs=1)
    assert conv_chw.conv3x3_chw.launches > 0
    assert result.best_epoch == 0
    assert bool(torch.isfinite(torch.from_numpy(result.epochs[0].losses)).all())
    for tag in ("best", "0"):
        predictor = CooperativePredictor(compute_dtype=torch.bfloat16, device=cuda, seed=3)
        checkpoint.load_model(predictor, str(tmp_path / tag / "checkpoints"))
        for (ka, a), (kb, b) in zip(trainer.model.state_dict().items(),
                                    predictor.state_dict().items()):
            assert ka == kb and torch.equal(a, b), ka
        running = driver.eval_dispatch(predictor, EvalBatcher(val, 4, (40, 40), (32, 32),
                                                              device=cuda))
        assert torch.equal(running.confusion_matrix.cpu(),
                           torch.from_numpy(result.epochs[0].confusion))
    path = checkpoint.save_snapshot(trainer, str(tmp_path), epoch=1)
    other = CooperativeTrainer(cfg.latent_DA, learning_rate=1e-3,
                               compute_dtype=torch.bfloat16, device=cuda, seed=5)
    assert checkpoint.load_snapshot(other, path) == 1
    for (ka, a), (kb, b) in zip(trainer.model.state_dict().items(),
                                other.model.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    for p, q in zip(trainer.model.parameters(), other.model.parameters()):
        a, b = trainer.optimizer.state[p], other.optimizer.state[q]
        assert b["step"].device.type == "cpu" and float(a["step"]) == float(b["step"]) == 2
        assert b["exp_avg"].device.type == cuda.type
        assert torch.equal(a["exp_avg"], b["exp_avg"])
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


def _eval_tree(tmp_path):
    """Pid 007 x ED/ES of the synthetic ACDC tree (two volumes of 10 slices
    at 224x224) as the test entry reads it."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        make_synthetic_acdc,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        test as cli_test,
    )

    root = str(tmp_path / "tree")
    make_synthetic_acdc.main(["--out_root", root, "--pids", "007"])
    return cli_test.build_datasets(cli_test.parse_args(["--acdc_root", root]), 0)["ACDC"]


def test_eval_on_card_matches_cpu_and_launches_k1_per_chunk(cuda, tmp_path):
    """The held-out evaluation (``eval/tester.py``, float32,
    ``predict(n_iter=2)``) of a model loaded through ``convert.from_jax``
    from a JAX-initialised state (``torch_port_flax.to_flax`` of weights
    drawn from JAX's initial distributions), on the card against the CPU on
    2 volumes: each class-volume Dice within 0.01 (chip_smoke.py's eval
    bound), the predictions on at least 99.9 % of the pixels equal, and K1
    launched on every chunk, as often as the predict has stride-1 convs
    with at most 64 channels."""
    from torch_port_flax import to_flax

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
        module_state_dicts,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.eval.tester import (
        TestSegmentationNetwork,
    )

    state = convert.from_jax(*to_flax(module_state_dicts(CooperativePredictor(device="cpu",
                                                                              seed=7))))
    gpu = CooperativePredictor(device=cuda, seed=0)
    cpu = CooperativePredictor(device="cpu", seed=0)
    gpu.load_state_dicts(state)
    cpu.load_state_dicts(state)
    dataset = _eval_tree(tmp_path)
    runs = {}
    for name, model, dev in (("card", gpu, cuda), ("cpu", cpu, "cpu")):
        tester = TestSegmentationNetwork(dataset, lambda x, m=model: m.predict(x, n_iter=2),
                                         device=dev)
        conv_chw.conv3x3_chw.launches = 0
        tester.run()
        runs[name] = (tester, conv_chw.conv3x3_chw.launches)
    card, cpu_run = runs["card"][0], runs["cpu"][0]
    assert len(card.rows) == len(cpu_run.rows) == 2
    for g, w in zip(card.rows, cpu_run.rows):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            assert abs(a - b) <= 0.01 or (a != a and b != b), (g, w)
    for g, w in zip(card.patient_results, cpu_run.patient_results):
        assert (g["pred"] == w["pred"]).mean() >= 0.999
    per_chunk = sum(isinstance(c, conv_chw.Conv) and c.uses_k1()
                    for m in (gpu.image_encoder, gpu.segmentation_decoder, gpu.shape_encoder,
                              gpu.shape_decoder) for c in m.modules())
    assert per_chunk > 0
    assert runs["card"][1] == 2 * per_chunk  # two volumes of one chunk each
    assert runs["cpu"][1] == 0


def test_test_entry_on_card(cuda, tmp_path):
    """``cli.test`` on the card (its default device) from a checkpoint of
    the port's ``.pth`` files: 2 rows of finite Dice, the same as the CPU
    entry's within 0.01."""
    import csv
    import types

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        make_synthetic_acdc,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        test as cli_test,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (
        checkpoint,
    )

    ckpt = checkpoint.save_model(types.SimpleNamespace(model=CooperativePredictor(
        device="cpu", seed=11)), str(tmp_path / "model"), "best")
    make_synthetic_acdc.main(["--out_root", str(tmp_path / "tree"), "--pids", "008"])
    rows = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / dev
        cli_test.main(["--checkpoint", ckpt, "--acdc_root", str(tmp_path / "tree"),
                       "--save_dir", str(out)] + (["--device", "cpu"] if dev == "cpu" else []))
        with open(out / "ACDC" / "detail.csv", newline="") as f:
            rows[dev] = list(csv.reader(f))[1:]
    assert [r[0] for r in rows["cuda"]] == [r[0] for r in rows["cpu"]] == ["008_ED", "008_ES"]
    for g, w in zip(rows["cuda"], rows["cpu"]):
        for a, b in zip(g[1:], w[1:]):
            assert abs(float(a) - float(b)) <= 0.01, (g, w)


@pytest.mark.parametrize("name", ["RandomBias", "RandomSpike", "RandomGhosting", "RandomMotion"])
def test_corruption_on_card_matches_cpu(cuda, name):
    """Each ACDC-C corruption of a 10-slice 192x192 volume on the card
    against the CPU on the same draws (three seeds), within chip_smoke.py's
    ACDC_C_ATOL; the spike positions and ghost lines computed on the card
    equal the CPU's; every slice in [0, 1]."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        corruptions,
    )

    smoke = _chip_smoke()
    vol = torch.rand(10, 192, 192, generator=torch.Generator().manual_seed(3))
    vol[3] *= 0.25
    for seed in range(3):
        draws = corruptions.draw_corruption(torch.Generator().manual_seed(seed), name)
        want = corruptions.corrupt_volume(draws, vol)
        on_card = draws.to(cuda)
        got = corruptions.corrupt_volume(on_card, vol.to(cuda))
        assert got.device.type == cuda.type and got.dtype == torch.float32
        err = (got.cpu() - want).abs().max().item()
        assert err <= smoke.ACDC_C_ATOL, (name, seed, err)
        assert got.amin().item() >= -1e-6 and got.amax().item() <= 1 + 1e-6
        if name == "RandomSpike":
            for a, b in zip(corruptions.spike_positions(on_card, 192, 192),
                            corruptions.spike_positions(draws, 192, 192)):
                assert torch.equal(a.cpu(), b)


def test_generator_on_card_matches_cpu(cuda, tmp_path):
    """``cli.generate_acdc_c`` on the card (its default device) against the
    same command on the CPU: the same files, every image within
    ACDC_C_ATOL."""
    import os

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        generate_acdc_c,
        make_synthetic_acdc,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.nifti import (
        read_nrrd,
    )

    smoke = _chip_smoke()
    tree = str(tmp_path / "tree")
    make_synthetic_acdc.main(["--out_root", tree, "--pids", "007", "--n_slices", "4"])
    argv = ["--acdc_root", tree, "--seeds", "0", "1"]
    card = generate_acdc_c.main(argv + ["--out_root", str(tmp_path / "card")])
    cpu = generate_acdc_c.main(argv + ["--out_root", str(tmp_path / "cpu"), "--device", "cpu"])
    assert [os.path.relpath(p, tmp_path / "card") for p in card] == [
        os.path.relpath(p, tmp_path / "cpu") for p in cpu]
    assert len(card) == 2 * 4 * 2
    for a, b in zip(card, cpu):
        (x, sx), (y, sy) = read_nrrd(a), read_nrrd(b)
        assert sx == sy and x.shape == y.shape
        assert float(abs(x - y).max()) <= smoke.ACDC_C_ATOL, a


def test_loop_first_batch_and_step_on_card_match_cpu(cuda):
    """``cli.train --synthetic``'s first batch and first train step (the
    loop's batcher, draw source and trainer, seed 40, float32, batch 4) on
    the card against the same on the CPU: equal initial weights, images
    within AUG_IMAGE_ATOL, at most AUG_MAX_UNSURE of the labels apart, each
    loss within 1e-3 of the CPU's, relative."""
    from functools import partial

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli import (
        train as cli_train,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
        CooperativeBatcher,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import driver

    smoke = _chip_smoke()
    runs = {}
    for dev in ("cpu", "cuda"):
        args = cli_train.parse_args(["--synthetic", "--seed", "40", "--batch_size", "4",
                                     "--device", dev])
        cfg, _ = cli_train.load_config(args)
        train_set, _ = cli_train.build_datasets(cfg, args)
        trainer = cli_train.build_trainer(cfg, args)
        weights = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        batcher = CooperativeBatcher(
            train_set, batch_size=cfg.learning.batch_size, policy_name=cfg.data.data_aug_policy,
            pad_hw=cfg.data.pad_hw, crop_hw=cfg.data.crop_hw, num_classes=trainer.num_classes,
            seed=args.seed, device=dev)
        source = driver._OnDevice(driver.GeneratorDraws(args.seed + 1), torch.device(dev))
        batch = next(iter(batcher.epoch(partial(source.augment, 0))))
        draws = source.step(batch["image"].shape[0], cfg.data.crop_hw, trainer.latent_da)
        metrics = trainer.train_step(batch["image"], batch["label"], draws)
        runs[dev] = dict(weights=weights, image=batch["image"].cpu(), label=batch["label"].cpu(),
                         losses={k: float(v) for k, v in metrics.items()})
    cpu, card = runs["cpu"], runs["cuda"]
    assert all(torch.equal(cpu["weights"][k], card["weights"][k]) for k in cpu["weights"])
    assert (card["image"] - cpu["image"]).abs().max().item() <= smoke.AUG_IMAGE_ATOL
    assert (card["label"] != cpu["label"]).float().mean().item() <= smoke.AUG_MAX_UNSURE
    for k, v in cpu["losses"].items():
        assert abs(card["losses"][k] - v) <= 1e-3 * abs(v), (k, card["losses"][k], v)


# what cli/fingerprint.py printed for ``cli.train --synthetic --seed 40``
# on the CPU of the machine without a card (torch 2.13, float32): the
# initial weights per module [sum, sum of magnitudes], the loop's first
# batch and its draws, and the printed total loss of epoch 0
SEED40_FINGERPRINT = {
    "weights": {
        "image_encoder": [1174.6895386615265, 47123.90627765826],
        "segmentation_decoder": [250.83442858121276, 8428.824090746222],
        "shape_encoder": [891.244073824254, 36820.035105427545],
        "shape_decoder": [275.2300761273185, 8412.937298341498],
        "image_decoder": [228.19469987941488, 13517.991796717994]},
    "batch": {"image_sum": 405823.92228704784, "image_sq_sum": 264139.75596719305,
              "label_counts": [660856, 15348, 17525, 43551]},
    "augment_draws": {
        "flip_h": 4.783311486244202, "flip_v": 5.672303020954132,
        "contrast": 4.70240718126297, "brightness": 5.855767846107483,
        "rotation": 4.08722859621048, "shift_y": 4.724246621131897,
        "shift_x": 5.42367559671402, "shear": 6.553830981254578, "zoom": 4.454823434352875,
        "group": 45.0, "elastic_alpha": 4.129169523715973,
        "elastic_sigma": 5.670035779476166, "elastic_dx": 251031.32354009151,
        "elastic_dy": 251061.2032110095, "gate_intensity": 5.7052541971206665,
        "gate_elastic": 4.536974132061005},
    "step_draws": {"noise": -877.4557992038802, "image.branch": 0, "image.keep": 1297.0,
                   "shape.branch": 2, "shape.p": 0.3797607123851776,
                   "shape.soft": 622.9784609973431},
    "epoch0_total": 17.236066818237305,
}
EPOCH0_RTOL = 1e-2


def test_seed40_start_on_card_equals_the_cpu_run(cuda):
    """``cli.train --synthetic --bf16 --seed 40`` on the card starts where
    the same command starts on the CPU of a machine with another torch
    release: the initial weights' sums within 1e-9 (relative), the draws'
    sums equal (the same CPU generator), the first batch's image sums
    within 1e-6 (the card's augmentation is within 3e-5 a pixel of the
    CPU's) and its label counts within 0.1 % of each class, and epoch 0's
    printed total loss, on the hand kernels in bf16, within EPOCH0_RTOL =
    1e-2 of the CPU's float32 one (measured: 17.259 against 17.236)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.cli.fingerprint import (
        fingerprint,
    )

    want = SEED40_FINGERPRINT
    got = fingerprint(seed=40, epochs=1, bf16=True, device="cuda")
    for name, (s, a) in want["weights"].items():
        assert got["weights"][name][0] == pytest.approx(s, rel=1e-9, abs=1e-9), name
        assert got["weights"][name][1] == pytest.approx(a, rel=1e-9), name
    for group in ("augment_draws", "step_draws"):
        assert set(got[group]) == set(want[group]), group
        for k, v in want[group].items():
            assert got[group][k] == pytest.approx(v, rel=1e-12, abs=1e-12), (group, k)
    for k in ("image_sum", "image_sq_sum"):
        assert got["batch"][k] == pytest.approx(want["batch"][k], rel=1e-6), k
    for g, w in zip(got["batch"]["label_counts"], want["batch"]["label_counts"]):
        assert abs(g - w) <= 1e-3 * w
    assert got["epochs"][0]["total"] == pytest.approx(want["epoch0_total"], rel=EPOCH0_RTOL)


# the configurations of the step beside the main path's (trainer keywords)
STEP_VARIANTS = {
    "separate_training": {"separate_training": True},
    "share_code": {"network_type": "FCN_16_standard_share_code"},
    "w_o_filter": {"network_type": "FCN_16_standard_w_o_filter"},
    "dropout": {"encoder_dropout": 0.3, "decoder_dropout": 0.2},
    "remat": {"remat": True},
    "saliency_bn_update": {"saliency_bn_update": True},
    "fused_stn": {"fused_stn": True},
    "fused_ftn": {"fused_ftn": True},
    "fused_ftn_s2_nl": {"fused_ftn": True, "conv_s2": True, "conv_nl": True},
}


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_train_step_variant_on_card_matches_cpu(cuda, variant):
    """An f32 step of each configuration on the card against the plain path
    on the CPU, held as test_train_step_nl_on_card_matches_cpu holds
    ``conv_nl``'s (losses within 1e-4, Adam's first moments within twice
    the CPU step's own move under a 1e-6 input move), and K1's, K1 dx's,
    K2's and K3's launches equal to ``expected_launches`` (``remat``'s
    recompute adds a K1 forward per conv of the loss graph)."""
    kw = STEP_VARIANTS[variant]
    lda = LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                         shape_code=MaskConfig("ce", "spatial"))
    plan = CooperativeTrainer(lda, device="cpu", **kw)
    draws = draw_step(torch.Generator().manual_seed(0), 2, (64, 64), lda, **plan.draw_kwargs())
    gen = torch.Generator().manual_seed(0)
    image = torch.rand((2, 64, 64, 1), generator=gen)
    label = torch.randint(0, 4, (2, 64, 64), generator=gen)

    def step(device, x):
        trainer = CooperativeTrainer(lda, device=device, seed=0, **kw)
        metrics = trainer.train_step(x.to(device), label.to(device), draws.to(device))
        mu, _ = trainer.adam_moments()
        return metrics, torch.cat([v.detach().cpu().double().flatten()
                                   for m in mu for v in mu[m].values()])

    wrappers = (conv_chw.conv3x3_chw, conv_chw.conv3x3_chw_dx, conv_chw.conv3x3_chw_dw,
                pmask.percentile_mask)
    before = [f.launches for f in wrappers]
    got, g_mu = step(cuda, image)
    want_launches = plan.expected_launches({"image": draws.image.branch,
                                            "shape": draws.shape.branch})
    assert [f.launches - b for f, b in zip(wrappers, before)] == [
        want_launches[k] for k in ("conv3x3_chw", "conv3x3_chw_dx", "conv3x3_chw_dw",
                                   "percentile_mask")]
    want, c_mu = step("cpu", image)
    sign = torch.randint(0, 2, image.shape, generator=torch.Generator().manual_seed(1)) * 2 - 1
    _, m_mu = step("cpu", image * (1 + 1e-6 * sign))
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-7, k
    assert (g_mu - c_mu).norm() <= 2 * (m_mu - c_mu).norm()


# ------------------------------------------------------------- baselines
@pytest.mark.parametrize("network", ["UNet_16", "IN_SN_UNet_16"])
def test_segmentation_solver_step_on_card_matches_cpu(cuda, network):
    """One f32 SegmentationSolver step, card against CPU, held by
    chip_smoke.py's ``baseline_train_check`` (losses, gradients and
    updates against the CPU step's own sensitivity, buffers within 1e-4)."""
    import chip_smoke
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        phantom_batch,
    )

    image, label = phantom_batch(seed=3, n=2)
    chip_smoke.baseline_train_check(torch, network, image, label, 1, "cuda")


def test_fcn16_bf16_predict_on_card_matches_f32(cuda):
    """FCN_16 with bf16 convs on the card against its f32 twin (same
    weights), held by chip_smoke.py's ``compare_bf16``: against the bf16
    solver on the CPU, at most twice what bf16 costs there against f32."""
    import chip_smoke
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        phantom_batch,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.segmentation import (
        SegmentationSolver,
    )

    x = torch.from_numpy(phantom_batch(seed=4, n=4)[0])
    card16 = SegmentationSolver("FCN_16", compute_dtype=torch.bfloat16, device="cuda", seed=2)
    cpu16 = SegmentationSolver("FCN_16", compute_dtype=torch.bfloat16, device="cpu", seed=2)
    card32 = SegmentationSolver("FCN_16", device="cuda", seed=2)
    before = conv_chw.conv3x3_chw.launches
    got = card16.predict(x.to("cuda")).cpu()
    assert conv_chw.conv3x3_chw.launches - before == card16.expected_launches()["conv3x3_chw"]
    assert got.dtype == torch.float32 and got.shape == (4, 192, 192, 4)
    chip_smoke.compare_bf16(got, cpu16.predict(x), card32.predict(x.to("cuda")).cpu(),
                            "FCN_16 bf16 on the card")


def test_jax_msgpack_checkpoint_loads_on_card(cuda, tmp_path):
    """A JAX solver's ``save_model`` file (written in flax's layout by
    ``torch_port_flax``, no JAX here) loads into a solver on the card, which
    then predicts what the CPU solver it came from predicts."""
    from torch_port_flax import baseline_to_flax, write_flax_msgpack

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        phantom_batch,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.segmentation import (
        SegmentationSolver,
    )

    src = SegmentationSolver("SN_UNet_16", device="cpu", seed=3)
    x = torch.from_numpy(phantom_batch(seed=5, n=2)[0])
    src.train_step(x, torch.from_numpy(phantom_batch(seed=5, n=2)[1]))
    params, stats = baseline_to_flax(src.model)
    path = str(tmp_path / "SN_UNet_16.msgpack")
    write_flax_msgpack(path, {"params": params, "batch_stats": stats})
    card = SegmentationSolver("SN_UNet_16", device="cuda", seed=4)
    card.load_model(path)
    for (k, v), w in zip(src.model.state_dict().items(), card.model.state_dict().values()):
        assert torch.equal(v, w.cpu()), k
    want = src.predict(x)
    got = card.predict(x.to("cuda")).cpu()
    assert (got - want).abs().max() <= 2e-4 + 4e-6 * want.abs().max()


# ------------------------------------------------------ CUDA graphs (fused)
GRAPH_PAD, GRAPH_CROP = (40, 40), (32, 32)
GRAPH_POLICY = "ACDC_affine_elastic_intensity"
MASK_TYPES = ("dropout", "spatial", "channel")


def _graph_batcher(cuda, n=4, warp="composed"):
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.loader import (
        CooperativeBatcher,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        SyntheticSegDataset,
    )

    return CooperativeBatcher(SyntheticSegDataset(length=n, pad_size=GRAPH_PAD, seed=0), 4,
                              GRAPH_POLICY, GRAPH_PAD, GRAPH_CROP, device=cuda, warp=warp)


def _graph_pair(cuda, lda, warp="composed", **kw):
    """A batcher (its augmentation's warp arm ``warp``) and two capturable
    bf16 trainers from one seed, each with its StepGraphs: the first is
    replayed, the second runs its body eagerly."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        StepGraphs,
    )

    batcher = _graph_batcher(cuda, warp=warp)
    trainers = [CooperativeTrainer(lda, learning_rate=1e-3, compute_dtype=torch.bfloat16,
                                   device=cuda, seed=0, capturable=True, **kw)
                for _ in range(2)]
    graphs = [StepGraphs(t, batcher.pipeline_idx, *batcher.device_dataset()) for t in trainers]
    return batcher, trainers, graphs


def _staged(cuda, batcher, trainer, n_steps, seed=1):
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
        stage_draws,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.driver import (
        GeneratorDraws,
    )

    return stage_draws(GeneratorDraws(seed), [0], n_steps, batcher.policy, batcher.raw_bs,
                       GRAPH_PAD, batcher.step_batch, GRAPH_CROP, trainer.latent_da, cuda,
                       **trainer.draw_kwargs())


def _assert_same_state(a, b):
    """Parameters, BN buffers and Adam's state (step, moments) bit for bit."""
    for (ka, x), (kb, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(x, y), ka
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sa["step"].device == p.device and float(sa["step"]) == float(sb["step"])
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def _graphed_against_eager(cuda, lda, n_steps=3, warp="composed", **kw):
    """``n_steps`` steps on the same indices and staged draws: replayed
    (after the first, eager and captured) against the eager body of a
    twin trainer, metrics and state bit for bit; the graph's launches at
    capture equal ``expected_launches``.  Returns the graphs."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        branch_key,
    )

    batcher, trainers, graphs = _graph_pair(cuda, lda, warp, **kw)
    staged = _staged(cuda, batcher, trainers[0], n_steps)
    idx = torch.tensor([[0, 1], [2, 3], [3, 0], [1, 2]] * n_steps, device=cuda)[:n_steps]
    got = torch.empty((n_steps, 10), device=cuda)
    for k, s in enumerate(staged.steps):
        graphs[0].run(idx[k], s, got[k])
        want = graphs[1].body(idx[k], s.augment, s.step)
        assert torch.equal(got[k], want), (k, got[k].tolist(), want.tolist())
    _assert_same_state(*trainers)
    for key, captured in graphs[0].graphs.items():
        branches = {"image": key[0], "shape": key[1]}
        want_launches = trainers[0].expected_launches(branches)
        assert {k: captured.launches[k] for k in want_launches} == want_launches
    assert sum(graphs[0].replays.values()) == n_steps - len(graphs[0].graphs)
    assert set(graphs[0].graphs) == {branch_key(s.step) for s in staged.steps}
    return graphs[0]


@pytest.mark.parametrize("image_type", MASK_TYPES)
@pytest.mark.parametrize("shape_type", MASK_TYPES)
def test_graphed_step_bit_equals_capturable_eager(cuda, image_type, shape_type):
    """Each of the 9 branch tuples: three steps, the first eager then
    captured, two replays, against a capturable trainer's eager steps on
    the same draws, bit for bit (the same kernels in the same order)."""
    lda = LatentDAConfig(image_code=MaskConfig("mse", image_type),
                         shape_code=MaskConfig("ce", shape_type))
    graphs = _graphed_against_eager(cuda, lda)
    assert len(graphs.graphs) == 1


@pytest.mark.parametrize("route", ["conv_s2", "conv_nl"])
def test_graphed_step_on_the_other_routes(cuda, route):
    """One branch tuple under ``conv_s2`` (K4, K4dx, K4dw inside the graph)
    and under ``conv_nl`` (K5, K5dx, K5dw, the latter in thread-block
    clusters), replayed against the eager step bit for bit."""
    lda = LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                         shape_code=MaskConfig("ce", "spatial"))
    graphs = _graphed_against_eager(cuda, lda, **{route: True})
    captured = next(iter(graphs.graphs.values()))
    k = "conv3x3s2" if route == "conv_s2" else "conv3x3_nl"
    assert all(captured.launches[k + s] > 0 for s in ("", "_dx", "_dw"))


@pytest.mark.parametrize("variant", list(STEP_VARIANTS) + ["warp_two_gather",
                                                           "warp_sequential"])
def test_graphed_step_variant_bit_equals_eager(cuda, variant):
    """Each of the step's other configurations that ``cli.train`` accepts
    (the fused arms too), and the augmentation's two other warp arms,
    graphed under ``mask_type="random"`` against its eager step."""
    kw = STEP_VARIANTS.get(variant, {})
    warp = variant[len("warp_"):] if variant.startswith("warp_") else "composed"
    _graphed_against_eager(cuda, LatentDAConfig(), n_steps=4, warp=warp, **kw)


def test_two_eager_steps_repeat_bit_for_bit(cuda):
    """Two non-capturable trainers from one seed, two bf16 steps each at
    full width (batch 20 at 192x192) on the same draws: metrics and state
    bit for bit equal.  Every step on the card runs on deterministic cuDNN;
    on cuDNN's default backward algorithms (sums with atomics) such steps
    part after the first update (measured on an H100)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        phantom_batch,
    )

    image, label = (torch.from_numpy(a).to(cuda) for a in phantom_batch(seed=7, n=20))
    lda = LatentDAConfig()
    trainers = [CooperativeTrainer(lda, compute_dtype=torch.bfloat16, device=cuda, seed=0)
                for _ in range(2)]
    assert not any(t.capturable for t in trainers)
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        draws = draw_step(gen, 20, (192, 192), lda, device=cuda)
        got = [t.train_step(image, label, draws) for t in trainers]
        assert all(torch.equal(got[0][k], got[1][k]) for k in got[0])
    for (k, a), b in zip(trainers[0].model.state_dict().items(),
                         trainers[1].model.state_dict().values()):
        assert torch.equal(a, b), k
    for p, q in zip(trainers[0].model.parameters(), trainers[1].model.parameters()):
        sa, sb = trainers[0].optimizer.state[p], trainers[1].optimizer.state[q]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_nine_graphs_share_one_pool(cuda):
    """All 9 branch tuples captured into one pool: the pool's own segments
    (``graphs.pool_bytes``, apart from the eager steps' caches) with nine
    graphs stay under twice those with one."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
        StagedDraws,
        draw_step,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        StepGraphs,
        pool_bytes,
    )

    batcher = _graph_batcher(cuda)
    trainer = CooperativeTrainer(LatentDAConfig(), learning_rate=1e-3,
                                 compute_dtype=torch.bfloat16, device=cuda, capturable=True)
    graphs = StepGraphs(trainer, batcher.pipeline_idx, *batcher.device_dataset())
    gen = torch.Generator().manual_seed(0)
    pairs = []
    for image_type in MASK_TYPES:
        for shape_type in MASK_TYPES:
            lda = LatentDAConfig(image_code=MaskConfig("mse", image_type),
                                 shape_code=MaskConfig("ce", shape_type))
            pairs.append((augment.draw_augment(gen, batcher.policy, 2, GRAPH_PAD),
                          draw_step(gen, 4, GRAPH_CROP, lda)))
    staged = StagedDraws(pairs, cuda)
    idx = torch.tensor([0, 1], device=cuda)
    out = torch.empty(10, device=cuda)
    reserved = []
    for s in staged.steps:
        trainer.latent_da = LatentDAConfig(
            image_code=MaskConfig("mse", MASK_TYPES[s.step.image.branch]),
            shape_code=MaskConfig("ce", MASK_TYPES[s.step.shape.branch]))
        graphs.run(idx, s, out)
        torch.cuda.synchronize()
        reserved.append(pool_bytes(graphs.pool)[0])
    assert len(graphs.graphs) == 9
    assert bool(torch.isfinite(out).all())
    assert 0 < reserved[0] and reserved[-1] < 2 * reserved[0], reserved


def _fused_cfg(**learning):
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
        ExperimentConfig,
    )

    return ExperimentConfig.from_dict({
        "data": {"pad_size": [*GRAPH_PAD, 1], "crop_size": [*GRAPH_CROP, 1]},
        "learning": {"batch_size": 4, "lr": 1e-3, **learning},
        "output": {"save_epoch_every_num_epochs": 10}})


def _fused_run(cuda, tmp_path, tag, **kw):
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        SyntheticSegDataset,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import driver

    cfg = _fused_cfg()
    trainer = CooperativeTrainer(cfg.latent_DA, learning_rate=1e-3,
                                 compute_dtype=torch.bfloat16, device=cuda, capturable=True)
    result = driver.train_network(
        tag, SyntheticSegDataset(length=4, pad_size=GRAPH_PAD, seed=0),
        SyntheticSegDataset(length=3, pad_size=GRAPH_PAD, seed=1), trainer, cfg,
        str(tmp_path / tag), seed=40, max_epochs=3, fused_epoch=True, **kw)
    return trainer, result


@pytest.mark.parametrize("mode", [{"multi_epoch": 2}, {"pipeline_epoch": True}])
def test_graphed_window_and_pipelined_fetch_equal_fused_epochs(cuda, tmp_path, mode):
    """Three epochs through ``train_network``: fused, against fused with a
    2-epoch window (epoch 0 alone, epochs 1-2 in the window) or with the
    pipelined fetch, bit for bit: losses, confusion matrices, selection,
    state."""
    import numpy as np

    a, ra = _fused_run(cuda, tmp_path, "fused")
    b, rb = _fused_run(cuda, tmp_path, "other", **mode)
    assert [e.epoch for e in ra.epochs] == [e.epoch for e in rb.epochs] == [0, 1, 2]
    for ea, eb in zip(ra.epochs, rb.epochs):
        assert np.array_equal(ea.losses, eb.losses) and np.array_equal(ea.confusion, eb.confusion)
    assert (ra.best_epoch, ra.best_score) == (rb.best_epoch, rb.best_score)
    _assert_same_state(a, b)
    assert rb.validation.replays == 2 and ra.validation.replays == 2


def test_failed_capture_raises_without_fallback(cuda):
    """A module that reads a device tensor back (``.item()``) cannot be
    captured: the graphed step raises, it does not run the step eagerly
    instead, and the card works on after."""
    lda = LatentDAConfig(image_code=MaskConfig("mse", "channel"),
                         shape_code=MaskConfig("ce", "spatial"))
    batcher, trainers, graphs = _graph_pair(cuda, lda)

    class ReadsBack(torch.nn.Module):
        def __init__(self, inner):
            super().__init__()
            self.inner = inner

        def forward(self, x):
            if x.sum().item() != x.sum().item():
                raise AssertionError("unreachable")
            return self.inner(x)

    trainers[0].model.shape_decoder = ReadsBack(trainers[0].model.shape_decoder)
    staged = _staged(cuda, batcher, trainers[0], 1)
    out = torch.empty(10, device=cuda)
    with pytest.raises(RuntimeError):
        graphs[0].run(torch.tensor([0, 1], device=cuda), staged.steps[0], out)
    assert not graphs[0].graphs and graphs[0].eager_steps == 1
    assert float(torch.ones(4, device=cuda).sum()) == 4.0


def test_capturable_snapshot_resumes_into_a_graphed_trainer(cuda, tmp_path):
    """A snapshot of a graphed trainer loads into a fresh capturable one
    (Adam's step on the card, the ``capturable`` flag kept), and the next
    graphed steps of both agree bit for bit."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import checkpoint
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.graphs import (
        StepGraphs,
    )

    lda = LatentDAConfig()
    batcher, trainers, graphs = _graph_pair(cuda, lda)
    staged = _staged(cuda, batcher, trainers[0], 6)
    idx = torch.tensor([[0, 1], [2, 3]] * 3, device=cuda)
    out = torch.empty((6, 10), device=cuda)
    for k in range(3):
        graphs[0].run(idx[k], staged.steps[k], out[k])
    path = checkpoint.save_snapshot(trainers[0], str(tmp_path), epoch=1)
    resumed = CooperativeTrainer(lda, learning_rate=1e-3, compute_dtype=torch.bfloat16,
                                 device=cuda, seed=9, capturable=True)
    assert checkpoint.load_snapshot(resumed, path) == 1
    assert all(g["capturable"] for g in resumed.optimizer.param_groups)
    _assert_same_state(trainers[0], resumed)
    other = StepGraphs(resumed, batcher.pipeline_idx, *batcher.device_dataset())
    again = torch.empty((6, 10), device=cuda)
    for k in range(3, 6):
        graphs[0].run(idx[k], staged.steps[k], out[k])
        other.run(idx[k], staged.steps[k], again[k])
    assert torch.equal(out[3:], again[3:])
    _assert_same_state(trainers[0], resumed)


def test_pointwise_f32_conv_gradients_match_cudnn_and_repeat(cuda):
    """The float32 1x1 conv on the card (``conv_chw._PointwiseF32``: its
    weight gradient one batched matmul) at the decoders' output shape,
    batch 20 at 192x192: forward, dx and dw within 1e-5 of the largest
    magnitude of cuDNN's (full f32, sums in another order), and two runs
    bit for bit equal."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((20, 16, 192, 192), device=cuda, generator=gen)
    w = torch.randn((4, 16, 1, 1), device=cuda, generator=gen)
    dy = torch.randn((20, 4, 192, 192), device=cuda, generator=gen)

    def run(fn):
        xx, ww = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y = fn(xx, ww)
        y.backward(dy)
        return y.detach(), xx.grad, ww.grad

    def plain(a, b):
        with conv_chw.full_f32(torch.float32):
            return torch.nn.functional.conv2d(a, b)

    got = run(conv_chw._PointwiseF32.apply)
    again = run(conv_chw._PointwiseF32.apply)
    with conv_chw.full_f32(torch.float32):
        want = run(plain)
    for g, a, r in zip(got, again, want):
        assert torch.equal(g, a)
        assert (g - r).abs().max() <= 1e-5 * r.abs().max()


def test_two_rank_step_on_card_matches_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card (``parallel.mesh.launch``) take one
    data-parallel f32 step of batch 4 at 64x64 (latent DA ``random``):
    the losses within 1e-4 of the one-process step's on the card, the
    running statistics within 1e-4 of each tensor's scale, the parameters
    within JAX's sharding tolerances (rtol 1e-3, atol 5e-4), the masks
    equal, the two ranks' parameters and Adam moments equal bit for bit."""
    import torch_port_ddp_ranks as R

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel import (
        mesh as pmesh,
    )

    lda = LatentDAConfig()
    model = CooperativePredictor(device="cpu", seed=0)
    sd = {n: dict(getattr(model, n).state_dict()) for n in R.MODULE_NAMES}
    gen = torch.Generator().manual_seed(4)
    image = torch.rand((4, 64, 64, 1), generator=gen)
    label = torch.randint(0, 4, (4, 64, 64), generator=gen)
    draws = draw_step(gen, 4, (64, 64), lda)
    ranks = pmesh.launch(R.step_cases, 2, "cuda", str(tmp_path / "store"),
                         args=(lda, sd, image, label, [draws], {}))
    ranks = [r[0] for r in ranks]
    one = R.one_step(lda, sd, image, label, draws, device=cuda)
    for k, w in one["metrics"].items():
        assert abs(ranks[0]["metrics"][k] - w) <= 1e-4 * abs(w) + 1e-7, (k, w)
    for name, state in one["state"].items():
        for k, w in state.items():
            got = ranks[0]["state"][name][k]
            if "running_" in k:
                torch.testing.assert_close(got, w, rtol=0, atol=1e-4 * float(w.abs().max()))
            else:
                torch.testing.assert_close(got, w, rtol=1e-3, atol=5e-4)
    for key, (branch, mask, _) in one["generation"].items():
        got = torch.cat([r["generation"][key][1] for r in ranks])
        assert ranks[0]["generation"][key][0] == branch
        assert torch.equal(got, mask), key
    for field in ("state", "mu", "nu"):
        for name, state in ranks[0][field].items():
            for k, v in state.items():
                assert torch.equal(v, ranks[1][field][name][k]), (field, name, k)



# ------------------------------------------------------------ the model tools
@pytest.mark.parametrize("config", ["float32", "bf16_conv_s2_conv_nl"])
def test_served_archive_on_card_equals_live_predictor(cuda, tmp_path, config):
    """``utils/serving.py``: an archive reloaded on the card serves any
    batch size bit for bit as the live predictor, launching K1 (and K4 and
    K5 when the archive says so) as the predictor's convs require; the
    float32 archive also against its CPU twin by ``compare_f32_probs``."""
    import chip_smoke
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import (
        serving,
    )

    bf16 = config != "float32"
    kw = dict(compute_dtype=torch.bfloat16 if bf16 else None, conv_s2=bf16, conv_nl=bf16)
    live = CooperativePredictor(device="cuda", seed=5, **kw)
    path = serving.export_predictor(live, str(tmp_path / "p"), input_hw=(64, 64), n_iter=2)
    served = serving.load_predictor(path)
    uses = {"conv3x3_chw": conv_chw.Conv.uses_k1, "conv3x3s2": conv_chw.Conv.uses_k4,
            "conv3x3_nl": conv_chw.Conv.uses_k5}

    def per_predict(uses_fn):
        m = served.predictor
        count = lambda mod: sum(isinstance(c, conv_chw.Conv) and uses_fn(c)  # noqa: E731
                                for c in mod.modules())
        return (count(m.image_encoder) + count(m.segmentation_decoder)
                + count(m.shape_encoder) + count(m.shape_decoder))

    wrappers = {"conv3x3_chw": conv_chw.conv3x3_chw, "conv3x3s2": conv_s2.conv3x3s2,
                "conv3x3_nl": conv_nl.conv3x3_nl}
    for n in (1, 3):
        x = torch.rand((n, 64, 64, 1), generator=torch.Generator().manual_seed(n))
        before = {k: w.launches for k, w in wrappers.items()}
        got = served(x)
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        assert launched == {k: per_predict(u) for k, u in uses.items()}
        assert (launched["conv3x3s2"] > 0) == bf16 and (launched["conv3x3_nl"] > 0) == bf16
        want = live.predict(x.to("cuda"), n_iter=2, softmax=True)
        assert got.shape == (n, 64, 64, 4) and got.is_cuda and torch.equal(got, want)
        if not bf16:
            twin = serving.load_predictor(path, device="cpu")
            chip_smoke.compare_f32_probs(got.cpu(), twin.predictor.predict(x, n_iter=2),
                                         "served archive, card against CPU")


def test_hard_example_arrays_on_card_match_cpu(cuda):
    """``analysis/visualize.py:hard_example_arrays`` on the card against a
    CPU twin on the same draws (float32, batch 2 at 64x64): targeted masks
    equal or swapped only next to their threshold, the corrupted images and
    segmentations within ``compare_f32`` of the twin's (decoded on the card's
    masks where a mask element swapped), and K1, K1 dx and K3 launched as
    the decoders count them (no K2: the decoders' parameters are
    detached)."""
    import chip_smoke
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.analysis import (
        visualize,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        phantom_batch,
    )

    image, label = phantom_batch(seed=6, n=2, crop_size=(64, 64), pad_size=(80, 80))
    card = CooperativeTrainer(None, device="cuda", seed=3)
    twin = CooperativeTrainer(None, device="cpu", seed=3)
    draws = visualize.draw_hard_examples(torch.Generator().manual_seed(7), 2, (128, 4, 4))
    wrappers = {"fwd": conv_chw.conv3x3_chw, "dx": conv_chw.conv3x3_chw_dx,
                "dw": conv_chw.conv3x3_chw_dw, "k3": pmask.percentile_mask}
    before = {k: w.launches for k, w in wrappers.items()}
    got = visualize.hard_example_arrays(card, image, label, draws=draws)
    launched = {k: w.launches - before[k] for k, w in wrappers.items()}
    want = visualize.hard_example_arrays(twin, image, label, draws=draws)

    def k1(name):
        return sum(isinstance(c, conv_chw.Conv) and c.uses_k1()
                   for c in getattr(card.model, name).modules())

    decoders = k1("image_decoder") + k1("segmentation_decoder")
    targeted = sum(method != "dropout" for method, _ in got)
    assert launched == {"fwd": k1("image_encoder") + k1("segmentation_decoder")
                        + len(got) * decoders + targeted * decoders,
                        "dx": targeted * decoders, "dw": 0, "k3": 2 * targeted}
    for (method, thr), ex in got.items():
        ref = want[(method, thr)]
        same = True
        for code in ("image", "shape"):
            a, b = getattr(ex, code + "_mask").cpu(), getattr(ref, code + "_mask")
            if method == "dropout":
                assert torch.equal(a, b)
                continue
            rows = (lambda m: m[:, :, 0, 0]) if method == "channel" else (
                lambda m: m[:, 0].reshape(m.shape[0], -1))
            n = chip_smoke.assert_masks_agree(torch, rows(a), rows(b),
                                              getattr(ex, code + "_saliency").cpu(),
                                              getattr(ref, code + "_saliency"), thr,
                                              f"{method} {thr} {code}")
            same &= n == 0
        ref_image, ref_seg = (ref.image, ref.seg_logits) if same else \
            chip_smoke.decode_with_masks(torch, twin, image, ex.image_mask.cpu(),
                                         ex.shape_mask.cpu())
        chip_smoke.compare_f32(ex.image.cpu(), ref_image, f"{method} {thr} image")
        chip_smoke.compare_f32(ex.seg_logits.cpu(), ref_seg, f"{method} {thr} segmentation")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staircase_conv_on_card_matches_conv2d(cuda, dtype):
    """``ops/fast_conv.py:staircase_conv3x3`` on the card at down3's first
    conv (64->128 @ 48x48, f = 2), held to twice ``F.conv2d``'s own rounding
    on the card (plus one ulp of the scale in bf16): against a float64
    reference on the CPU, the output, and in float32 the gradients of x and
    w."""
    import torch.nn.functional as F

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        fast_conv,
    )

    gen = torch.Generator().manual_seed(8)
    x = torch.rand((4, 64, 48, 48), generator=gen, dtype=torch.float64) - 0.5
    w = (torch.rand((128, 64, 3, 3), generator=gen, dtype=torch.float64) - 0.5) / 24
    dy = torch.rand((4, 128, 48, 48), generator=gen, dtype=torch.float64)

    def grads(fn, x, w, dy):
        x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(x, w)
        (y.float() * dy).sum().backward()
        return [t.detach().double().cpu() for t in (y, x.grad, w.grad)]

    want = grads(lambda a, b: F.conv2d(a, b, padding=1), x, w, dy)
    card = [t.to("cuda", dtype) for t in (x, w)] + [dy.to("cuda", torch.float32)]
    with conv_chw.full_f32(dtype):
        got = grads(fast_conv.staircase_conv3x3, *card)
        lib = grads(lambda a, b: F.conv2d(a, b, padding=1), *card)
    for what, g, li, ref in zip(("y", "dx", "dw"), got, lib, want):
        ulp = _bf16_ulp(ref.abs().max().item()) if dtype == torch.bfloat16 else 0.0
        err, own = (g - ref).abs().max().item(), (li - ref).abs().max().item()
        assert err <= 2 * own + ulp, (what, err, own)
        if dtype == torch.bfloat16:
            break  # bf16 gradients: held by the float32 case


def test_estimate_size_on_card_counts_the_call(cuda):
    """``utils/estimate.py:estimate_size`` on the card: the arguments'
    bytes, the output's, and at least the temporary the call must hold."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.utils import (
        estimate,
    )

    x = torch.ones((1024, 1024), device="cuda")
    size = estimate.estimate_size(lambda a: (a * 2 + 1).sum(), x)
    mib = x.nbytes / 2 ** 20
    assert size["params_mb"] == mib and size["output_mb"] == 4 / 2 ** 20
    assert size["temp_mb"] >= mib and size["total_mb"] >= 2 * mib
