"""chip_smoke.py's layer-by-layer check of the predictor on the card
(``replay_leaves``), run here with a CPU model standing in for the card.

The stand-in computes K1's convs in another way.  Summing in another order
must pass, as the card's kernel does; rounding at another point must fail:
truncating the bf16 result instead of rounding it, or rounding f32 inputs
to TF32 (a 10-bit mantissa) as cuDNN does by default.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    phantom_batch,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PLAIN = conv_chw.conv3x3_chw_plain


def _other_order(x, w_all, H, W):
    """K1's function through F.conv2d in f32: the same sums in another
    order, rounded once."""
    n, c_in, _ = x.shape
    c_out = w_all.shape[0]
    w4 = w_all.float().view(c_out, 3, 3, c_in).permute(0, 3, 1, 2)
    y = F.conv2d(x.float().view(n, c_in, H, W), w4, None, 1, 1)
    return y.reshape(n, c_out, H * W).to(x.dtype)


def _truncated(x, w_all, H, W):
    y = PLAIN(x.float(), w_all.float(), H, W)
    return (y.view(torch.int32) & ~0xFFFF).view(torch.float32).to(x.dtype)


def _tf32(x, w_all, H, W):
    def r(t):
        return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)
    return PLAIN(r(x), r(w_all), H, W)


@pytest.mark.parametrize("dtype,stand_in,passes", [
    (torch.bfloat16, _other_order, True),
    (torch.bfloat16, _truncated, False),
    (None, _other_order, True),
    (None, _tf32, False),
])
def test_replay_leaves_tells_order_from_rounding(dtype, stand_in, passes, monkeypatch):
    image = np.ascontiguousarray(phantom_batch(seed=0, n=2)[0][:, :32, :48])
    card = CooperativePredictor(compute_dtype=dtype, device="cpu", seed=0)
    twin = CooperativePredictor(compute_dtype=dtype, device="cpu", seed=0)
    serve = card.predict

    def predict_on_stand_in(*args, **kwargs):
        with monkeypatch.context() as m:
            m.setattr(conv_chw, "conv3x3_chw_plain", stand_in)
            return serve(*args, **kwargs)

    card.predict = predict_on_stand_in
    if passes:
        chip_smoke.replay_leaves(torch, card, twin, image, "stand-in")
    else:
        with pytest.raises(AssertionError, match="CPU twin"):
            chip_smoke.replay_leaves(torch, card, twin, image, "stand-in")


def test_bound_is_the_larger_of_bytes_and_operations():
    ms, by = chip_smoke.bound(3.35e9, 1.0, "bfloat16")           # 1 ms of bytes
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = chip_smoke.bound(1.0, 67e9, "float32")              # 1 ms of f32 operations
    assert by == "operations" and abs(ms - 1.0) < 1e-12


def test_train_check_mask_rule():
    """Masks may differ only where the saliency sits within twice the
    card-vs-CPU saliency difference of the row's threshold."""
    want_sal = torch.tensor([[4.0, 3.0, 2.0, 1.0]])
    want = torch.tensor([[0.0, 1.0, 1.0, 1.0]])     # p = 0.25: idx 1, threshold 3.0
    assert chip_smoke.assert_masks_agree(torch, want, want, want_sal, want_sal, 0.25, "") == 0
    swapped = torch.tensor([[0.0, 0.0, 1.0, 1.0]])  # 3.0 masked on the card
    near = want_sal + torch.tensor([[0.0, 1e-6, 0.0, 0.0]])
    assert chip_smoke.assert_masks_agree(torch, swapped, want, near, want_sal, 0.25, "") == 1
    far = torch.tensor([[0.0, 1.0, 0.0, 1.0]])      # 2.0 masked: far from the threshold
    with pytest.raises(AssertionError):
        chip_smoke.assert_masks_agree(torch, far, want, near, want_sal, 0.25, "")


def test_recording_shapes_keeps_the_launch_counts(monkeypatch):
    """The train phase's shape recorder routes the wrappers through
    itself; a wrapper's count, kept through its module-level name, must
    come back to the wrapper."""
    from collections import Counter

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import masking
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        percentile_mask as pmask,
    )

    calls = []
    orig = conv_chw.conv3x3_chw_dw

    def counted(x, dy, H, W):            # a stand-in that counts as a CUDA launch does
        calls.append(1)
        conv_chw.conv3x3_chw_dw.launches += 1
        return orig(x, dy, H, W)

    counted.launches = 5
    monkeypatch.setattr(conv_chw, "conv3x3_chw_dw", counted)
    seen = {k: Counter() for k in chip_smoke.LAUNCH_COUNTERS}
    with chip_smoke.recording_shapes(conv_chw, pmask, masking, seen):
        conv_chw.conv3x3_chw_dw(torch.randn(1, 2, 16), torch.randn(1, 3, 16), 4, 4)
    assert conv_chw.conv3x3_chw_dw is counted and counted.launches == 6
    assert seen["conv3x3_chw_dw"] == Counter({(2, 3, 4, 4): 1}) and calls == [1]
    assert masking.percentile_mask is pmask.percentile_mask


def test_recording_shapes_routes_the_k4_wrappers():
    """The K4 wrappers live in ``ops/conv_s2.py``: the recorder routes them
    too, records their forward conv's (C_in, C_out, H, W) and puts them
    back."""
    from collections import Counter

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        conv_s2,
        masking,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        percentile_mask as pmask,
    )

    orig = chip_smoke.wrappers_of(conv_chw, pmask)
    seen = {k: Counter() for k in chip_smoke.LAUNCH_COUNTERS}
    conv = conv_chw.Conv(3, 3, 3, stride=2, padding=1, k4=True)
    with chip_smoke.recording_shapes(conv_chw, pmask, masking, seen):
        conv(torch.randn(2, 3, 8, 6, requires_grad=True)).sum().backward()
    for name in ("conv3x3s2", "conv3x3s2_dx", "conv3x3s2_dw"):
        assert seen[name] == Counter({(3, 3, 8, 6): 1}), name
    assert chip_smoke.wrappers_of(conv_chw, pmask) == orig
    assert conv_s2.conv3x3s2 is orig["conv3x3s2"]


def test_recording_shapes_routes_the_k5_and_k6_wrappers():
    """The K5 wrappers live in ``ops/conv_nl.py``, the K6 ones in
    ``ops/conv_b8.py``: the recorder routes them too, records their forward
    conv's (C_in, C_out, H, W) and puts them back; ``wrappers_of`` names
    all thirteen, each from its own module."""
    from collections import Counter

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        conv_b8,
        conv_nl,
        masking,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        percentile_mask as pmask,
    )

    orig = chip_smoke.wrappers_of(conv_chw, pmask)
    assert list(orig) == list(chip_smoke.LAUNCH_COUNTERS) and len(orig) == 13
    assert all(fn.__name__ == name for name, fn in orig.items())
    seen = {k: Counter() for k in chip_smoke.LAUNCH_COUNTERS}
    conv = conv_chw.Conv(64, 128, 3, padding=1, k5=True)
    with chip_smoke.recording_shapes(conv_chw, pmask, masking, seen):
        conv(torch.randn(2, 64, 4, 6, requires_grad=True)).sum().backward()
        x = torch.randn(2, 8, 64, requires_grad=True)
        conv_b8.conv3x3_b8_ad(x, torch.randn(16, 72, requires_grad=True), 8, 8).sum().backward()
    for name in ("conv3x3_nl", "conv3x3_nl_dx", "conv3x3_nl_dw"):
        assert seen[name] == Counter({(64, 128, 4, 6): 1}), name
    for name in ("conv3x3_b8", "conv3x3_b8_dx", "conv3x3_b8_dw"):
        assert seen[name] == Counter({(8, 16, 8, 8): 1}), name
    assert chip_smoke.wrappers_of(conv_chw, pmask) == orig
    assert conv_nl.conv3x3_nl is orig["conv3x3_nl"] and conv_b8.conv3x3_b8 is orig["conv3x3_b8"]


def test_kernel_table_names_every_wrapper():
    """The kernels JSON line carries every wrapper, each with its CUDA
    source in the port and the line of the TPU kernel's ``pallas_call``
    (or of the flipped-weight call its dx is)."""
    import re

    assert set(chip_smoke.KERNELS) == set(chip_smoke.LAUNCH_COUNTERS)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, (source, replaces) in chip_smoke.KERNELS.items():
        assert os.path.isfile(os.path.join(root, source)), source
        path, line = replaces.rsplit(":", 1)
        with open(os.path.join(root, path)) as f:
            text = f.readlines()[int(line) - 1]
        assert re.search(r"pl\.pallas_call\(|_flip_w\(w\)", text), (name, text)


@pytest.mark.parametrize("kind,shape", [("chw", (3, 8, 16, 16)), ("s2", (4, 8, 16, 12)),
                                        ("nl", (64, 128, 6, 6)), ("b8", (8, 16, 8, 16))])
@pytest.mark.parametrize("which", ["fwd", "dx", "dw"])
def test_check_conv_reaches_every_kind(kind, shape, which):
    """``check_conv`` names each kind's wrappers and plain versions right and
    builds inputs of the kernel's shapes.  It runs on the card; here a shim
    puts its tensors on the CPU, where each wrapper runs its plain version,
    so the check passes with no error (dw twice equal, and the records
    carry the shape and the tolerance)."""
    import types

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        conv_b8,
        conv_nl,
        conv_s2,
    )

    class CpuTorch(types.SimpleNamespace):
        def __getattr__(self, name):
            return getattr(torch, name)

    shim = CpuTorch(Generator=lambda device=None: torch.Generator(),
                    randn=lambda *a, device=None, **k: torch.randn(*a, **k),
                    cuda=types.SimpleNamespace(synchronize=lambda: None))
    mod = {"chw": conv_chw, "s2": conv_s2, "nl": conv_nl, "b8": conv_b8}[kind]
    rec = chip_smoke.check_conv(shim, F, conv_chw, mod, kind, which, shape, 2, "float32")
    assert rec["ok"] and rec["max_abs_err"] == 0.0 and rec["shape"] == [2, *shape]


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN2tc24conv3x3_nl_dw_mma_kernelEPKvS1_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc24conv3x3_nl_dw_mma_kernelEPKvS1_Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN2tc21conv3x3_nl_mma_kernelILb1EEEvPKv' for 'sm_90a'
ptxas info    : Function properties for _ZN2tc21conv3x3_nl_mma_kernelILb1EEEvPKv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z21conv3x3_nl_dw_partialPKfS0_Pfiiiiix' for 'sm_90a'
ptxas info    : Function properties for _Z21conv3x3_nl_dw_partialPKfS0_Pfiiiiix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 200 registers, 400 bytes cmem[0]
"""


@pytest.mark.parametrize("kernel,regs,spills", [
    ("conv3x3_nl_dw_mma_kernel", 118, 0), ("conv3x3_nl_mma_kernel", 128, 1),
    ("conv3x3_nl_dw_partial", 200, 0), ("conv3x3_b8_kernel", None, 0), ("", 200, 1),
])
def test_build_checks_read_each_kernel_of_the_log(kernel, regs, spills):
    """The build phase's register and spill checks read ptxas's report of
    the functions whose mangled name holds ``kernel``, and only those (the
    forward's name is not a part of K5dw's)."""
    assert chip_smoke.registers_of(PTXAS_LOG, kernel) == regs
    assert len(chip_smoke.spill_lines(PTXAS_LOG, kernel)) == spills
