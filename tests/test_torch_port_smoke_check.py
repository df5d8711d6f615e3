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
