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
