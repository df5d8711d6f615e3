"""The staircase-packed stride-1 SAME 3x3 convolution, ported as a function
that no model path calls.

Counterpart of the JAX package's ``ops/fast_conv.py``.  It reformulates a
small-channel 3x3 conv so that each matmul is wide:

1. **Pack width**: (N, H, W, C) -> (N, H, W/f, f*C), a reshape of the
   channels-last layout (f adjacent pixels' channels are contiguous).
2. **Staircase weights**: the horizontal taps connect packed slot s' to
   slot s = s' - kj + 1, a block-tridiagonal (f*C_in, f*C_out) matrix per
   vertical tap; the conv becomes a (3, 1) conv over (H, W/f).
3. **Boundary corrections**: slot 0 needs the left neighbour's last slot
   (kj = 0), slot f-1 the right neighbour's first (kj = 2); a skinny (3,
   1) conv over the shifted slots adds them.

:func:`pick_pack_factor` (a copy) chooses f from the JAX package's cost
model of a 128x128 matrix unit; :func:`staircase_conv3x3` is plain PyTorch
(``F.conv2d`` with a (3, 1) kernel, slices and adds), so autograd
differentiates it.  It rounds where the JAX function does: the packed
conv's output in the input's dtype, the corrections added in it.

The port's layouts are kept at the interface: ``x`` NCHW, ``w`` OIHW;
the packing runs on a channels-last copy.  The JAX package routes the
stride-1 SAME 3x3 convs its Pallas kernels do not take here under
``FAST_CONV=1`` (``ops/pallas_conv.py:72,1056-1066``), off by default;
the port's ``Conv`` has no such route.  The packing was designed for a
128-wide matrix unit, and on an H100 it takes 7.3-10.0x ``F.conv2d``'s
time at 64->128 @ 48x48, batch 20, bf16 (``PERF.md`` section 5, measured
by ``chip_smoke.py``'s tools phase), so no model path would choose it.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F


def _padded(v: int, tile: int = 128) -> int:
    return max(1, -(-v // tile)) * tile


@functools.lru_cache(maxsize=None)
def pick_pack_factor(width: int, cin: int, cout: int, max_f: int = 16) -> int:
    """The packing factor minimizing padded matrix-unit work per pixel
    (the JAX package's cost model): per-tap matmuls cost 9 x the padded
    (cin, cout) per pixel, the staircase 3 x the padded (f cin, f cout)
    over f, plus its corrections.  1 when packing does not win."""
    stock = 9.0 * _padded(cin) * _padded(cout)
    best_f, best_cost = 1, stock
    for f in range(2, max_f + 1):
        if width % f:
            continue
        main = 3.0 * _padded(f * cin) * _padded(f * cout) / f
        corr = 3.0 * _padded(2 * cin) * _padded(2 * cout) / f
        if main + corr < best_cost:
            best_f, best_cost = f, main + corr
    return best_f


def staircase_matrix(w: torch.Tensor, f: int) -> torch.Tensor:
    """OIHW (C_out, C_in, 3, 3) -> the (f*C_out, f*C_in, 3, 1) block
    staircase: input slot s' feeds output slot s through tap kj = s' - s + 1."""
    c_out, c_in = w.shape[:2]
    zero = w.new_zeros(c_out, c_in, 3)
    rows = []
    for s in range(f):
        rows.append(torch.cat([w[:, :, :, sp - s + 1] if 0 <= sp - s + 1 <= 2 else zero
                               for sp in range(f)], dim=1))
    return torch.cat(rows, dim=0)[..., None]


def correction_matrix(w: torch.Tensor) -> torch.Tensor:
    """OIHW -> the (2*C_out, 2*C_in, 3, 1) block diagonal of the two
    overflow taps: the left neighbour's kj = 0 into slot 0, the right
    neighbour's kj = 2 into slot f-1."""
    zero = w.new_zeros(w.shape[:3])
    top = torch.cat([w[:, :, :, 0], zero], dim=1)
    bottom = torch.cat([zero, w[:, :, :, 2]], dim=1)
    return torch.cat([top, bottom], dim=0)[..., None]


def _conv31(x_nhwc: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The (3, 1)-window SAME conv over (H, Wp) of a channels-last tensor."""
    y = F.conv2d(x_nhwc.permute(0, 3, 1, 2), m, padding=(1, 0))
    return y.permute(0, 2, 3, 1)


def staircase_conv3x3(x: torch.Tensor, w: torch.Tensor, f: Optional[int] = None
                      ) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv of NCHW ``x`` with OIHW ``w`` (no bias) by
    width-packed staircase matmuls; W must be divisible by ``f`` (default
    :func:`pick_pack_factor`'s).  Returns NCHW in ``x``'s dtype; f = 1 is
    ``F.conv2d``."""
    n, cin, h, width = x.shape
    cout = w.shape[0]
    if f is None:
        f = pick_pack_factor(width, cin, cout)
    if f <= 1:
        return F.conv2d(x, w, padding=1)
    if width % f:
        raise ValueError(f"staircase_conv3x3: width {width} is not divisible by f = {f}")
    wp = width // f
    xp = x.permute(0, 2, 3, 1).reshape(n, h, wp, f * cin)
    out = _conv31(xp, staircase_matrix(w, f))                      # (N, H, Wp, f*C_out)
    zeros = xp.new_zeros(n, h, 1, cin)
    left = torch.cat([zeros, xp[:, :, :-1, (f - 1) * cin:]], dim=2)
    right = torch.cat([xp[:, :, 1:, :cin], zeros], dim=2)
    corr = _conv31(torch.cat([left, right], dim=-1), correction_matrix(w))
    out = torch.cat([out[..., :cout] + corr[..., :cout], out[..., cout:(f - 1) * cout],
                     out[..., (f - 1) * cout:] + corr[..., cout:]], dim=-1)
    return out.reshape(n, h, width, cout).permute(0, 3, 1, 2).to(x.dtype)
