"""Exact cubic B-spline interpolation (scipy ``map_coordinates`` order=3).

Counterpart of the JAX package's ``ops/spline.py``.  scipy's order-3
``map_coordinates`` is (1) a B-spline prefilter that turns samples into
spline coefficients, then (2) the cubic B-spline basis evaluated over each
output coordinate's 4x4 coefficient neighbourhood.  With static image
sizes the prefilter solves ``T @ coeffs = data`` (T's rows [1/6, 4/6, 1/6],
folded at the boundaries by the extension mode) as two dense matmuls with
precomputed ``T^-1`` factors; the evaluation folds out-of-range
coordinates into the domain, pads the coefficients by 2 with the mode's
extension and gathers each pixel's 4x4 neighbourhood in one gather.

The ``T^-1`` factors and the pad index vectors are numpy, cached per size
and mode (:func:`prefilter_matrix`, :func:`pad_index`); their device copies
are cached too.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

PAD = 2            # coefficient pad that folded coordinates' taps stay inside
NEAREST_PAD = 12   # scipy's edge pre-pad for mode="nearest"


def _extend_index(i: np.ndarray, n: int, mode: str) -> np.ndarray:
    """Fold integer indices into [0, n) per scipy boundary mode."""
    i = np.asarray(i)
    if mode == "nearest":
        return np.clip(i, 0, n - 1)
    if mode == "reflect":  # scipy 'reflect': d c b a | a b c d | d c b a
        period = 2 * n
        i = np.mod(i, period)
        return np.where(i >= n, period - 1 - i, i)
    if mode == "mirror":  # scipy 'mirror': d c b | a b c d | c b a
        if n == 1:
            return np.zeros_like(i)
        period = 2 * n - 2
        i = np.mod(i, period)
        return np.where(i >= n, period - i, i)
    raise NotImplementedError(mode)


@lru_cache(maxsize=None)
def prefilter_matrix(n: int, mode: str) -> np.ndarray:
    """``T^{-1}`` for the 1-D cubic B-spline interpolation system of length n.

    Row i of T: coeff weights [1/6, 4/6, 1/6] at (i-1, i, i+1) with
    out-of-range neighbors folded back per ``mode`` — the finite-domain
    equivalent of scipy's IIR prefilter on the mode-extended signal."""
    if n < 2:
        return np.ones((n, n), np.float32) * 1.5  # T = [[2/3]]
    T = np.zeros((n, n), np.float64)
    for i in range(n):
        for off, wgt in ((-1, 1.0 / 6.0), (0, 4.0 / 6.0), (1, 1.0 / 6.0)):
            T[i, int(_extend_index(i + off, n, mode))] += wgt
    return np.linalg.inv(T).astype(np.float32)


@lru_cache(maxsize=None)
def pad_index(n: int, pad: int, mode: str) -> np.ndarray:
    """Source index of each row of an axis of length n padded by ``pad`` on
    both sides with scipy ``mode``'s extension: numpy's pad modes "edge"
    (scipy "nearest"), "reflect" (scipy "mirror", no edge repeat) and
    "symmetric" (scipy "reflect", edge repeated)."""
    return _extend_index(np.arange(-pad, n + pad), n, mode).astype(np.int64)


@lru_cache(maxsize=None)
def _prefilter_on(n: int, mode: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(prefilter_matrix(n, mode)).to(device)


@lru_cache(maxsize=None)
def _pad_index_on(n: int, pad: int, mode: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pad_index(n, pad, mode)).to(device)


def pad_axes(x: torch.Tensor, pad: int, mode: str, dims=(-2, -1)) -> torch.Tensor:
    """Pad ``x`` by ``pad`` on both sides of ``dims`` with scipy ``mode``'s
    extension (see :func:`pad_index`), as one index gather an axis."""
    for d in dims:
        idx = _pad_index_on(x.shape[d], pad, mode, x.device)
        x = torch.index_select(x, d, idx)
    return x


def spline_coefficients(img: torch.Tensor, mode: str = "mirror") -> torch.Tensor:
    """Separable 2-D prefilter over the last two axes of ``img`` (..., H, W):
    coeffs = M_h @ img @ M_w^T (two matmuls), float32."""
    h, w = img.shape[-2], img.shape[-1]
    m_h = _prefilter_on(h, mode, img.device)
    m_w = _prefilter_on(w, mode, img.device)
    return torch.matmul(torch.matmul(m_h, img.float()), m_w.t())


def _bspline_weights(t):
    """Cubic B-spline basis at taps (-1, 0, 1, 2) for fractional t in [0,1)."""
    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0   # (1-t)^3 / 6
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return (w0, w1, w2, w3)


def _fold_coords(y, n: int, mode: str):
    """Fold CONTINUOUS coordinates into the base domain per scipy mode.

    For a mode-extended coefficient array, the interpolated value at y
    equals the value at the folded coordinate (the extension is symmetric
    and periodic), so folding before tap generation keeps every tap within
    2 of the domain — which a fixed 2-wide pad then covers.
      'mirror'  (c b | a b c | b a): triangle wave, period 2(n-1).
      'reflect' (b a | a b c | c b): reflection about -0.5, period 2n.
    """
    if mode == "mirror":
        if n == 1:
            return torch.zeros_like(y)
        p = float(n - 1)
        m = torch.remainder(y, 2.0 * p)
        return p - torch.abs(p - m)
    if mode == "reflect":
        z = torch.remainder(y + 0.5, 2.0 * n)
        z = torch.minimum(z, 2.0 * n - z)
        return z - 0.5
    raise NotImplementedError(mode)


def gather_4x4(cfp: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
               wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    """Cubic evaluation from padded coefficients ``cfp`` (N, Hp, Wp, C):
    for each output pixel p of sample n, ``sum_ab wy[a] wx[b] cfp[n, iy + a,
    ix + b, :]``, with ``iy``, ``ix`` (N, ...) the integer tap starts in the
    padded frame and ``wy``, ``wx`` (N, ..., 4) the tap weights.  One gather
    of the 16 taps' flat indices (every tap must lie inside the frame).
    Returns (N, ..., C)."""
    n, hp, wp, c = cfp.shape
    out_shape = iy.shape
    taps = torch.arange(4, device=cfp.device)
    flat = ((iy.reshape(n, -1, 1, 1) + taps.view(1, 1, 4, 1)) * wp
            + ix.reshape(n, -1, 1, 1) + taps.view(1, 1, 1, 4))        # (N, P, 4, 4)
    p = flat.shape[1]
    g = torch.gather(cfp.reshape(n, hp * wp, c), 1,
                     flat.reshape(n, p * 16, 1).expand(n, p * 16, c)).view(n, p, 4, 4, c)
    w = wy.reshape(n, p, 4, 1) * wx.reshape(n, p, 1, 4)                # (N, P, 4, 4)
    out = (g * w.unsqueeze(-1)).sum(dim=(2, 3))
    return out.view(*out_shape, c)


def map_coordinates_cubic(img_hwc: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                          mode: str = "mirror", prefiltered: bool = False) -> torch.Tensor:
    """scipy.ndimage.map_coordinates(order=3) for an HWC image at (ys, xs)
    float sample grids: :func:`map_coordinates_cubic_batch` of a batch of
    one."""
    return map_coordinates_cubic_batch(img_hwc[None], ys[None], xs[None], mode,
                                       prefiltered)[0]


def map_coordinates_cubic_batch(imgs: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                                mode: str = "mirror", prefiltered: bool = False) -> torch.Tensor:
    """scipy.ndimage.map_coordinates(order=3) of each NHWC image of ``imgs``
    at its own (N, ...) float sample grids ``ys``, ``xs``; returns (N, ...,
    C).  ``mode`` handles BOTH coefficient folding and out-of-range
    coordinates (like scipy).  Pass ``prefiltered=True`` when ``imgs``
    already holds spline coefficients (for 'nearest' these must be the
    12-edge-padded mirror coefficients this function builds).

    Out-of-range coordinates are mirror/reflect-folded first (exact: the
    spline of the extended signal is symmetric), so a fixed pad of 2 with
    the mode's extension covers every tap, and one gather fetches each
    pixel's 4x4 coefficient neighbourhood.
    """
    h, w = imgs.shape[1], imgs.shape[2]
    ys, xs = ys.float(), xs.float()
    if mode == "nearest":
        # scipy has no exact infinite spline extension for 'nearest': it
        # pre-pads 12 edge-replicated samples per side
        # (_prepad_for_spline_filter), prefilters the padded array with
        # 'mirror', and evaluates at the shifted (UNclamped) coordinates —
        # the spline of the edge-padded signal, not a clamped lookup.
        pad = NEAREST_PAD
        ys = torch.clamp(ys + pad, 0.0, h + 2 * pad - 1.0)
        xs = torch.clamp(xs + pad, 0.0, w + 2 * pad - 1.0)
        if not prefiltered:
            imgs = pad_axes(imgs, pad, "nearest", dims=(1, 2))
        h, w = h + 2 * pad, w + 2 * pad
        mode = "mirror"
    nchw = imgs.permute(0, 3, 1, 2).float()
    coeff = nchw if prefiltered else spline_coefficients(nchw, mode)
    ys = _fold_coords(ys, h, mode)
    xs = _fold_coords(xs, w, mode)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = torch.stack(_bspline_weights(ys - y0), dim=-1)       # (N, ..., 4)
    wx = torch.stack(_bspline_weights(xs - x0), dim=-1)
    # pad rows/cols -2..-1 and n..n+1 with the mode's extension; folded
    # coords keep every tap inside this band.  Tap a of the 4 sits at
    # padded row y0 - 1 + a + 2.
    cfp = pad_axes(coeff, PAD, mode).permute(0, 2, 3, 1)
    out = gather_4x4(cfp, y0.long() + 1, x0.long() + 1, wy, wx)
    return out.to(imgs.dtype)
