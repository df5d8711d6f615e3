"""The output-blocked B8 conv (K6) against the port's CHW route and cuDNN.

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.bench_b8_conv [--batch 20] [--dtype bfloat16] [--device cuda]

Counterpart of the JAX package's ``cli/bench_b8_conv.py``, the one entry
that runs K6 (no model does).  For every small-channel stage of the conv
stack (``STAGES``: image side, C_in, C_out) it runs, on the same inputs:

* ``b8``: K6 forward, and the full VJP through ``conv_b8.conv3x3_b8_ad``
  (forward, then K6 on the flipped wall for dx and K6dw for dw);
* ``chw``: the port's CHW route, K1 forward and ``conv_chw.conv3x3_chw_ad``
  (K1, K1 dx, K2);
* ``cudnn``: ``F.conv2d`` and its autograd, a yardstick the port never
  calls on this path.

It checks that the B8 route gives the CHW route's output and gradients
(bfloat16 within one ulp of scale, float32 and dw within 1e-5 of scale:
the same sums in another order) and prints one JSON line per stage: the
median time of each variant over 25 runs with CUDA events, the L2
cache overwritten before each, its TFLOP/s, the ratios, and the least time
the card could take (``bound_ms``, the larger of the bytes at 3.35 TB/s and
the operations at the dtype's peak; the VJP's counts its three convs).  It
runs on ``cuda`` unless given ``--device cpu``: there it checks the plain
versions and prints every time as "not measured".
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
    conv_b8,
    conv_chw,
)

STAGES = [(192, 16, 16), (96, 16, 32), (96, 32, 32), (48, 32, 64), (48, 64, 64)]
HBM_BYTES_PER_S = 3.35e12                             # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 off the tensor cores
NOT_MEASURED = "not measured"


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def time_ms(fn: Callable[[], object], reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` over ``reps`` runs, each after the L2
    cache was overwritten, from CUDA events."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.fill_(1.0)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _bf16_ulp(scale: float) -> float:
    return 2.0 ** (int(torch.tensor(max(scale, 1e-30)).log2().floor().item()) - 7)


def _agree(got: torch.Tensor, want: torch.Tensor, dtype: str, exact_f32: bool) -> float:
    """max |got - want|; raises beyond one bf16 ulp of scale (bfloat16
    results) or 1e-5 of scale (float32 results, and ``exact_f32`` ones:
    f32 sums of the same exact products)."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = _bf16_ulp(scale) if dtype == "bfloat16" and not exact_f32 else 1e-5 * scale
    if not err <= tol:
        raise AssertionError(f"B8 route disagrees with the CHW route: {err} > {tol}")
    return err


def run_stage(h: int, c_in: int, c_out: int, batch: int, dtype: str, device: str,
              reps: int, flush=None) -> Dict[str, object]:
    """One stage: the check, then (on the card) the times.  Returns its
    record."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(h * 1000 + c_in * 10 + c_out)
    x = torch.randn((batch, c_in, h * h), generator=gen).to(device, dt)
    w_all = (0.1 * torch.randn((c_out, 9 * c_in), generator=gen)).to(device, dt)
    cot = torch.randn((batch, c_out, h * h), generator=gen).to(device, dt)
    x4, cot4 = x.view(batch, c_in, h, h), cot.view(batch, c_out, h, h)
    w4 = w_all.view(c_out, 3, 3, c_in).permute(0, 3, 1, 2).contiguous()

    def vjp(route, xx, ww, cc):
        xx = xx.detach().requires_grad_(True)
        ww = ww.detach().requires_grad_(True)
        route(xx, ww).backward(cc)
        return xx.grad, ww.grad

    def b8_vjp():
        return vjp(lambda a, b: conv_b8.conv3x3_b8_ad(a, b, h, h), x, w_all, cot)

    def chw_vjp():
        return vjp(lambda a, b: conv_chw.conv3x3_chw_ad(a, b, h, h), x, w_all, cot)

    def cudnn_vjp():
        return vjp(lambda a, b: F.conv2d(a, b, None, 1, 1), x4, w4, cot4)

    variants = {
        "b8": lambda: conv_b8.conv3x3_b8(x, w_all, h, h),
        "chw": lambda: conv_chw.conv3x3_chw(x, w_all, h, h),
        "cudnn": lambda: F.conv2d(x4, w4, None, 1, 1),
        "b8_vjp": b8_vjp, "chw_vjp": chw_vjp, "cudnn_vjp": cudnn_vjp,
    }
    with conv_chw.full_f32(dt):  # cuDNN's f32 convs in f32, not TF32
        y_b8, (dx_b8, dw_b8) = variants["b8"](), b8_vjp()
        y_chw, (dx_chw, dw_chw) = variants["chw"](), chw_vjp()
    rec: Dict[str, object] = {
        "stage": f"{h}^2 {c_in}->{c_out}", "batch": batch, "dtype": dtype, "device": device,
        "max_abs_err": _agree(y_b8, y_chw, dtype, False),
        "dx_max_abs_err": _agree(dx_b8, dx_chw, dtype, False),
        # dw rounds to the weight's dtype in both routes: compare before that
        "dw_max_abs_err": _agree(conv_b8.conv3x3_b8_dw(x, cot, h, h),
                                 conv_chw.conv3x3_chw_dw(x, cot, h, h), dtype, True),
    }
    del dw_b8, dw_chw
    es = x.element_size()
    flops = 2.0 * batch * h * h * 9 * c_in * c_out
    fwd_bytes = (x.numel() + w_all.numel() + cot.numel()) * es
    vjp_bytes = 2 * fwd_bytes + cot.numel() * es  # + dy read, dx and dw written
    b, by = bound(fwd_bytes, flops, dtype)
    vb, vby = bound(vjp_bytes, 3 * flops, dtype)
    rec.update(bound_ms=b, bound_by=by, vjp_bound_ms=vb, vjp_bound_by=vby)
    if device == "cpu":
        for name in variants:
            rec[f"{name}_ms"] = NOT_MEASURED
        return rec
    with conv_chw.full_f32(dt):
        for name, fn in variants.items():
            ms = time_ms(fn, reps, flush)
            rec[f"{name}_ms"] = ms
            rec[f"{name}_tflops"] = (3 if name.endswith("_vjp") else 1) * flops / ms / 1e9
    for a, b_, tag in (("chw", "b8", "b8_vs_chw"), ("cudnn", "b8", "b8_vs_cudnn"),
                       ("chw_vjp", "b8_vjp", "b8_vjp_vs_chw"),
                       ("cudnn_vjp", "b8_vjp", "b8_vjp_vs_cudnn")):
        rec[tag] = rec[f"{a}_ms"] / rec[f"{b_}_ms"]
    return rec


def run(batch: int = 20, dtype: str = "bfloat16", device: str = "cuda",
        reps: int = 25) -> List[Dict[str, object]]:
    """Every stage, one JSON line each, each time the median of ``reps``
    runs; returns the records.  On ``cuda`` it needs a card and does not
    fall back to the CPU."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_b8_conv: no CUDA device (use --device cpu for the check)")
    flush = torch.empty(64 * 2**20 // 4, device="cuda") if device == "cuda" else None
    records = []
    for h, c_in, c_out in STAGES:
        rec = run_stage(h, c_in, c_out, batch, dtype, device, reps, flush)
        if device == "cuda":
            rec["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=20)
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args()
    run(args.batch, args.dtype, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
