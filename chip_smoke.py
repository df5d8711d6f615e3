"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

run from the repository root, with no arguments and no install step.  It
drives the port's two paths at full width (FCN_16: 16/32/64/128/128
channels, 192x192x1 slices, 4 classes, bf16 convs) with weights drawn from
a seed, on cardiac-like phantom slices made from a seed: the serving path,
the cooperative FTN+STN predictor (``CooperativePredictor.predict(n_iter=
2)``), and the training path, the cooperative train step with latent
masking (``CooperativeTrainer.train_step``, batch 20, Adam lr 1e-4).

Phases, each printing its seconds when it ends:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel of the port, compiled by ``nvcc`` from
   ``csrc/``, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the two paths give it (K1 forward at batch 20 and 160, K1
   dx and K2 at batch 20, bf16, plus one f32 shape each; K3 at (20, 128)
   and (20, 144), hard and soft, ties planted), with the tolerance stated;
   at batch 20, median times from CUDA events for the kernel, the plain
   version and one library call computing the same function where there
   is one (``library_ms``, a yardstick the port never calls), and the
   least time the card could take (``bound_ms``);
4. serve: 10 requests of 160 slices, then 50 of 20, through ``predict``,
   with the launch counts set to 0 just before and read just after.  Each
   request must launch K1 as often as the path has K1 convs and return
   finite values of the right shape.  Latency is on the host clock, as
   min / median / p90 / max: a smoke-level reading, not a benchmark;
5. check: every leaf module of one bf16 and one f32 request on the card
   held against its CPU twin on the very input the card gave it; then the
   f32 and bf16 outputs end to end against the same predictor on the CPU;
6. train: a trainer at batch 20, bf16, on one fixed phantom batch: two
   steps with each branch forced on both codes (dropout, spatial,
   channel), then 10 under ``mask_type="random"``, with the launch counts
   set to 0 just before and read just after each step.  Each step must
   launch K1 forward, K1 dx, K2 and K3 exactly as often as the branches it
   drew require, and give finite losses; the standard loss on the first
   step's input must be lower after the steps than before.  Step time on
   the host clock as min / median / p90 / max (smoke-level);
7. train-check: one f32 step on the card against the same step on the
   CPU, same weights and draws, full width, batch 2 (channel masking on
   the image code, spatial on the shape code): losses, Adam's first moment
   (0.1 x the gradient, against the CPU step's own sensitivity to a
   rounding-sized move of its input), the running statistics and the
   masks.

The last lines are the card's ``nvidia-smi`` line, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``, printed only when
every phase passed.  Any failure exits non-zero.  Without a CUDA device, or
without the port's package beside this file, it exits non-zero before
printing any result.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager, nullcontext

PORT = "cooperative_training_and_latent_space_data_augmentation_tpu_torch"
BATCH = 20           # the reference's eval batch
SERVE_BATCH = 160    # a serving batch
N_REQUESTS = 50      # timed requests at BATCH
N_SERVE_REQUESTS = 10  # timed requests at SERVE_BATCH
N_IMAGES = 4         # distinct request batches, served in turn
REPLAY_SLICES = 4    # slices of a request replayed layer by layer on the CPU
MAX_BF16_MISMATCH = 0.01  # share of a bf16 layer output that may differ from the CPU's
N_ITER = 2           # FTN prediction + one STN refinement
REPS = 25            # timed launches per measurement
HBM_BYTES_PER_S = 3.35e12                      # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 off the tensor cores
JAX_PKG = "cooperative_training_and_latent_space_data_augmentation_tpu"
KERNELS = {  # wrapper name -> (source, the TPU kernel it replaces)
    "conv3x3_chw": (f"{PORT}/csrc/conv3x3_chw.cu", f"{JAX_PKG}/ops/pallas_conv.py:139"),
    "conv3x3_chw_dx": (f"{PORT}/csrc/conv3x3_chw.cu", f"{JAX_PKG}/ops/pallas_conv.py:399"),
    "conv3x3_chw_dw": (f"{PORT}/csrc/conv3x3_chw_dw.cu", f"{JAX_PKG}/ops/pallas_conv.py:215"),
    "percentile_mask": (f"{PORT}/csrc/percentile_mask.cu",
                        f"{JAX_PKG}/ops/pallas_kernels.py:66"),
}
TRAIN_BATCH = 20     # the reference's training batch
FORCED_STEPS = 2     # steps with each branch forced
RANDOM_STEPS = 10    # steps under mask_type="random"
CHECK_BATCH = 2      # the f32 card-vs-CPU step (the CPU side runs full width)


@contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.3f} s", flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, flush):
    """Median device time of ``fn`` over REPS launches, each after the L2
    cache was overwritten (the main path meets its inputs cold)."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(REPS)]
    for s, e in zip(starts, ends):
        flush.fill_(1.0)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def k1_shapes(conv_chw, predictor_cpu, image):
    """(C_in, C_out, H, W) of every K1 conv of one predict(n_iter=2), with
    its count, recorded through the plain path of a CPU run."""
    seen = Counter()
    plain = conv_chw.conv3x3_chw_plain

    def record(x, w_all, H, W):
        seen[(x.shape[1], w_all.shape[0], H, W)] += 1
        return plain(x, w_all, H, W)

    conv_chw.conv3x3_chw_plain = record
    try:
        predictor_cpu.predict(image, n_iter=N_ITER)
    finally:
        conv_chw.conv3x3_chw_plain = plain
    return seen


def check_k1(torch, F, conv_chw, shape, n, dtype_name, flush=None):
    """K1 against its plain version on the card at one shape; with a
    ``flush`` buffer also its times, the plain version's and cuDNN's."""
    c_in, c_out, h, w = shape
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(c_in * 1000 + c_out + h)
    x = torch.randn((n, c_in, h * w), generator=gen, device="cuda").to(dtype)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device="cuda")
             / (9 * c_in) ** 0.5).to(dtype)
    got = conv_chw.conv3x3_chw(x, w_all, h, w)
    want = conv_chw.conv3x3_chw_plain(x, w_all, h, w)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype_name == "bfloat16":
        # both round the same f32 sum once: at most one bf16 ulp apart
        tol = 2.0 ** (int(torch.tensor(scale).log2().floor().item()) - 7)
    else:
        # f32 sums of 9*C_in products in another order
        tol = 1e-5 * scale
    ok = err <= tol
    rec = {"shape": [n, c_in, c_out, h, w], "dtype": dtype_name, "max_abs_err": err,
           "tol": tol, "ok": ok}
    print(f"  K1 {dtype_name} N={n} {c_in}->{c_out} @ {h}x{w}: max_abs_err {err:.3g} "
          f"(tol {tol:.3g})", end="" if flush is not None else "\n", flush=True)
    if flush is None:
        return rec
    x4 = x.view(n, c_in, h, w)
    w4 = w_all.view(c_out, 3, 3, c_in).permute(0, 3, 1, 2).contiguous()
    ms = time_ms(lambda: conv_chw.conv3x3_chw(x, w_all, h, w), torch, flush)
    plain_ms = time_ms(lambda: conv_chw.conv3x3_chw_plain(x, w_all, h, w), torch, flush)
    with conv_chw.full_f32(dtype):  # an f32 conv in f32, not TF32
        library_ms = time_ms(lambda: F.conv2d(x4, w4, None, 1, 1), torch, flush)
    es = x.element_size()
    nbytes = (x.numel() + w_all.numel() + n * c_out * h * w) * es
    flops = 2.0 * n * c_out * 9 * c_in * h * w
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(f" ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
          f"bound_ms {rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
    return rec


def compare_f32(got, want, what):
    """f32: sums in other orders only, amplified over the ~50 convs of the
    path (two summation orders on the CPU come out 4.4e-5 of the logits'
    scale apart): max |got - want| <= 2e-4 of the scale, and the class
    argmax agrees on >= 99.5 % of the pixels."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"  {what}: max_abs_err {err:.4g} (tol {2e-4 * scale:.4g}), argmax "
          f"agreement {agree:.5f} (>= 0.995)", flush=True)
    if not (err <= 2e-4 * scale and agree >= 0.995):
        raise AssertionError(f"{what}: outside tolerance")


def compare_bf16(got, want, want_f32, what):
    """bf16, held to what bf16 itself costs the plain path: |got - want| at
    most twice |want - want_f32| in max and in mean, and argmax flips
    against ``want`` at most twice the flips between ``want`` and
    ``want_f32``, plus 0.5 %.  (With random weights the class scores are
    near-tied on much of the image and the network amplifies one-ulp
    differences in the sums, so this end-to-end bound is loose: it catches
    gross faults only.  ``replay_leaves`` is the tight check of the bf16
    path, and the f32 comparison holds the path to 99.5 %.)"""
    own = (want - want_f32).abs()
    diff = (got - want).abs()
    own_flip = (want.argmax(-1) != want_f32.argmax(-1)).float().mean().item()
    flip = (got.argmax(-1) != want.argmax(-1)).float().mean().item()
    print(f"  {what}: max_abs_err {diff.max().item():.4g} (tol {2 * own.max().item():.4g}), "
          f"mean {diff.mean().item():.4g} (tol {2 * own.mean().item():.4g}), argmax "
          f"agreement {1 - flip:.5f} (>= {1 - 2 * own_flip - 0.005:.5f})", flush=True)
    if not (diff.max() <= 2 * own.max() and diff.mean() <= 2 * own.mean()
            and flip <= 2 * own_flip + 0.005):
        raise AssertionError(f"{what}: outside tolerance")


def replay_leaves(torch, gpu, cpu, image, what):
    """Serve ``image`` on the card with a hook on every leaf module (conv,
    BN, activation) that keeps the first REPLAY_SLICES slices of its input
    and output; then run each module's CPU twin on that same input.  Each
    pair computes one layer from one input, so the card may differ from the
    CPU only by the order of its f32 sums:

    * bf16 outputs: both round nearly the same f32 value once, so they are
      at most one bf16 ulp of the output's scale apart, and equal but for
      the few values whose sum lies next to a rounding boundary: at most
      MAX_BF16_MISMATCH of them may differ (rounding at another point, or
      truncating, makes about half of them differ);
    * f32 outputs: at most 1e-5 of the scale apart (TF32 would be ~5e-4
      off)."""
    records = []
    leaves = [(name, m) for name, m in gpu.named_modules() if not list(m.children())]

    def keep(name):
        def hook(_mod, inp, out):
            records.append((name, inp[0][:REPLAY_SLICES].cpu(),
                            out[:REPLAY_SLICES].cpu()))
        return hook

    hooks = [m.register_forward_hook(keep(name)) for name, m in leaves]
    try:
        gpu.predict(torch.from_numpy(image).to(next(gpu.parameters()).device),
                    n_iter=N_ITER)
    finally:
        for h in hooks:
            h.remove()
    twins = dict(cpu.named_modules())
    worst = (0.0, None)
    mismatch = []
    with torch.inference_mode():
        for name, inp, got in records:
            want = twins[name](inp)
            scale = want.float().abs().max().item()
            if want.dtype == torch.bfloat16:
                tol = 2.0 ** (int(torch.tensor(max(scale, 1e-30)).log2().floor().item()) - 7)
            else:
                tol = 1e-5 * scale
            err = (got.float() - want.float()).abs().max().item()
            frac = (got != want).float().mean().item() if want.dtype == torch.bfloat16 else 0.0
            mismatch.append(frac)
            if got.dtype != want.dtype or err > tol or frac > MAX_BF16_MISMATCH:
                raise AssertionError(f"{what}: {name} on the card is {err:.4g} from its "
                                     f"CPU twin (tol {tol:.4g}), {frac:.4f} of its values "
                                     f"differ (<= {MAX_BF16_MISMATCH}), {got.dtype} vs "
                                     f"{want.dtype}")
            if tol > 0 and err / tol >= worst[0]:
                worst = (err / tol, name)
    print(f"  {what}: {len(records)} leaf calls match their CPU twins; the closest to "
          f"its tolerance is {worst[1]} at {worst[0]:.3f} of it; at most "
          f"{max(mismatch):.5f} of a bf16 output's values differ", flush=True)


def bound(nbytes, flops, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the peak rate for their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def bf16_tol(torch, scale):
    """One bf16 ulp at magnitude ``scale``."""
    return 2.0 ** (int(torch.tensor(max(scale, 1e-30)).log2().floor().item()) - 7)


def check_dx(torch, conv_chw, shape, n, dtype_name, flush=None):
    """K1 dx (K1 on the flipped wall) against its plain version at one
    forward shape (C_in, C_out, H, W): dy (N, C_out, H*W) -> dx (N, C_in,
    H*W); with ``flush`` also its times and cuDNN's input gradient."""
    c_in, c_out, h, w = shape
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(c_in * 1000 + c_out + h + 7)
    dy = torch.randn((n, c_out, h * w), generator=gen, device="cuda").to(dtype)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device="cuda")
             / (9 * c_in) ** 0.5).to(dtype)
    flipped = conv_chw.flip_wall(w_all).contiguous()
    got = conv_chw.conv3x3_chw_dx(dy, w_all, h, w)
    want = conv_chw.conv3x3_chw_plain(dy, flipped, h, w)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    # bf16: both round the same f32 sum once; f32: sums in another order
    tol = bf16_tol(torch, scale) if dtype_name == "bfloat16" else 1e-5 * scale
    rec = {"shape": [n, c_in, c_out, h, w], "dtype": dtype_name, "max_abs_err": err,
           "tol": tol, "ok": err <= tol}
    print(f"  K1 dx {dtype_name} N={n} {c_out}->{c_in} @ {h}x{w}: max_abs_err {err:.3g} "
          f"(tol {tol:.3g})", end="" if flush is not None else "\n", flush=True)
    if flush is None:
        return rec
    w4 = w_all.view(c_out, 3, 3, c_in).permute(0, 3, 1, 2).contiguous()
    dy4 = dy.view(n, c_out, h, w)
    ms = time_ms(lambda: conv_chw.conv3x3_chw_dx(dy, w_all, h, w), torch, flush)
    plain_ms = time_ms(lambda: conv_chw.conv3x3_chw_plain(dy, conv_chw.flip_wall(w_all)
                                                          .contiguous(), h, w), torch, flush)
    with conv_chw.full_f32(dtype):
        library_ms = time_ms(lambda: torch.nn.grad.conv2d_input(
            (n, c_in, h, w), w4, dy4, padding=1), torch, flush)
    nbytes = (dy.numel() + w_all.numel() + n * c_in * h * w) * dy.element_size()
    b, by = bound(nbytes, 2.0 * n * c_out * 9 * c_in * h * w, dtype_name)
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b, bound_by=by)
    print(f" ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
          f"bound_ms {b:.4f} ({by})", flush=True)
    return rec


def check_dw(torch, conv_chw, shape, n, dtype_name, flush=None):
    """K2 against its plain version at one forward shape: x (N, C_in,
    H*W), dy (N, C_out, H*W) -> (9*C_in, C_out) f32.  Both sum the same
    f32 products (a bf16 product is exact in f32) in other orders, over up
    to N*H*W = 737,280 pixels: within 1e-5 of the result's scale.  Also
    that two launches agree bit for bit (the fixed summation order).
    With ``flush`` also its times and cuDNN's weight gradient."""
    c_in, c_out, h, w = shape
    dtype = getattr(torch, dtype_name)
    gen = torch.Generator(device="cuda").manual_seed(c_in * 1000 + c_out + h + 11)
    x = torch.randn((n, c_in, h * w), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((n, c_out, h * w), generator=gen, device="cuda").to(dtype)
    got = conv_chw.conv3x3_chw_dw(x, dy, h, w)
    again = conv_chw.conv3x3_chw_dw(x, dy, h, w)
    want = conv_chw.conv3x3_chw_dw_plain(x, dy, h, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-5 * want.abs().max().item()
    same = bool(torch.equal(got, again))
    rec = {"shape": [n, c_in, c_out, h, w], "dtype": dtype_name, "max_abs_err": err,
           "tol": tol, "ok": err <= tol and same}
    print(f"  K2 {dtype_name} N={n} {c_in}->{c_out} @ {h}x{w}: max_abs_err {err:.3g} "
          f"(tol {tol:.3g}), two launches bitwise equal: {same}",
          end="" if flush is not None else "\n", flush=True)
    if flush is None:
        return rec
    x4, dy4 = x.view(n, c_in, h, w), dy.view(n, c_out, h, w)
    ms = time_ms(lambda: conv_chw.conv3x3_chw_dw(x, dy, h, w), torch, flush)
    plain_ms = time_ms(lambda: conv_chw.conv3x3_chw_dw_plain(x, dy, h, w), torch, flush)
    with conv_chw.full_f32(dtype):
        library_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
            x4, (c_out, c_in, 3, 3), dy4, padding=1), torch, flush)
    nbytes = (x.numel() + dy.numel()) * x.element_size() + 9 * c_in * c_out * 4
    b, by = bound(nbytes, 2.0 * n * c_out * 9 * c_in * h * w, dtype_name)
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b, bound_by=by)
    print(f" ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
          f"bound_ms {b:.4f} ({by})", flush=True)
    return rec


def check_k3(torch, pmask, n, d, soft, flush=None):
    """K3 against its plain version (the sort-based threshold) on one
    (N, D) saliency with ties planted, at p in {0, 0.2, 0.5}: equal
    masks.  With ``flush`` also its times; no single PyTorch call computes
    this function, so there is no library time."""
    gen = torch.Generator(device="cuda").manual_seed(d + int(soft))
    sal = torch.randn((n, d), generator=gen, device="cuda")
    sal[:, 1] = sal[:, 2]                        # a tie
    sal[:, 3:9] = torch.round(sal[:, 3:9])       # more, at 0 and +-1
    sal[0] = sal[0, 0]                           # a row of one value
    vals = (0.5 * torch.rand((n, d), generator=gen, device="cuda") if soft
            else torch.zeros((n, d), device="cuda"))
    ok = True
    for pv in (0.0, 0.2, 0.5):
        p = torch.tensor(pv, device="cuda")
        ok &= bool(torch.equal(pmask.percentile_mask(sal, p, vals),
                               pmask.percentile_mask_plain(sal, p, vals)))
    torch.cuda.synchronize()
    rec = {"shape": [n, d], "soft": soft, "max_abs_err": 0.0 if ok else float("inf"),
           "tol": 0.0, "ok": ok}
    print(f"  K3 {'soft' if soft else 'hard'} ({n}, {d}), ties planted: masks equal {ok}",
          end="" if flush is not None else "\n", flush=True)
    if flush is None:
        return rec
    p = torch.tensor(0.37, device="cuda")
    ms = time_ms(lambda: pmask.percentile_mask(sal, p, vals), torch, flush)
    plain_ms = time_ms(lambda: pmask.percentile_mask_plain(sal, p, vals), torch, flush)
    b, by = bound((3 * n * d + 1) * 4, float(n * d * d), "float32")
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b, bound_by=by)
    print(f" ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms null bound_ms {b:.6f} ({by})",
          flush=True)
    return rec


LAUNCH_COUNTERS = ("conv3x3_chw", "conv3x3_chw_dx", "conv3x3_chw_dw", "percentile_mask")


@contextmanager
def recording_shapes(conv_chw, pmask, masking, seen):
    """Route the four wrappers through recorders that add each call's
    shape to ``seen[wrapper]`` and call the wrapper itself (which launches
    and counts as before): K1 forward, dx and K2 by their forward conv's
    (C_in, C_out, H, W), K3 by (N, D)."""
    orig = {"conv3x3_chw": conv_chw.conv3x3_chw, "conv3x3_chw_dx": conv_chw.conv3x3_chw_dx,
            "conv3x3_chw_dw": conv_chw.conv3x3_chw_dw,
            "percentile_mask": pmask.percentile_mask}
    keys = {
        "conv3x3_chw": lambda x, w_all, H, W: (x.shape[1], w_all.shape[0], H, W),
        "conv3x3_chw_dx": lambda dy, w_all, H, W: (w_all.shape[1] // 9, w_all.shape[0], H, W),
        "conv3x3_chw_dw": lambda x, dy, H, W: (x.shape[1], dy.shape[1], H, W),
        "percentile_mask": lambda sal, p, soft: tuple(sal.shape),
    }

    def recorder(name):
        def call(*args):
            seen[name][keys[name](*args)] += 1
            return orig[name](*args)
        # a wrapper counts through its module-level name, which may now be
        # this recorder: its count starts at 0 here and is added back on exit
        call.launches = 0
        return call

    recorders = {name: recorder(name) for name in LAUNCH_COUNTERS}
    for name in LAUNCH_COUNTERS[:3]:
        setattr(conv_chw, name, recorders[name])
    masking.percentile_mask = recorders["percentile_mask"]
    try:
        yield
    finally:
        for name in LAUNCH_COUNTERS[:3]:
            setattr(conv_chw, name, orig[name])
        masking.percentile_mask = orig["percentile_mask"]
        for name in LAUNCH_COUNTERS:
            orig[name].launches += recorders[name].launches


def train_phase(torch, conv_chw, pmask, masking, cfg, coop, draws_mod, image, label):
    """The train phase (see the module docstring).  Returns (launches by
    wrapper over the phase, the random steps' calls by wrapper and shape,
    step times of the random steps)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
        frozen_stats,
    )

    wrappers = {"conv3x3_chw": conv_chw.conv3x3_chw, "conv3x3_chw_dx": conv_chw.conv3x3_chw_dx,
                "conv3x3_chw_dw": conv_chw.conv3x3_chw_dw,
                "percentile_mask": pmask.percentile_mask}
    trainer = coop.CooperativeTrainer(cfg.LatentDAConfig(), compute_dtype=torch.bfloat16,
                                      device="cuda", seed=0)
    img = torch.from_numpy(image).to("cuda")
    lbl = torch.from_numpy(label).to("cuda")
    gen = torch.Generator().manual_seed(0)
    plan = [(t, FORCED_STEPS) for t in ("dropout", "spatial", "channel")] + \
        [("random", RANDOM_STEPS)]
    total = dict.fromkeys(LAUNCH_COUNTERS, 0)
    seen = {k: Counter() for k in LAUNCH_COUNTERS}
    times, first = [], None
    for mask_type, n_steps in plan:
        trainer.latent_da = cfg.LatentDAConfig(image_code=cfg.MaskConfig("mse", mask_type),
                                               shape_code=cfg.MaskConfig("ce", mask_type))
        for _ in range(n_steps):
            draws = draws_mod.draw_step(gen, TRAIN_BATCH, (192, 192), trainer.latent_da,
                                        device="cuda")
            for k in LAUNCH_COUNTERS:
                wrappers[k].launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (recording_shapes(conv_chw, pmask, masking, seen) if mask_type == "random"
                  else nullcontext()):
                metrics = trainer.train_step(img, lbl, draws)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            got = {k: wrappers[k].launches for k in LAUNCH_COUNTERS}
            for k in LAUNCH_COUNTERS:
                total[k] += got[k]
            branches = {"image": draws.image.branch, "shape": draws.shape.branch}
            want = trainer.expected_launches(branches)
            if got != want:
                raise AssertionError(f"{mask_type} step, branches {branches}: launches "
                                     f"{got}, expected {want}")
            values = {k: float(v) for k, v in metrics.items()}
            if not all(math.isfinite(v) for v in values.values()):
                raise AssertionError(f"non-finite loss: {values}")
            if first is None:
                first = (values, draws)
            if mask_type == "random":
                times.append(sec)
            print(f"  {mask_type:7s} branches image {branches['image']} shape "
                  f"{branches['shape']}: {sec * 1e3:9.3f} ms, launches "
                  f"{[got[k] for k in LAUNCH_COUNTERS]}, loss/total "
                  f"{values['loss/total']:.4f}, loss/standard/total "
                  f"{values['loss/standard/total']:.4f}", flush=True)
    values0, draws0 = first
    with torch.no_grad(), frozen_stats(trainer.model):
        clean = img.permute(0, 3, 1, 2).contiguous()
        noised = torch.clamp(clean + trainer.input_noise_std * draws0.noise, 0.0, 1.0)
        std, _ = trainer.standard_training(clean, lbl.long(), noised)
        after = float(std["seg"] + std["image"] + std["shape"] + std["gt_shape"])
    steps = len(plan) - 1
    print(f"  loss/standard/total on the first step's input: {values0['loss/standard/total']:.5f} "
          f"before, {after:.5f} after {FORCED_STEPS * steps + RANDOM_STEPS} steps", flush=True)
    if not after < values0["loss/standard/total"]:
        raise AssertionError("the standard loss did not fall")
    return total, seen, times


def assert_masks_agree(torch, got_mask, want_mask, got_sal, want_sal, p, what):
    """(N, D) masks equal, or swapped only where the saliency lies within
    twice the row's largest card-vs-CPU saliency difference of the row's
    threshold value (the int(D * p)-th largest)."""
    differ = got_mask != want_mask
    if not bool(differ.any()):
        return 0
    d = want_sal.shape[1]
    idx = int(torch.floor(torch.tensor(p, dtype=torch.float32) * d).clamp(0, d - 1))
    thresh = torch.sort(want_sal, dim=1, descending=True).values[:, idx:idx + 1]
    tol = 2 * (got_sal - want_sal).abs().max(dim=1, keepdim=True).values
    near = (want_sal - thresh).abs() <= tol
    if not bool(near[differ].all()):
        raise AssertionError(f"{what}: masks differ away from the threshold")
    return int(differ.sum())


def train_check(torch, cfg, coop, draws_mod, image, label):
    """One f32 step on the card against the same step on the CPU (see the
    module docstring).  Tolerances, f32 sums in other orders:

    * losses: within 1e-4 of their value;
    * running statistics: within 1e-4 of each tensor's scale (40 layers of
      f32 forward at most);
    * Adam's first moment (0.1 x the gradient), in the Frobenius norm:
      this step's gradient is not continuous at f32 rounding (a LeakyReLU
      or ReLU whose input sits within rounding of 0 takes the other slope,
      and at batch 2 a deep layer's weight gradient sums few terms), so the
      yardstick is the CPU step's own sensitivity: the same step on the
      CPU with its input image moved by +-1e-6 of each pixel, twice.  The
      whole model's moment may differ from the CPU's by at most twice the
      larger of the two moves' differences, each tensor's by at most four
      times its own (one tensor's share of the kinks varies more from move
      to move) or 1e-3 of its norm;
    * the masks: equal, or swapped only next to the threshold."""
    lda = cfg.LatentDAConfig(image_code=cfg.MaskConfig("mse", "channel"),
                             shape_code=cfg.MaskConfig("ce", "spatial"))
    draws = draws_mod.draw_step(torch.Generator().manual_seed(1), CHECK_BATCH, (192, 192), lda)
    img, lbl = torch.from_numpy(image[:CHECK_BATCH]), torch.from_numpy(label[:CHECK_BATCH])
    gpu = coop.CooperativeTrainer(lda, device="cuda", seed=1)
    got_m = gpu.train_step(img.to("cuda"), lbl.to("cuda"), draws.to("cuda"))

    def cpu_step(x):
        trainer = coop.CooperativeTrainer(lda, device="cpu", seed=1)
        return trainer, trainer.train_step(x, lbl, draws)

    t0 = time.perf_counter()
    cpu, want_m = cpu_step(img)
    signs = [torch.randint(0, 2, img.shape, generator=torch.Generator().manual_seed(k)) * 2 - 1
             for k in (1, 2)]
    moved = [cpu_step(img * (1 + 1e-6 * sg))[0] for sg in signs]
    print(f"  three CPU steps in {time.perf_counter() - t0:.1f} s", flush=True)
    for k, w in want_m.items():
        g, w = float(got_m[k]), float(w)
        if not abs(g - w) <= 1e-4 * abs(w) + 1e-7:
            raise AssertionError(f"train-check: {k} {g} on the card, {w} on the CPU")
    print(f"  losses within 1e-4: loss/total {float(got_m['loss/total']):.6f} card, "
          f"{float(want_m['loss/total']):.6f} CPU", flush=True)
    gsd, csd = gpu.model.state_dict(), cpu.model.state_dict()
    worst = 0.0
    for k, w in csd.items():
        if "running_" in k:
            err = (gsd[k].cpu() - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            worst = max(worst, err)
    if worst > 1e-4:
        raise AssertionError(f"train-check: running statistics {worst:.3g} of scale apart")

    def flat_mu(trainer):
        mu, _ = trainer.adam_moments()
        return {f"{m}.{k}": v.detach().cpu().double() for m in mu for k, v in mu[m].items()}

    g_mu, c_mu = flat_mu(gpu), flat_mu(cpu)
    m_mu = [flat_mu(t) for t in moved]
    top = max(v.abs().max().item() for v in c_mu.values())
    whole = math.sqrt(sum(float((g_mu[k] - v).norm()) ** 2 for k, v in c_mu.items()))
    own_whole = max(math.sqrt(sum(float((m[k] - v).norm()) ** 2 for k, v in c_mu.items()))
                    for m in m_mu)
    ratio = 0.0
    for k, v in c_mu.items():
        own = max(float((m[k] - v).norm()) for m in m_mu)
        bound = max(1e-3 * float(v.norm()), 4 * own, 1e-6 * top * math.sqrt(v.numel()))
        ratio = max(ratio, float((g_mu[k] - v).norm()) / bound)
    norm = math.sqrt(sum(float(v.norm()) ** 2 for v in c_mu.values()))
    print(f"  running statistics within {worst:.3g} of scale; Adam mu: card vs CPU "
          f"{whole / norm:.3g} of the model's norm, CPU vs CPU moved {own_whole / norm:.3g} "
          f"(<= 2x); worst tensor at {ratio:.3f} of its bound", flush=True)
    if not (whole <= 2 * own_whole and ratio <= 1.0):
        raise AssertionError("train-check: Adam's first moments differ")
    swapped = 0
    for key in ("image", "shape"):
        g, c = gpu.generation[key], cpu.generation[key]
        n = g.mask.shape[0]
        if g.branch == 2:
            gm, cm = g.mask[:, :, 0, 0].cpu(), c.mask[:, :, 0, 0]
        else:
            gm, cm = g.mask[:, 0].reshape(n, -1).cpu(), c.mask[:, 0].reshape(n, -1)
        swapped += assert_masks_agree(torch, gm, cm, g.saliency.cpu(), c.saliency,
                                      float(getattr(draws, key).p), key)
    print(f"  masks (channel on the image code, spatial on the shape code): "
          f"{swapped} elements swapped next to the threshold", flush=True)

def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
        phantom_batch,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import config as cfg
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw, masking
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        percentile_mask as pmask,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (
        cooperative as coop,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (
        draws as draws_mod,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
        CooperativePredictor,
    )

    t_start = time.perf_counter()
    # PyTorch's default, stated: the plain K1 version's f32 matmul on the
    # card runs in full f32 (the port pins its own f32 convs, conv_chw.full_f32)
    torch.set_float32_matmul_precision("highest")

    with phase("device"):
        smi = nvidia_smi_line()
        print(f"  nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
              f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    with phase("build"):
        built = kernels.build()
        for name, info in built.items():
            ptxas = [ln.strip() for ln in info["log"].splitlines()
                     if "registers" in ln or "spill" in ln]
            print(f"  {name}: {info['seconds']:.2f} s; " + " | ".join(ptxas), flush=True)
        for name in kernels.SOURCES:
            kernels.load(name)

    images = [phantom_batch(seed=r, n=BATCH)[0] for r in range(N_IMAGES)]
    big = phantom_batch(seed=N_IMAGES, n=SERVE_BATCH)[0]
    gpu = CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=0)
    cpu = CooperativePredictor(compute_dtype=torch.bfloat16, device="cpu", seed=0)
    cpu.load_state_dict(gpu.state_dict())

    with phase("kernels"):
        shapes = k1_shapes(conv_chw, cpu, torch.from_numpy(images[0][:1]))
        per_request = sum(shapes.values())
        print(f"  K1 convs per predict(n_iter={N_ITER}): {per_request} at "
              f"{len(shapes)} shapes: " + ", ".join(
                  f"{ci}->{co} @ {h}x{w} x{k}" for (ci, co, h, w), k in sorted(
                      shapes.items(), key=lambda kv: (-kv[0][2], kv[0][0], kv[0][1]))),
              flush=True)
        flush = torch.empty(64 * 2**20 // 4, device="cuda")
        recs = {s: check_k1(torch, F, conv_chw, s, BATCH, "bfloat16", flush)
                for s in sorted(shapes, key=lambda s: (-s[2], s[0], s[1]))}
        f32_rec = check_k1(torch, F, conv_chw, (16, 16, 192, 192), BATCH, "float32", flush)
        # the serving batch meets the same shapes at N = 160 (checked, not timed)
        big_recs = [check_k1(torch, F, conv_chw, s, SERVE_BATCH, "bfloat16")
                    for s in sorted(shapes, key=lambda s: (-s[2], s[0], s[1]))]
        bad = [r for r in list(recs.values()) + [f32_rec] + big_recs if not r["ok"]]
        if bad:
            raise AssertionError(f"K1 disagrees with its plain version: {bad}")
        print("  K1 per predict(n_iter=2) request of 20: " + ", ".join(
            f"{key} {sum(shapes[s] * recs[s][key] for s in shapes):.4f}"
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")) + " ms", flush=True)
        # the train step runs K1 dx and K2 at the forward's shapes: dx for
        # every conv whose input needs a gradient (all but C_in = 1, the
        # image), K2 for every conv
        order = sorted(shapes, key=lambda s: (-s[2], s[0], s[1]))
        dx_recs = {s: check_dx(torch, conv_chw, s, TRAIN_BATCH, "bfloat16", flush)
                   for s in order if s[0] > 1}
        dx_f32 = check_dx(torch, conv_chw, (16, 16, 192, 192), TRAIN_BATCH, "float32", flush)
        dw_recs = {s: check_dw(torch, conv_chw, s, TRAIN_BATCH, "bfloat16", flush)
                   for s in order}
        dw_f32 = check_dw(torch, conv_chw, (16, 16, 192, 192), TRAIN_BATCH, "float32", flush)
        k3_recs = {(d, soft): check_k3(torch, pmask, TRAIN_BATCH, d, soft,
                                       flush if soft else None)
                   for d in (128, 144) for soft in (False, True)}
        del flush
        bad = [r for r in list(dx_recs.values()) + [dx_f32] + list(dw_recs.values())
               + [dw_f32] + list(k3_recs.values()) if not r["ok"]]
        if bad:
            raise AssertionError(f"a kernel disagrees with its plain version: {bad}")
        torch.cuda.empty_cache()

    with phase("serve"):
        def serve(img):
            before = conv_chw.conv3x3_chw.launches
            t0 = time.perf_counter()
            out = gpu.predict(torch.from_numpy(img).to("cuda"), n_iter=N_ITER).cpu()
            sec = time.perf_counter() - t0
            launched = conv_chw.conv3x3_chw.launches - before
            if launched != per_request:
                raise AssertionError(f"K1 launched {launched} times for one request, "
                                     f"expected {per_request}")
            if out.shape != (img.shape[0], 192, 192, 4) or not torch.isfinite(out).all():
                raise AssertionError(f"bad output {tuple(out.shape)}")
            return sec

        def report(batch, lat):
            med = statistics.median(lat)
            p90 = statistics.quantiles(lat, n=10)[-1]
            print(f"  batch {batch}, {len(lat)} requests: latency min {min(lat) * 1e3:.3f} "
                  f"median {med * 1e3:.3f} p90 {p90 * 1e3:.3f} max {max(lat) * 1e3:.3f} ms; "
                  f"{batch / med:.1f} slices/s at the median", flush=True)

        for wrapper in (conv_chw.conv3x3_chw, conv_chw.conv3x3_chw_dx,
                        conv_chw.conv3x3_chw_dw, pmask.percentile_mask):
            wrapper.launches = 0
        serve(big)                                   # warm-up
        report(SERVE_BATCH, [serve(big) for _ in range(N_SERVE_REQUESTS)])
        serve(images[0])                             # warm-up
        serve(images[1])
        report(BATCH, [serve(images[r % N_IMAGES]) for r in range(N_REQUESTS)])
        serve_launches = conv_chw.conv3x3_chw.launches
        if serve_launches == 0:
            raise AssertionError("K1 never launched on the serving path")
        if (conv_chw.conv3x3_chw_dx.launches, conv_chw.conv3x3_chw_dw.launches,
                pmask.percentile_mask.launches) != (0, 0, 0):
            raise AssertionError("serving launched a gradient or mask kernel")
        print(f"  K1 launches during the {N_SERVE_REQUESTS + N_REQUESTS + 3} requests "
              f"(warm-ups included): {serve_launches}", flush=True)

    with phase("check"):
        gpu32 = CooperativePredictor(compute_dtype=None, device="cuda", seed=0)
        cpu32 = CooperativePredictor(compute_dtype=None, device="cpu", seed=0)
        gpu32.load_state_dict(gpu.state_dict())
        cpu32.load_state_dict(gpu.state_dict())
        replay_leaves(torch, gpu, cpu, images[0], "bf16 layer by layer")
        replay_leaves(torch, gpu32, cpu32, images[0], "f32 layer by layer")
        x0 = torch.from_numpy(images[0])
        want32 = cpu32.predict(x0, n_iter=N_ITER)
        compare_f32(gpu32.predict(x0.to("cuda"), n_iter=N_ITER).cpu(), want32,
                    "f32 K1 path vs CPU plain, end to end")
        got16 = gpu.predict(x0.to("cuda"), n_iter=N_ITER).cpu()
        compare_bf16(got16, cpu.predict(x0, n_iter=N_ITER), want32,
                     "bf16 K1 path vs CPU plain, end to end")

    del gpu, cpu, gpu32, cpu32
    torch.cuda.empty_cache()
    train_image, train_label = phantom_batch(seed=7, n=TRAIN_BATCH)

    with phase("train"):
        train_launches, seen, step_times = train_phase(
            torch, conv_chw, pmask, masking, cfg, coop, draws_mod, train_image, train_label)
        med = statistics.median(step_times)
        p90 = statistics.quantiles(step_times, n=10)[-1]
        print(f"  {RANDOM_STEPS} random steps of batch {TRAIN_BATCH} (host clock, smoke-level): "
              f"min {min(step_times) * 1e3:.3f} median {med * 1e3:.3f} p90 {p90 * 1e3:.3f} "
              f"max {max(step_times) * 1e3:.3f} ms; {TRAIN_BATCH / med:.1f} slices/s at the "
              f"median", flush=True)
        print(f"  launches over the train phase: {train_launches}", flush=True)
        missing = [k for k, v in train_launches.items() if v == 0]
        if missing:
            raise AssertionError(f"never launched on the training path: {missing}")
        torch.cuda.empty_cache()

    with phase("train-check"):
        train_check(torch, cfg, coop, draws_mod, train_image, train_label)

    total = time.perf_counter() - t_start
    print(f"chip_smoke total {total:.1f} s", flush=True)

    # one record per kernel: ms, plain_ms, bound_ms and library_ms per
    # train step (batch 20, the mean calls per shape over the random steps
    # times each shape's median time at N = 20); K1's serving numbers per
    # request are printed in the kernels phase
    per_step = {k: {sh: n / RANDOM_STEPS for sh, n in seen[k].items()} for k in seen}
    timed = {"conv3x3_chw": recs, "conv3x3_chw_dx": dx_recs, "conv3x3_chw_dw": dw_recs,
             "percentile_mask": {(n, d): k3_recs[(d, True)] for (d, soft) in k3_recs if soft
                                 for n in (TRAIN_BATCH,)}}
    checked = {"conv3x3_chw": list(recs.values()) + [f32_rec] + big_recs,
               "conv3x3_chw_dx": list(dx_recs.values()) + [dx_f32],
               "conv3x3_chw_dw": list(dw_recs.values()) + [dw_f32],
               "percentile_mask": list(k3_recs.values())}
    launches = dict(train_launches)
    launches["conv3x3_chw"] += serve_launches
    records = []
    for name in LAUNCH_COUNTERS:
        calls = per_step[name]
        if set(calls) - set(timed[name]):
            raise AssertionError(f"{name}: shapes on the path were not timed: "
                                 f"{sorted(set(calls) - set(timed[name]))}")

        def total_of(key, name=name, calls=calls):
            vals = [timed[name][sh][key] for sh in calls]
            if any(v is None for v in vals):
                return None
            return sum(calls[sh] * timed[name][sh][key] for sh in calls)

        by = Counter({r["bound_by"]: 0.0 for r in timed[name].values()})
        for sh in calls:
            by[timed[name][sh]["bound_by"]] += calls[sh] * timed[name][sh]["bound_ms"]
        source, replaces = KERNELS[name]
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checked[name]),
            "ms": total_of("ms"), "plain_ms": total_of("plain_ms"),
            "bound_ms": total_of("bound_ms"), "bound_by": by.most_common(1)[0][0],
            "library_ms": total_of("library_ms"),
        })
        print(f"  {name}: {sum(calls.values()):.1f} calls per random step at {len(calls)} "
              f"shapes; per step ms {records[-1]['ms']:.4f} plain {records[-1]['plain_ms']:.4f} "
              f"bound {records[-1]['bound_ms']:.6f} library {records[-1]['library_ms']}",
              flush=True)
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
