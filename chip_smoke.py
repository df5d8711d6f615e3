"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

run from the repository root, with no arguments and no install step.  It
drives the port's two paths at full width (FCN_16: 16/32/64/128/128
channels, 192x192x1 slices, 4 classes, bf16 convs) with weights drawn from
a seed, on cardiac-like phantom slices made from a seed: the serving path,
the cooperative FTN+STN predictor (``CooperativePredictor.predict(n_iter=
2)``), and the training path, the cooperative train step with latent
masking (``CooperativeTrainer.train_step``, batch 20, Adam lr 1e-4).  Each
path runs in three configurations: the default; ``conv_s2=True`` (the JAX
package's ``PALLAS_CONV_S2=1``: the encoders' 16->16 and 32->32 stride-2
downsamples on kernel K4, with K4dx and K4dw in the backward); and
``conv_nl=True`` (its ``PALLAS_CONV_NL=1``: the residual stages'
64..128-channel 3x3 convs at 24x24 and 12x12 on kernel K5, with K5 on
flipped weights for dx and K5dw in the backward).  Last it runs the port's
``bench_b8_conv``, the path of the blocked conv K6 (with its dx and K6dw).

Phases, each printing its seconds when it ends:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel of the port, compiled by ``nvcc`` from
   ``csrc/``, one process per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the two paths give it (K1 forward at batch 20 and 160, K1
   dx and K2 at batch 20, bf16, plus one f32 shape each; K3 at (20, 128)
   and (20, 144), hard and soft, ties planted; K4, K4dx and K4dw at
   16->16 on 192x192 and 32->32 on 96x96, batch 20 and 160, bf16, and
   batch 20 f32; K5, K5dx and K5dw at the four large-channel shapes, batch
   20 and 160, bf16, and batch 20 f32; K6, K6dx and K6dw at the five
   stages of ``bench_b8_conv``, batch 20, bf16, and one f32 stage), with the
   tolerance stated; median times from CUDA events
   for the kernel, the plain version and one library call computing the
   same function where there is one (``library_ms``, a yardstick the port
   never calls), and the least time the card could take (``bound_ms``);
4. serve: 10 requests of 160 slices, then 50 of 20, through ``predict``,
   then 50 of 20 with ``conv_s2=True`` and 50 of 20 with ``conv_nl=True``,
   with the launch counts set to 0 just before each route and read just
   after.  Each request must launch K1 (and K4, or K5) as often as the path
   has such convs and return finite
   values of the right shape.  Latency is on the host clock, as min /
   median / p90 / max: a smoke-level reading, not a benchmark.  Then a
   ``predict`` on the model in train mode must give the eval-mode output
   and leave every buffer and module mode as it was;
5. check: every leaf module of one bf16 and one f32 request on the card
   held against its CPU twin on the very input the card gave it; then the
   f32 and bf16 outputs end to end against the same predictor on the CPU;
   for ``conv_s2=True`` and for ``conv_nl=True`` a bf16 request layer by
   layer and the f32 output end to end against their CPU twins;
6. train: for each of the three configurations, a
   trainer at batch 20, bf16, on one fixed phantom batch: two steps with
   each branch forced on both codes (dropout, spatial, channel), then 10
   under ``mask_type="random"``, with the launch counts set to 0 just
   before and read just after each step.  Each step must launch K1
   forward, K1 dx, K2, K3, K4, K4dx, K4dw, K5, K5dx and K5dw exactly as
   often as the
   branches it drew require, and give finite losses; the standard loss on
   the first step's input must be lower after the steps than before.  Step
   time on the host clock as min / median / p90 / max (smoke-level);
7. train-check: for each configuration, one f32 step on the card against
   the same step on the CPU, same weights and draws, full width, batch 2
   (channel masking on the image code, spatial on the shape code): losses,
   Adam's first moment (0.1 x the gradient, against the CPU step's own
   sensitivity to a rounding-sized move of its input), the running
   statistics and the masks;
8. b8: one short run of ``bench_b8_conv`` at batch 20, bf16 (the five
   stages, forward and full VJP through K6, K1/K2 and cuDNN, the B8 route
   checked against the CHW route), with the launch counts set to 0 just
   before and read just after; it must launch K6, K6dx and K6dw.

At the end it prints, per kernel, its launches and times per random step
(per bench pass for K6), and a table of K2 by shape: launches per random
step, ms, cuDNN's ``conv2d_weight`` ms and the bound, with the per-step
totals.  The last lines are the card's ``nvidia-smi`` line, one JSON
object with a record per kernel, and ``{"ok": true, "device": {...}}``,
printed only when every phase passed.  Any failure exits non-zero.
Without a CUDA device, or without the port's package beside this file, it
exits non-zero before printing any result.
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
    "conv3x3s2": (f"{PORT}/csrc/conv3x3s2.cu", f"{JAX_PKG}/ops/pallas_conv.py:499"),
    "conv3x3s2_dx": (f"{PORT}/csrc/conv3x3s2.cu", f"{JAX_PKG}/ops/pallas_conv.py:547"),
    "conv3x3s2_dw": (f"{PORT}/csrc/conv3x3s2.cu", f"{JAX_PKG}/ops/pallas_conv.py:588"),
    "conv3x3_nl": (f"{PORT}/csrc/conv3x3_nl.cu", f"{JAX_PKG}/ops/pallas_conv.py:776"),
    "conv3x3_nl_dx": (f"{PORT}/csrc/conv3x3_nl.cu", f"{JAX_PKG}/ops/pallas_conv.py:930"),
    "conv3x3_nl_dw": (f"{PORT}/csrc/conv3x3_nl.cu", f"{JAX_PKG}/ops/pallas_conv.py:823"),
    "conv3x3_b8": (f"{PORT}/csrc/conv3x3_b8.cu", f"{JAX_PKG}/ops/pallas_conv_blocked.py:136"),
    "conv3x3_b8_dx": (f"{PORT}/csrc/conv3x3_b8.cu",
                      f"{JAX_PKG}/ops/pallas_conv_blocked.py:309"),
    "conv3x3_b8_dw": (f"{PORT}/csrc/conv3x3_b8.cu",
                      f"{JAX_PKG}/ops/pallas_conv_blocked.py:192"),
}
S2_SHAPES = ((16, 16, 192, 192), (32, 32, 96, 96))  # (C_in, C_out, H, W) of the K4 convs
# (C_in, C_out, H, W) of the K5 convs: down3's two, down4's, up1's first
NL_SHAPES = ((64, 128, 24, 24), (128, 128, 24, 24), (128, 128, 12, 12), (128, 64, 24, 24))
B8_REPS = 5          # timed runs per variant in the b8 phase's bench
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


CONV_KINDS = {  # kind -> (wrapper name in its module, stride, labels of fwd, dx, dw)
    "chw": ("conv3x3_chw", 1, ("K1", "K1 dx", "K2")),
    "s2": ("conv3x3s2", 2, ("K4", "K4dx", "K4dw")),
    "nl": ("conv3x3_nl", 1, ("K5", "K5dx", "K5dw")),
    "b8": ("conv3x3_b8", 1, ("K6", "K6dx", "K6dw")),
}


def check_conv(torch, F, conv_chw, mod, kind, which, shape, n, dtype_name, flush=None):
    """One conv kernel of ``kind`` (``CONV_KINDS``; ``mod`` is the module of
    its wrappers): the forward (``which`` "fwd"), the input gradient ("dx")
    or the weight gradient ("dw") against its plain version at one forward
    shape (C_in, C_out, H, W): x (N, C_in, H*W), dy (N, C_out, H/s * W/s)
    for stride s.  The plain dx is the module's own where it has one, else
    the plain forward on the flipped wall (a stride-1 conv's dx is that
    conv).  Forward and dx: bf16 within one ulp of scale (one rounding of
    nearly the same f32 sum), f32 within 1e-5 of scale (another summation
    order); dw (f32 out, the same exact products summed in another order)
    within 1e-5 of scale, and two launches bit for bit equal.  With
    ``flush`` also its times and cuDNN's conv, input gradient or weight
    gradient, and the bound."""
    name, stride, labels = CONV_KINDS[kind]
    c_in, c_out, h, w = shape
    ho, wo = h // stride, w // stride
    dtype = getattr(torch, dtype_name)
    seed = c_in * 1000 + c_out + h + {"fwd": 0, "dx": 7, "dw": 11}[which]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, c_in, h * w), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((n, c_out, ho * wo), generator=gen, device="cuda").to(dtype)
    w_all = (torch.randn((c_out, 9 * c_in), generator=gen, device="cuda")
             / (9 * c_in) ** 0.5).to(dtype)
    x4, dy4 = x.view(n, c_in, h, w), dy.view(n, c_out, ho, wo)
    w4 = w_all.view(c_out, 3, 3, c_in).permute(0, 3, 1, 2).contiguous()
    fwd, fwd_plain = getattr(mod, name), getattr(mod, f"{name}_plain")
    dx_plain = getattr(mod, f"{name}_dx_plain", None) or (
        lambda d, wa, hh, ww: fwd_plain(d, conv_chw.flip_wall(wa).contiguous(), hh, ww))
    dxf, dwf, dw_plain = (getattr(mod, f"{name}_dx"), getattr(mod, f"{name}_dw"),
                          getattr(mod, f"{name}_dw_plain"))
    es = x.element_size()
    fn, plain, library, out_bytes = {
        "fwd": (lambda: fwd(x, w_all, h, w), lambda: fwd_plain(x, w_all, h, w),
                lambda: F.conv2d(x4, w4, None, stride, 1), dy.numel() * es),
        "dx": (lambda: dxf(dy, w_all, h, w), lambda: dx_plain(dy, w_all, h, w),
               lambda: torch.nn.grad.conv2d_input((n, c_in, h, w), w4, dy4, stride=stride,
                                                  padding=1), x.numel() * es),
        "dw": (lambda: dwf(x, dy, h, w), lambda: dw_plain(x, dy, h, w),
               lambda: torch.nn.grad.conv2d_weight(x4, (c_out, c_in, 3, 3), dy4,
                                                   stride=stride, padding=1),
               9 * c_in * c_out * 4),
    }[which]
    got, again, want = fn(), fn(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = bf16_tol(torch, scale) if dtype_name == "bfloat16" and which != "dw" \
        else 1e-5 * scale
    same = bool(torch.equal(got, again))
    rec = {"shape": [n, c_in, c_out, h, w], "dtype": dtype_name, "max_abs_err": err,
           "tol": tol, "ok": err <= tol and (same or which != "dw")}
    label = labels[("fwd", "dx", "dw").index(which)]
    print(f"  {label} {dtype_name} N={n} {c_in}->{c_out} @ {h}x{w}: max_abs_err {err:.3g} "
          f"(tol {tol:.3g})" + (f", two launches bitwise equal: {same}" if which == "dw"
                                else ""), end="" if flush is not None else "\n", flush=True)
    del got, again, want
    if flush is None:
        return rec
    ms = time_ms(fn, torch, flush)
    plain_ms = time_ms(plain, torch, flush)
    with conv_chw.full_f32(dtype):  # an f32 conv in f32, not TF32
        library_ms = time_ms(library, torch, flush)
    in_bytes = {"fwd": x.numel() + w_all.numel(), "dx": dy.numel() + w_all.numel(),
                "dw": x.numel() + dy.numel()}[which] * es
    b, by = bound(in_bytes + out_bytes, 2.0 * n * c_out * 9 * c_in * ho * wo, dtype_name)
    rec.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b, bound_by=by)
    print(f" ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
          f"bound_ms {b:.4f} ({by})", flush=True)
    return rec


LAUNCH_COUNTERS = ("conv3x3_chw", "conv3x3_chw_dx", "conv3x3_chw_dw", "percentile_mask",
                   "conv3x3s2", "conv3x3s2_dx", "conv3x3s2_dw",
                   "conv3x3_nl", "conv3x3_nl_dx", "conv3x3_nl_dw",
                   "conv3x3_b8", "conv3x3_b8_dx", "conv3x3_b8_dw")


def _homes(conv_chw, pmask):
    """The module each wrapper of LAUNCH_COUNTERS lives in."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        conv_b8,
        conv_nl,
        conv_s2,
    )

    homes = {"percentile_mask": pmask}
    for mod, names in ((conv_chw, LAUNCH_COUNTERS[:3]), (conv_s2, LAUNCH_COUNTERS[4:7]),
                       (conv_nl, LAUNCH_COUNTERS[7:10]), (conv_b8, LAUNCH_COUNTERS[10:])):
        homes.update(dict.fromkeys(names, mod))
    return {name: homes[name] for name in LAUNCH_COUNTERS}


def wrappers_of(conv_chw, pmask):
    """The thirteen kernel wrappers by name (LAUNCH_COUNTERS)."""
    return {name: getattr(home, name) for name, home in _homes(conv_chw, pmask).items()}


@contextmanager
def recording_shapes(conv_chw, pmask, masking, seen):
    """Route the thirteen wrappers through recorders that add each call's
    shape to ``seen[wrapper]`` and call the wrapper itself (which launches
    and counts as before): the convs' forward, dx and dw wrappers by their
    forward conv's (C_in, C_out, H, W), K3 by (N, D)."""
    orig = wrappers_of(conv_chw, pmask)
    fwd = lambda x, w_all, H, W: (x.shape[1], w_all.shape[0], H, W)  # noqa: E731
    dx = lambda dy, w_all, H, W: (w_all.shape[1] // 9, w_all.shape[0], H, W)  # noqa: E731
    dw = lambda x, dy, H, W: (x.shape[1], dy.shape[1], H, W)  # noqa: E731
    keys = {name: (dx if name.endswith("_dx") else dw if name.endswith("_dw") else fwd)
            for name in LAUNCH_COUNTERS}
    keys["percentile_mask"] = lambda sal, p, soft: tuple(sal.shape)
    homes = {k: v for k, v in _homes(conv_chw, pmask).items() if k != "percentile_mask"}

    def recorder(name):
        def call(*args):
            seen[name][keys[name](*args)] += 1
            return orig[name](*args)
        # a wrapper counts through its module-level name, which may now be
        # this recorder: its count starts at 0 here and is added back on exit
        call.launches = 0
        return call

    recorders = {name: recorder(name) for name in LAUNCH_COUNTERS}
    for name, home in homes.items():
        setattr(home, name, recorders[name])
    masking.percentile_mask = recorders["percentile_mask"]
    try:
        yield
    finally:
        for name, home in homes.items():
            setattr(home, name, orig[name])
        masking.percentile_mask = orig["percentile_mask"]
        for name in LAUNCH_COUNTERS:
            orig[name].launches += recorders[name].launches


def train_phase(torch, conv_chw, pmask, masking, cfg, coop, draws_mod, image, label,
                conv_s2=False, conv_nl=False):
    """The train phase (see the module docstring) of one configuration.
    Returns (launches by wrapper over the phase, the random steps' calls by
    wrapper and shape, step times of the random steps)."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
        frozen_stats,
    )

    wrappers = wrappers_of(conv_chw, pmask)
    trainer = coop.CooperativeTrainer(cfg.LatentDAConfig(), compute_dtype=torch.bfloat16,
                                      device="cuda", seed=0, conv_s2=conv_s2, conv_nl=conv_nl)
    tag = "S2 " if conv_s2 else "NL " if conv_nl else ""
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
            want = {**dict.fromkeys(LAUNCH_COUNTERS, 0), **trainer.expected_launches(branches)}
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
            print(f"  {tag}{mask_type:7s} branches image "
                  f"{branches['image']} shape "
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


def train_check(torch, cfg, coop, draws_mod, image, label, conv_s2=False, conv_nl=False):
    """One f32 step on the card against the same step on the CPU (see the
    module docstring), in the default configuration, ``conv_s2=True`` or
    ``conv_nl=True``.
    Tolerances, f32 sums in other orders:

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
    gpu = coop.CooperativeTrainer(lda, device="cuda", seed=1, conv_s2=conv_s2,
                                  conv_nl=conv_nl)
    got_m = gpu.train_step(img.to("cuda"), lbl.to("cuda"), draws.to("cuda"))

    def cpu_step(x):
        trainer = coop.CooperativeTrainer(lda, device="cpu", seed=1, conv_s2=conv_s2,
                                          conv_nl=conv_nl)
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
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch import bench_b8_conv
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import (
        conv_b8,
        conv_chw,
        conv_nl,
        conv_s2,
        masking,
    )
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
        order = sorted(shapes, key=lambda s: (-s[2], s[0], s[1]))

        def k1(which, shape, n, dtype, timed=True):
            return check_conv(torch, F, conv_chw, conv_chw, "chw", which, shape, n, dtype,
                              flush if timed else None)

        recs = {s: k1("fwd", s, BATCH, "bfloat16") for s in order}
        f32_rec = k1("fwd", (16, 16, 192, 192), BATCH, "float32")
        # the serving batch meets the same shapes at N = 160 (checked, not timed)
        big_recs = [k1("fwd", s, SERVE_BATCH, "bfloat16", timed=False) for s in order]
        bad = [r for r in list(recs.values()) + [f32_rec] + big_recs if not r["ok"]]
        if bad:
            raise AssertionError(f"K1 disagrees with its plain version: {bad}")
        print("  K1 per predict(n_iter=2) request of 20: " + ", ".join(
            f"{key} {sum(shapes[s] * recs[s][key] for s in shapes):.4f}"
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")) + " ms", flush=True)
        # the train step runs K1 dx and K2 at the forward's shapes: dx for
        # every conv whose input needs a gradient (all but C_in = 1, the
        # image), K2 for every conv
        dx_recs = {s: k1("dx", s, TRAIN_BATCH, "bfloat16") for s in order if s[0] > 1}
        dx_f32 = k1("dx", (16, 16, 192, 192), TRAIN_BATCH, "float32")
        dw_recs = {s: k1("dw", s, TRAIN_BATCH, "bfloat16") for s in order}
        dw_f32 = k1("dw", (16, 16, 192, 192), TRAIN_BATCH, "float32")
        k3_recs = {(d, soft): check_k3(torch, pmask, TRAIN_BATCH, d, soft,
                                       flush if soft else None)
                   for d in (128, 144) for soft in (False, True)}
        # K4, K4dx and K4dw under conv_s2=True: the encoders' two stride-2
        # shapes, timed in bf16 at the training and the serving batch,
        # checked in f32 at the training batch
        s2_recs = {(which, n): {sh: check_conv(torch, F, conv_chw, conv_s2, "s2", which, sh,
                                               n, "bfloat16", flush) for sh in S2_SHAPES}
                   for which in ("fwd", "dx", "dw") for n in (TRAIN_BATCH, SERVE_BATCH)}
        s2_f32 = {which: [check_conv(torch, F, conv_chw, conv_s2, "s2", which, sh,
                                     TRAIN_BATCH, "float32") for sh in S2_SHAPES]
                  for which in ("fwd", "dx", "dw")}
        # K5, K5dx and K5dw under conv_nl=True: the four large-channel
        # shapes, timed in bf16 at the training batch, checked at the
        # serving batch and in f32
        nl_recs = {which: {sh: check_conv(torch, F, conv_chw, conv_nl, "nl", which, sh,
                                          TRAIN_BATCH, "bfloat16", flush) for sh in NL_SHAPES}
                   for which in ("fwd", "dx", "dw")}
        nl_other = {which: [check_conv(torch, F, conv_chw, conv_nl, "nl", which, sh, n, dt)
                            for sh in NL_SHAPES
                            for n, dt in ((SERVE_BATCH, "bfloat16"), (TRAIN_BATCH, "float32"))]
                    for which in ("fwd", "dx", "dw")}
        # K6, K6dx and K6dw at the five stages of bench_b8_conv, timed in
        # bf16 at its batch, and one stage checked in f32
        b8_shapes = [(ci, co, h, h) for h, ci, co in bench_b8_conv.STAGES]
        b8_recs = {which: {sh: check_conv(torch, F, conv_chw, conv_b8, "b8", which, sh,
                                          TRAIN_BATCH, "bfloat16", flush) for sh in b8_shapes}
                   for which in ("fwd", "dx", "dw")}
        b8_f32 = {which: [check_conv(torch, F, conv_chw, conv_b8, "b8", which, b8_shapes[0],
                                     TRAIN_BATCH, "float32")] for which in ("fwd", "dx", "dw")}
        del flush
        bad = [r for r in list(dx_recs.values()) + [dx_f32] + list(dw_recs.values())
               + [dw_f32] + list(k3_recs.values())
               + [r for group in s2_recs.values() for r in group.values()]
               + [r for group in s2_f32.values() for r in group]
               + [r for group in nl_recs.values() for r in group.values()]
               + [r for group in nl_other.values() for r in group]
               + [r for group in b8_recs.values() for r in group.values()]
               + [r for group in b8_f32.values() for r in group] if not r["ok"]]
        if bad:
            raise AssertionError(f"a kernel disagrees with its plain version: {bad}")
        torch.cuda.empty_cache()

    wrappers = wrappers_of(conv_chw, pmask)
    gpu_s2 = CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=0,
                                  conv_s2=True)
    gpu_s2.load_state_dict(gpu.state_dict())
    gpu_nl = CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=0,
                                  conv_nl=True)
    gpu_nl.load_state_dict(gpu.state_dict())

    def convs_per_request(model, uses):
        """Convs ``uses`` picks in one predict(n_iter=2): the FTN's encoder
        and segmentation decoder once, the STN once per refinement."""
        def count(module):
            return sum(isinstance(c, conv_chw.Conv) and uses(c) for c in module.modules())
        return (count(model.image_encoder) + count(model.segmentation_decoder)
                + (N_ITER - 1) * (count(model.shape_encoder) + count(model.shape_decoder)))

    k4_per_request = convs_per_request(gpu_s2, conv_chw.Conv.uses_k4)
    k5_per_request = convs_per_request(gpu_nl, conv_chw.Conv.uses_k5)

    with phase("serve"):
        def serve(model, img, extra=None):
            """One request; ``extra`` is (wrapper, launches it must make)."""
            before = (conv_chw.conv3x3_chw.launches, extra[0].launches if extra else 0)
            t0 = time.perf_counter()
            out = model.predict(torch.from_numpy(img).to("cuda"), n_iter=N_ITER).cpu()
            sec = time.perf_counter() - t0
            launched = (conv_chw.conv3x3_chw.launches - before[0],
                        extra[0].launches - before[1] if extra else 0)
            want = (per_request, extra[1] if extra else 0)
            if launched != want:
                raise AssertionError(f"K1 and {extra[0].__name__ if extra else 'no other'} "
                                     f"launched {launched} times for one request, "
                                     f"expected {want}")
            if out.shape != (img.shape[0], 192, 192, 4) or not torch.isfinite(out).all():
                raise AssertionError(f"bad output {tuple(out.shape)}")
            return sec

        def report(batch, lat, what=""):
            med = statistics.median(lat)
            p90 = statistics.quantiles(lat, n=10)[-1]
            print(f"  {what}batch {batch}, {len(lat)} requests: latency min "
                  f"{min(lat) * 1e3:.3f} median {med * 1e3:.3f} p90 {p90 * 1e3:.3f} max "
                  f"{max(lat) * 1e3:.3f} ms; {batch / med:.1f} slices/s at the median",
                  flush=True)

        for wrapper in wrappers.values():
            wrapper.launches = 0
        serve(gpu, big)                              # warm-up
        report(SERVE_BATCH, [serve(gpu, big) for _ in range(N_SERVE_REQUESTS)])
        serve(gpu, images[0])                        # warm-up
        serve(gpu, images[1])
        report(BATCH, [serve(gpu, images[r % N_IMAGES]) for r in range(N_REQUESTS)])
        serve_launches = {k: w.launches for k, w in wrappers.items()}
        if serve_launches["conv3x3_chw"] == 0:
            raise AssertionError("K1 never launched on the serving path")
        if any(v for k, v in serve_launches.items() if k != "conv3x3_chw"):
            raise AssertionError(f"serving launched another kernel than K1: {serve_launches}")
        print(f"  K1 launches during the {N_SERVE_REQUESTS + N_REQUESTS + 3} requests "
              f"(warm-ups included): {serve_launches['conv3x3_chw']}", flush=True)

        # conv_s2=True and conv_nl=True: the same requests with the
        # downsamples on K4, or the large-channel convs on K5
        routed = {}
        for name, model, wrapper, k in (("conv_s2", gpu_s2, conv_s2.conv3x3s2, k4_per_request),
                                        ("conv_nl", gpu_nl, conv_nl.conv3x3_nl,
                                         k5_per_request)):
            for w in wrappers.values():
                w.launches = 0
            serve(model, images[0], (wrapper, k))    # warm-up
            serve(model, images[1], (wrapper, k))
            report(BATCH, [serve(model, images[r % N_IMAGES], (wrapper, k))
                           for r in range(N_REQUESTS)], f"{name}: ")
            got = {key: w.launches for key, w in wrappers.items()}
            kname = wrapper.__name__
            if got[kname] != k * (N_REQUESTS + 2) or any(
                    v for key, v in got.items() if key not in ("conv3x3_chw", kname)):
                raise AssertionError(f"{name} serving launches {got}")
            print(f"  {name}: {k} {kname} launches a request; K1 and {kname} launches "
                  f"during the {N_REQUESTS + 2} requests: {got['conv3x3_chw']}, "
                  f"{got[kname]}", flush=True)
            routed[name] = got
        s2_serve_launches, nl_serve_launches = routed["conv_s2"], routed["conv_nl"]

        # a model in train mode predicts in eval mode and leaves its state
        gpu_s2.train()
        buffers = {k: v.clone() for k, v in gpu_s2.named_buffers()}
        x0 = torch.from_numpy(images[0]).to("cuda")
        got = gpu_s2.predict(x0, n_iter=N_ITER)
        kept = all(torch.equal(v, buffers[k]) for k, v in gpu_s2.named_buffers())
        modes = all(m.training for m in gpu_s2.modules())
        gpu_s2.eval()
        same = bool(torch.equal(got, gpu_s2.predict(x0, n_iter=N_ITER)))
        print(f"  predict on the model in train mode: buffers unchanged {kept}, modes "
              f"restored {modes}, output equal to eval mode's {same}", flush=True)
        if not (kept and modes and same):
            raise AssertionError("predict on a model in train mode changed it or its output")

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
        del gpu32, cpu32
        # conv_s2=True and conv_nl=True: the bf16 layers (K4, or K5, among
        # them) and the f32 output
        for name, model, flags in (("conv_s2", gpu_s2, dict(conv_s2=True)),
                                   ("conv_nl", gpu_nl, dict(conv_nl=True))):
            twin = CooperativePredictor(compute_dtype=torch.bfloat16, device="cpu", seed=0,
                                        **flags)
            twin.load_state_dict(gpu.state_dict())
            replay_leaves(torch, model, twin, images[0], f"{name} bf16 layer by layer")
            card32 = CooperativePredictor(device="cuda", seed=0, **flags)
            twin32 = CooperativePredictor(device="cpu", seed=0, **flags)
            card32.load_state_dict(gpu.state_dict())
            twin32.load_state_dict(gpu.state_dict())
            compare_f32(card32.predict(x0.to("cuda"), n_iter=N_ITER).cpu(),
                        twin32.predict(x0, n_iter=N_ITER),
                        f"{name} f32 path vs CPU plain, end to end")
            del twin, card32, twin32

    del gpu, cpu, gpu_s2, gpu_nl
    torch.cuda.empty_cache()
    train_image, train_label = phantom_batch(seed=7, n=TRAIN_BATCH)
    configs = {"default": {}, "conv_s2": dict(conv_s2=True), "conv_nl": dict(conv_nl=True)}

    with phase("train"):
        runs = {}
        for name, flags in configs.items():
            runs[name] = train_phase(torch, conv_chw, pmask, masking, cfg, coop, draws_mod,
                                     train_image, train_label, **flags)
            step_times = runs[name][2]
            med = statistics.median(step_times)
            p90 = statistics.quantiles(step_times, n=10)[-1]
            print(f"  {name}: {RANDOM_STEPS} random steps of batch "
                  f"{TRAIN_BATCH} (host clock, smoke-level): min {min(step_times) * 1e3:.3f} "
                  f"median {med * 1e3:.3f} p90 {p90 * 1e3:.3f} max "
                  f"{max(step_times) * 1e3:.3f} ms; {TRAIN_BATCH / med:.1f} slices/s at the "
                  f"median", flush=True)
            print(f"  launches over the {name} train phase: {runs[name][0]}", flush=True)
            torch.cuda.empty_cache()
        # the configuration whose steps each kernel's per-step numbers come from
        source = {k: "default" for k in LAUNCH_COUNTERS[:4]}
        source.update(dict.fromkeys(LAUNCH_COUNTERS[4:7], "conv_s2"))
        source.update(dict.fromkeys(LAUNCH_COUNTERS[7:10], "conv_nl"))
        missing = [k for k in LAUNCH_COUNTERS[:10] if runs[source[k]][0][k] == 0]
        if missing:
            raise AssertionError(f"never launched on the training paths: {missing}")

    with phase("train-check"):
        for name, flags in configs.items():
            print(f"  {name}:", flush=True)
            train_check(torch, cfg, coop, draws_mod, train_image, train_label, **flags)

    with phase("b8"):
        for w in wrappers.values():
            w.launches = 0
        b8_bench = bench_b8_conv.run(batch=TRAIN_BATCH, dtype="bfloat16", device="cuda",
                                     reps=B8_REPS)
        b8_launches = {k: w.launches for k, w in wrappers.items()}
        if any(b8_launches[k] == 0 for k in LAUNCH_COUNTERS[10:]) or any(
                v for k, v in b8_launches.items()
                if k not in LAUNCH_COUNTERS[10:] + ("conv3x3_chw", "conv3x3_chw_dx",
                                                   "conv3x3_chw_dw")):
            raise AssertionError(f"bench_b8_conv launches {b8_launches}")
        print(f"  launches over the bench: {b8_launches}; B8 forward against cuDNN "
              + ", ".join(f"{r['stage']} {r['b8_vs_cudnn']:.3f}x" for r in b8_bench),
              flush=True)

    total = time.perf_counter() - t_start
    print(f"chip_smoke total {total:.1f} s", flush=True)

    # one record per kernel: ms, plain_ms, bound_ms and library_ms per
    # train step (batch 20, the mean calls per shape over the random steps
    # times each shape's median time at N = 20): K1, K2 and K3 from the
    # default configuration's steps, K4, K4dx and K4dw from conv_s2's, K5,
    # K5dx and K5dw from conv_nl's; K6, K6dx and K6dw per pass of the bench
    # over its five stages (one launch each).  K1's serving numbers per
    # request are printed in the kernels phase
    per_step = {k: {sh: n / RANDOM_STEPS for sh, n in runs[source[k]][1][k].items()}
                for k in LAUNCH_COUNTERS[:10]}
    per_step.update({k: dict.fromkeys(b8_shapes, 1.0) for k in LAUNCH_COUNTERS[10:]})
    timed = {"conv3x3_chw": recs, "conv3x3_chw_dx": dx_recs, "conv3x3_chw_dw": dw_recs,
             "percentile_mask": {(n, d): k3_recs[(d, True)] for (d, soft) in k3_recs if soft
                                 for n in (TRAIN_BATCH,)},
             "conv3x3s2": s2_recs[("fwd", TRAIN_BATCH)],
             "conv3x3s2_dx": s2_recs[("dx", TRAIN_BATCH)],
             "conv3x3s2_dw": s2_recs[("dw", TRAIN_BATCH)],
             "conv3x3_nl": nl_recs["fwd"], "conv3x3_nl_dx": nl_recs["dx"],
             "conv3x3_nl_dw": nl_recs["dw"],
             "conv3x3_b8": b8_recs["fwd"], "conv3x3_b8_dx": b8_recs["dx"],
             "conv3x3_b8_dw": b8_recs["dw"]}
    checked = {"conv3x3_chw": list(recs.values()) + [f32_rec] + big_recs,
               "conv3x3_chw_dx": list(dx_recs.values()) + [dx_f32],
               "conv3x3_chw_dw": list(dw_recs.values()) + [dw_f32],
               "percentile_mask": list(k3_recs.values())}
    for name, which in (("conv3x3s2", "fwd"), ("conv3x3s2_dx", "dx"), ("conv3x3s2_dw", "dw")):
        checked[name] = [r for n in (TRAIN_BATCH, SERVE_BATCH)
                         for r in s2_recs[(which, n)].values()] + s2_f32[which]
    for group, others, base in ((nl_recs, nl_other, "conv3x3_nl"),
                                (b8_recs, b8_f32, "conv3x3_b8")):
        for which, name in (("fwd", base), ("dx", f"{base}_dx"), ("dw", f"{base}_dw")):
            checked[name] = list(group[which].values()) + others[which]
    launches = {k: serve_launches[k] + s2_serve_launches[k] + nl_serve_launches[k]
                + sum(run[0][k] for run in runs.values()) + b8_launches[k]
                for k in LAUNCH_COUNTERS}
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
        source_file, replaces = KERNELS[name]
        records.append({
            "name": name, "route": "cuda", "source": source_file, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in checked[name]),
            "ms": total_of("ms"), "plain_ms": total_of("plain_ms"),
            "bound_ms": total_of("bound_ms"), "bound_by": by.most_common(1)[0][0],
            "library_ms": total_of("library_ms"),
        })
        unit = "bench pass" if name in LAUNCH_COUNTERS[10:] else "random step"
        print(f"  {name}: {sum(calls.values()):.1f} calls per {unit} at {len(calls)} "
              f"shapes; per {unit} ms {records[-1]['ms']:.4f} plain "
              f"{records[-1]['plain_ms']:.4f} bound {records[-1]['bound_ms']:.6f} library "
              f"{records[-1]['library_ms']}", flush=True)
    # K2 by shape: launches per random step (default configuration) beside
    # the kernels phase's times at N = 20, bf16
    k2_calls, k2 = per_step["conv3x3_chw_dw"], records[LAUNCH_COUNTERS.index("conv3x3_chw_dw")]
    print("  K2 by shape (C_in->C_out @ HxW: launches per random step, ms, cuDNN "
          "conv2d_weight ms, bound ms):", flush=True)
    for sh in sorted(k2_calls, key=lambda s: (-s[2], s[0], s[1])):
        r = dw_recs[sh]
        print(f"    {sh[0]}->{sh[1]} @ {sh[2]}x{sh[3]}: {k2_calls[sh]:.1f}, {r['ms']:.4f}, "
              f"{r['library_ms']:.4f}, {r['bound_ms']:.4f}", flush=True)
    print(f"  K2 per random step: {k2['ms']:.4f} ms; cuDNN conv2d_weight at the same shapes "
          f"{k2['library_ms']:.4f} ms; bound {k2['bound_ms']:.4f} ms", flush=True)
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
