"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

run from the repository root, with no arguments and no install step.  It
drives the port's serving path, the cooperative FTN+STN predictor
(``CooperativePredictor.predict(n_iter=2)``), at its full width (FCN_16:
16/32/64/128/128 channels, 192x192x1 slices, 4 classes, bf16 convs) with
weights drawn from a seed, on cardiac-like phantom slices made from a seed.

Phases, each printing its seconds when it ends:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every CUDA kernel of the port, compiled by ``nvcc`` from
   ``csrc/``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the main path gives it (batch 20 and 160, bf16) and one f32
   shape, with the tolerance stated; at batch 20, median times from CUDA
   events for the kernel, the plain version and one library call computing
   the same function (``library_ms``, a yardstick the port never calls),
   and the least time the card could take (``bound_ms``);
4. serve: 10 requests of 160 slices, then 50 of 20, each batch size after
   its own warm-up, through ``predict``, with K1's launch count set to 0
   just before and read just after.  Each request must launch K1 as often
   as the path has K1 convs and return finite values of the right shape.
   Latency is on the host clock, as min / median / p90 / max over the
   requests: a smoke-level reading, not a benchmark;
5. check: every leaf module (conv, BN, activation) of one bf16 and one f32
   request on the card held against its CPU twin on the very input the
   card gave it (one rounding apart at most); then the f32 and bf16 outputs
   end to end against the same predictor on the CPU.

The last lines are the card's ``nvidia-smi`` line, one JSON object with a
record per kernel, and ``{"ok": true, "device": {...}}``, printed only when
every phase passed.  Any failure exits non-zero.  Without a CUDA device, or
without the port's package beside this file, it exits non-zero before
printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager

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
K1_SOURCE = f"{PORT}/csrc/conv3x3_chw.cu"
K1_REPLACES = "cooperative_training_and_latent_space_data_augmentation_tpu/ops/pallas_conv.py:139"


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
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops import conv_chw
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
        del flush
        # the serving batch meets the same shapes at N = 160 (checked, not timed)
        big_recs = [check_k1(torch, F, conv_chw, s, SERVE_BATCH, "bfloat16")
                    for s in sorted(shapes, key=lambda s: (-s[2], s[0], s[1]))]
        bad = [r for r in list(recs.values()) + [f32_rec] + big_recs if not r["ok"]]
        if bad:
            raise AssertionError(f"K1 disagrees with its plain version: {bad}")
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

        conv_chw.conv3x3_chw.launches = 0
        serve(big)                                   # warm-up
        report(SERVE_BATCH, [serve(big) for _ in range(N_SERVE_REQUESTS)])
        serve(images[0])                             # warm-up
        serve(images[1])
        report(BATCH, [serve(images[r % N_IMAGES]) for r in range(N_REQUESTS)])
        launches = conv_chw.conv3x3_chw.launches
        if launches == 0:
            raise AssertionError("K1 never launched on the main path")
        print(f"  K1 launches during the {N_SERVE_REQUESTS + N_REQUESTS + 3} requests "
              f"(warm-ups included): {launches}", flush=True)

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

    total = time.perf_counter() - t_start
    print(f"chip_smoke total {total:.1f} s", flush=True)

    # one record per kernel: times are per predict(n_iter=2) request of
    # BATCH slices, each shape's median time times its launches per request
    def per_req(key):
        return sum(shapes[s] * recs[s][key] for s in shapes)

    bytes_or_ops = Counter()
    for s in shapes:
        bytes_or_ops[recs[s]["bound_by"]] += shapes[s] * recs[s]["bound_ms"]
    record = {
        "name": "conv3x3_chw", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max(r["max_abs_err"]
                           for r in list(recs.values()) + [f32_rec] + big_recs),
        "ms": per_req("ms"), "plain_ms": per_req("plain_ms"),
        "bound_ms": per_req("bound_ms"), "bound_by": bytes_or_ops.most_common(1)[0][0],
        "library_ms": per_req("library_ms"),
    }
    print(smi)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
