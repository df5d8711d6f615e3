"""Where the time of one ``predict(n_iter=2)`` request goes on the card.

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict

Serves phantom requests (bf16, weights from a seed) through
``CooperativePredictor.predict``, as ``chip_smoke.py`` does, and traces a few
of them with ``torch.profiler``.  Prints, per batch size (20 and 160): the
host-clock latency of a request (numpy in, numpy out) over 50 untraced
requests, as min / median / p90 / max, the device time per request by
group (kernel K1, cuDNN convolutions, other kernels, copies), the device's
idle share over the traced window, and the kernels that take the most
device time.  Needs a CUDA device.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    phantom_batch,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)

BATCHES = (20, 160)     # the reference's eval batch; a serving batch
LATENCY_REQUESTS = 50   # untraced, on the host clock
TRACED_REQUESTS = 5
TOP = 12                # kernels listed by device time


def _group(name: str) -> str:
    low = name.lower()
    if "conv3x3_chw_kernel" in name:
        return "K1 conv3x3_chw (forward and dx)"
    if "dw_partial_kernel" in name or "dw_reduce_kernel" in name:
        return "K2 conv3x3_chw_dw"
    if "percentile_mask_kernel" in name:
        return "K3 percentile_mask"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("cudnn", "conv", "xmma", "implicit", "sm90_")):
        return "cuDNN/cuBLAS convs and matmuls"
    return "other kernels (elementwise, BN, casts, upsample)"


def profile_batch(predictor, batch: int) -> None:
    img = phantom_batch(seed=0, n=batch)[0]

    def serve():
        return predictor.predict(torch.from_numpy(img).to("cuda"), n_iter=2).cpu()

    for _ in range(2):
        serve()
    torch.cuda.synchronize()
    lat = []
    for _ in range(LATENCY_REQUESTS):
        t0 = time.perf_counter()
        serve()
        lat.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED_REQUESTS):
            serve()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    by_group = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        # device-side events only: a CPU op's entry repeats its kernels' time
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = evt.self_device_time_total
        by_group[_group(evt.key)] += dev_us
        kernels.append((dev_us, evt.count, evt.key))
    busy = sum(by_group.values())
    med = statistics.median(lat)
    p90 = statistics.quantiles(lat, n=10)[-1]
    print(f"batch {batch}: latency per request over {LATENCY_REQUESTS} requests "
          f"(host clock): min {min(lat) * 1e3:.3f} median {med * 1e3:.3f} p90 "
          f"{p90 * 1e3:.3f} max {max(lat) * 1e3:.3f} ms; {batch / med:.1f} slices/s "
          f"at the median")
    if busy == 0:
        print("  the profiler saw no device time: device breakdown not measured")
        return
    print(f"  traced {TRACED_REQUESTS} requests in {window * 1e3:.3f} ms; device busy "
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / 1e6 / window:.3f}")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / 1e3 / TRACED_REQUESTS:.3f} ms per request "
              f"({us / busy:.1%} of device time)")
    print(f"  top {TOP} kernels by device time (per request):")
    for us, count, key in sorted(kernels, reverse=True)[:TOP]:
        print(f"    {us / 1e3 / TRACED_REQUESTS:8.3f} ms  x{count // TRACED_REQUESTS:<4d} {key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: needs a CUDA device")
    print(torch.cuda.get_device_name(0))
    predictor = CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=0)
    for batch in BATCHES:
        profile_batch(predictor, batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
