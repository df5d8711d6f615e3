"""Where the time of one ``predict(n_iter=2)`` request goes on the card.

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict [--conv-s2] [--conv-nl]

Serves phantom requests (bf16, weights from a seed) through
``CooperativePredictor.predict``, as ``chip_smoke.py`` does, and traces a few
of them with ``torch.profiler``.  Prints, per batch size (20 and 160): the
host-clock latency of a request (numpy in, numpy out) over 50 untraced
requests, as min / median / p90 / max, the device time per request by
group (kernels K1, K4, K4dx, K4dw and K5, cuDNN convolutions, other kernels,
copies), the device's idle share over the traced window, and the kernels
that take the most device time.  Device busy is the sum of the kernels'
and copies' device time (:func:`device_time`): ``record_function`` ranges,
which the trace also shows on the device, are printed apart and not
counted.  ``--conv-s2`` serves the ``conv_s2=True`` configuration
(the encoders' stride-2 downsamples on K4), ``--conv-nl`` the
``conv_nl=True`` one (the residual stages' large-channel 3x3 convs on K5);
the two combine.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
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
    if "conv3x3_nl_dw" in name:
        return "K5dw conv3x3_nl_dw"
    if "conv3x3_nl" in name:
        return "K5 conv3x3_nl (forward and dx)"
    if "conv3x3_b8_dw" in name:
        return "K6dw conv3x3_b8_dw"
    if "conv3x3_b8" in name:
        return "K6 conv3x3_b8 (forward and dx)"
    if "conv3x3s2_dw" in name:
        return "K4dw conv3x3s2_dw"
    if "conv3x3s2_dx" in name:
        return "K4dx conv3x3s2_dx"
    if "conv3x3s2" in name:
        return "K4 conv3x3s2"
    if any(k in name for k in ("conv3x3_chw_kernel", "conv3x3_chw_mma_kernel")):
        return "K1 conv3x3_chw (forward and dx)"
    if any(k in name for k in ("dw_partial_kernel", "dw_mma_partial_kernel",
                               "dw_reduce_kernel")):
        return "K2 conv3x3_chw_dw"
    if "percentile_mask_kernel" in name:
        return "K3 percentile_mask"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("cudnn", "conv", "xmma", "implicit", "sm90_")):
        return "cuDNN/cuBLAS convs and matmuls"
    return "other kernels (elementwise, BN, casts, upsample)"


def device_time(events):
    """Device time of a trace's ``key_averages()`` entries, in microseconds:
    ``(by_group, ranges, kernels)``.  Only device-side entries count (a CPU
    op's entry repeats its kernels' time).  A ``record_function`` range
    (``is_user_annotation``) also shows on the device's timeline, as a span
    over kernels counted on their own, idle gaps included: ranges are
    summed apart into ``ranges`` and left out of ``by_group``, so that
    busy, ``sum(by_group.values())``, counts each kernel once.  ``kernels``
    lists (device time, launches, name) of every kernel and copy.  The
    attribute is read directly, so a torch without it raises."""
    by_group = defaultdict(float)
    kernels = []
    ranges = 0.0
    for evt in events:
        annotation = evt.is_user_annotation
        if evt.device_type != DeviceType.CUDA:
            continue
        if annotation:
            ranges += evt.self_device_time_total
            continue
        by_group[_group(evt.key)] += evt.self_device_time_total
        kernels.append((evt.self_device_time_total, evt.count, evt.key))
    return by_group, ranges, kernels


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
    by_group, ranges, kernels = device_time(prof.key_averages())
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
          f"{busy / 1e3:.3f} ms, idle share {1 - busy / 1e6 / window:.3f}; record_function "
          f"ranges on the device, not in busy: {ranges / 1e3 / TRACED_REQUESTS:.3f} ms per "
          f"request")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / 1e3 / TRACED_REQUESTS:.3f} ms per request "
              f"({us / busy:.1%} of device time)")
    print(f"  top {TOP} kernels by device time (per request):")
    for us, count, key in sorted(kernels, reverse=True)[:TOP]:
        print(f"    {us / 1e3 / TRACED_REQUESTS:8.3f} ms  x{count // TRACED_REQUESTS:<4d} {key[:110]}")


def configuration(args) -> str:
    """The configuration's name from the ``--conv-s2``/``--conv-nl`` flags."""
    on = [name for name, flag in (("conv_s2", args.conv_s2), ("conv_nl", args.conv_nl))
          if flag]
    return " + ".join(on) or "default configuration"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--conv-s2", action="store_true",
                        help="the encoders' stride-2 downsamples on kernel K4")
    parser.add_argument("--conv-nl", action="store_true",
                        help="the residual stages' large-channel 3x3 convs on kernel K5")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_predict: needs a CUDA device")
    print(torch.cuda.get_device_name(0), configuration(args))
    predictor = CooperativePredictor(compute_dtype=torch.bfloat16, device="cuda", seed=0,
                                     conv_s2=args.conv_s2, conv_nl=args.conv_nl)
    for batch in BATCHES:
        profile_batch(predictor, batch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
