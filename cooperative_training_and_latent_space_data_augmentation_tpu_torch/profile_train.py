"""Where the time of one cooperative train step goes on the card.

    python -m cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_train

Trains at full width (FCN_16, 192x192x1, batch 20, bf16 convs, latent DA on
both codes with ``mask_type="random"``, weights from a seed) on one fixed
phantom batch, as ``chip_smoke.py``'s train phase does.  After 3 warm-up
steps it times 20 untraced steps on the host clock (each ending in a
synchronize) as min / median / p90 / max, then traces 5 steps with
``torch.profiler`` and prints the device time per step by group (K1 forward
and dx, K2, K3, cuDNN, other kernels, copies), the device's idle share over
the traced window, and the kernels that take the most device time.  Needs a
CUDA device.
"""

from __future__ import annotations

import statistics
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (
    LatentDAConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data.synthetic import (
    phantom_batch,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
    _group,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.draws import (
    draw_step,
)

BATCH = 20
WARMUP, TIMED, TRACED = 3, 20, 5
TOP = 15


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    print(torch.cuda.get_device_name(0))
    trainer = CooperativeTrainer(LatentDAConfig(), compute_dtype=torch.bfloat16,
                                 device="cuda", seed=0)
    image, label = phantom_batch(seed=7, n=BATCH)
    image, label = torch.from_numpy(image).to("cuda"), torch.from_numpy(label).to("cuda")
    gen = torch.Generator().manual_seed(0)

    def step():
        draws = draw_step(gen, BATCH, (192, 192), trainer.latent_da, device="cuda")
        trainer.train_step(image, label, draws)
        torch.cuda.synchronize()

    for _ in range(WARMUP):
        step()
    times = []
    for _ in range(TIMED):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    p90 = statistics.quantiles(times, n=10)[-1]
    print(f"step time over {TIMED} steps (host clock): min {min(times) * 1e3:.3f} median "
          f"{med * 1e3:.3f} p90 {p90 * 1e3:.3f} max {max(times) * 1e3:.3f} ms; "
          f"{BATCH / med:.1f} slices/s at the median")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            step()
        window = time.perf_counter() - t0
    by_group = defaultdict(float)
    kernels = []
    for evt in prof.key_averages():
        # device-side events only: a CPU op's entry repeats its kernels' time
        if evt.device_type != DeviceType.CUDA:
            continue
        by_group[_group(evt.key)] += evt.self_device_time_total
        kernels.append((evt.self_device_time_total, evt.count, evt.key))
    busy = sum(by_group.values())
    if busy == 0:
        print("the profiler saw no device time: device breakdown not measured")
        return 0
    print(f"traced {TRACED} steps in {window * 1e3:.3f} ms; device busy {busy / 1e3:.3f} ms, "
          f"idle share {1 - busy / 1e6 / window:.3f}")
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g}: {us / 1e3 / TRACED:.3f} ms per step ({us / busy:.1%} of device time)")
    print(f"top {TOP} kernels by device time (per step):")
    for us, count, key in sorted(kernels, reverse=True)[:TOP]:
        print(f"  {us / 1e3 / TRACED:8.3f} ms  x{count / TRACED:<7.1f} {key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
