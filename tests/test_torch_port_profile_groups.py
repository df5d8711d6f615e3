"""The profile scripts put every kernel of the port in its own row.

``profile_predict._group`` sorts the profiler's kernel names into rows by
substring; a K1 kernel whose name it does not know would land in the cuDNN
row ("conv" in its name) and K1's device time would move there unseen.  This
reads every ``__global__`` function of each ``csrc/*.cu`` source, checks
that the map below names each of them (a new kernel must be given its row),
builds the name as the profiler prints it and checks the row.  K4's source
holds three rows (K4, K4dx, K4dw), K5's and K6's two each: the forward (K5
and K6 also run for dx) and the weight gradient (K5dw, K6dw).  Then the
scripts' device busy, ``device_time``, on stub profiler entries: it counts
device-side kernels only and leaves ``record_function`` ranges out.  CPU
only, no CUDA.
"""

import re
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
    _group,
    device_time,
)

ROWS = {  # source -> {kernel -> the start of its row's label}
    "conv3x3_chw.cu": {"conv3x3_chw_kernel": "K1 ", "conv3x3_chw_mma_kernel": "K1 "},
    "conv3x3_chw_dw.cu": {"dw_partial_kernel": "K2 ", "dw_mma_partial_kernel": "K2 ",
                          "dw_reduce_kernel": "K2 "},
    "percentile_mask.cu": {"percentile_mask_kernel": "K3 "},
    "conv3x3s2.cu": {"conv3x3s2_fwd_kernel": "K4 ", "conv3x3s2_mma_kernel": "K4 ",
                     "conv3x3s2_dx_kernel": "K4dx ", "conv3x3s2_dx_mma_kernel": "K4dx ",
                     "conv3x3s2_dw_partial_kernel": "K4dw ", "conv3x3s2_dw_mma_kernel": "K4dw ",
                     "conv3x3s2_dw_reduce_kernel": "K4dw "},
    "conv3x3_nl.cu": {"conv3x3_nl_kernel": "K5 ", "conv3x3_nl_mma_kernel": "K5 ",
                      "conv3x3_nl_dw_partial": "K5dw ", "conv3x3_nl_dw_mma_kernel": "K5dw ",
                      "conv3x3_nl_dw_reduce": "K5dw "},
    "conv3x3_b8.cu": {"conv3x3_b8_kernel": "K6 ", "conv3x3_b8_mma_kernel": "K6 ",
                      "conv3x3_b8_dw_partial": "K6dw ", "conv3x3_b8_dw_mma_kernel": "K6dw ",
                      "conv3x3_b8_dw_reduce": "K6dw "},
}
GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__(?:launch_bounds|maxnreg)__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def test_every_source_has_a_row():
    assert set(kernels.SOURCES.values()) == set(ROWS)


@pytest.mark.parametrize("source", sorted(ROWS))
def test_profiler_groups_each_kernel_of(source):
    names = GLOBAL.findall((kernels.CSRC_DIR / source).read_text())
    assert names, f"no __global__ function found in {source}"
    assert set(names) == set(ROWS[source]), f"{source}: map its kernels {names} to their rows"
    for name in names:
        for printed in (f"void (anonymous namespace)::{name}<1>(float const*, int)",
                        f"void (anonymous namespace)::tc::{name}<2>(__nv_bfloat16 const*)",
                        f"(anonymous namespace)::{name}(float const*, float*, int)"):
            assert _group(printed).startswith(ROWS[source][name]), (printed, _group(printed))


K1_NAME = "void (anonymous namespace)::tc::conv3x3_chw_mma_kernel<1>(__nv_bfloat16 const*)"


def _entry(device_type, key, us, **annotation):
    """A stub ``key_averages()`` entry; ``annotation`` is
    ``is_user_annotation=...`` or nothing (a torch without the attribute)."""
    return SimpleNamespace(device_type=device_type, key=key, self_device_time_total=us, count=1,
                           **annotation)


def test_busy_leaves_record_function_ranges_out():
    """A kernel, a device-side ``record_function`` range around it and the
    CPU op that launched it: busy is the kernel's time alone, the range's
    comes back apart."""
    by_group, ranges, kernels_seen = device_time([
        _entry(DeviceType.CUDA, K1_NAME, 40.0, is_user_annotation=False),
        _entry(DeviceType.CUDA, "Optimizer.step#Adam.step", 3000.0, is_user_annotation=True),
        _entry(DeviceType.CPU, "aten::empty", 7.0, is_user_annotation=False),
        _entry(DeviceType.CPU, "Optimizer.step#Adam.step", 5000.0, is_user_annotation=True),
    ])
    assert dict(by_group) == {_group(K1_NAME): 40.0}
    assert ranges == 3000.0
    assert kernels_seen == [(40.0, 1, K1_NAME)]


def test_busy_needs_the_annotation_attribute():
    """An entry without ``is_user_annotation`` (a torch that lacks it)
    raises instead of being counted as a kernel."""
    with pytest.raises(AttributeError):
        device_time([_entry(DeviceType.CUDA, K1_NAME, 40.0)])
