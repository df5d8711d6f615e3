"""The profile scripts put every kernel of the port in its own row.

``profile_predict._group`` sorts the profiler's kernel names into rows by
substring; a K1 kernel whose name it does not know would land in the cuDNN
row ("conv" in its name) and K1's device time would move there unseen.  This
reads every ``__global__`` function of each ``csrc/*.cu`` source, checks
that the map below names each of them (a new kernel must be given its row),
builds the name as the profiler prints it and checks the row.  K4's, K5's
and K6's sources hold two rows each: the forward (K4 also with K4dx, K5 and
K6 also run for dx) and the weight gradient (K4dw, K5dw, K6dw).  CPU only,
no CUDA.
"""

import re

import pytest

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
    _group,
)

ROWS = {  # source -> {kernel -> the start of its row's label}
    "conv3x3_chw.cu": {"conv3x3_chw_kernel": "K1 ", "conv3x3_chw_mma_kernel": "K1 "},
    "conv3x3_chw_dw.cu": {"dw_partial_kernel": "K2 ", "dw_mma_partial_kernel": "K2 ",
                          "dw_reduce_kernel": "K2 "},
    "percentile_mask.cu": {"percentile_mask_kernel": "K3 "},
    "conv3x3s2.cu": {"conv3x3s2_fwd_kernel": "K4 ", "conv3x3s2_dx_kernel": "K4 ",
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
