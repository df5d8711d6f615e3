"""The profile scripts put every kernel of the port in its own row.

``profile_predict._group`` sorts the profiler's kernel names into rows by
substring; a K1 kernel whose name it does not know would land in the cuDNN
row ("conv" in its name) and K1's device time would move there unseen.  This
reads every ``__global__`` function of each ``csrc/*.cu`` source, builds the
name as the profiler prints it and checks the row.  CPU only, no CUDA.
"""

import re

import pytest

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import kernels
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.profile_predict import (
    _group,
)

ROWS = {  # source -> the start of its row's label
    "conv3x3_chw.cu": "K1 ",
    "conv3x3_chw_dw.cu": "K2 ",
    "percentile_mask.cu": "K3 ",
    "conv3x3s2.cu": "K4 ",
    "conv3x3_nl.cu": "K5 ",
    "conv3x3_b8.cu": "K6 ",
}
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def test_every_source_has_a_row():
    assert set(kernels.SOURCES.values()) == set(ROWS)


@pytest.mark.parametrize("source", sorted(ROWS))
def test_profiler_groups_each_kernel_of(source):
    names = GLOBAL.findall((kernels.CSRC_DIR / source).read_text())
    assert names, f"no __global__ function found in {source}"
    for name in names:
        for printed in (f"void (anonymous namespace)::{name}<1>(float const*, int)",
                        f"void (anonymous namespace)::tc::{name}<2>(__nv_bfloat16 const*)",
                        f"(anonymous namespace)::{name}(float const*, float*, int)"):
            assert _group(printed).startswith(ROWS[source]), (printed, _group(printed))
