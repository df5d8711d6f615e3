"""The fused arms' remaining cases against the JAX package's (see
``test_torch_port_step_fused.py`` for the set-up and the tolerances):
``fused_stn`` without latent DA under ``separate_training``, ``fused_ftn``
without the shape code under ``separate_training``, and ``fused_stn``
with ``remat`` (the stacked STN batch rematerialised in the backward: its
recompute must not move the running statistics a second time, and it
must run stacked again).  Three JAX steps, about 25 s each to compile.
"""

import pytest
import torch_port_fused_arms as F
from torch_port_util import one_torch_thread  # noqa: F401 - a fixture


@pytest.mark.parametrize("arm,kw", [
    ("fused_stn", {"lda_on": False, "separate": True}),
    ("fused_ftn", {"gen_seg": False, "separate": True}),
    ("fused_stn", {"remat": True}),
])
def test_fused_arm_matches_jax(arm, kw):
    F.check_fused_case(F.run_fused_case(arm, **kw), f"{arm} {kw}")
