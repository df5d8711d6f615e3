"""The cooperative step with ``separate_training=True`` (the STN reads the
FTN's prediction detached, in the standard and the hard pass, so the STN's
losses do not train the FTN) and with the saliency-BN arm (the trainer's
``saliency_bn_update``, the JAX package's ``SALIENCY_BN_UPDATE=1``: each
perturbed code's decoder runs once more on the unmasked code, its BN
statistics kept where the branch was targeted) against the JAX package's.

Each configuration against the JAX package's on the CPU at 32x32, batch
2, latent DA ``mask_type="random"`` on both codes (the main path's), two
steps (``STEP_KEYS``), each port step from JAX's state before it on JAX's
draws, by ``torch_port_util``'s ``test_variant_*`` checks at the step
files' float32 tolerances: metrics within 1e-4 of their value (the four
hard losses only at steps whose generation masks equal JAX's, the loop
test's rule: a swap near the threshold makes another hard example),
running statistics within 1e-4 of each tensor's scale, Adam's moments and
the update within ``check_step_moments_and_update``'s sensitivity bound,
the generation masks as ``check_step_masks`` holds them, and the number
of dropout masks used.
"""

import pytest
from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture, test_variant_* are tests
    one_torch_thread,
    run_variant,
    test_variant_masks_match_jax,
    test_variant_metrics_match_jax,
    test_variant_moments_and_update_match_jax,
    test_variant_running_stats_match_jax,
)


@pytest.fixture(scope="module", params=['separate_training', 'saliency_bn_update'])
def variant(request):
    return request.param, run_variant(request.param)
