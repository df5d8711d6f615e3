"""The port's cooperative train step against the JAX package's, float32,
on the CPU, two steps in a row: ``mask_type`` channel and random (the main
path's).  Dropout and spatial, and the reasons for each bound, are in
test_torch_port_step.py; the checks are torch_port_util.check_step_*.
"""

import pytest

from torch_port_util import (  # noqa: F401 - one_torch_thread is a fixture
    check_step_masks,
    check_step_metrics,
    check_step_moments_and_update,
    check_step_running_stats,
    one_torch_thread,
    run_step_case,
)


@pytest.fixture(scope="module", params=["channel", "random"])
def case(request):
    return request.param, run_step_case(request.param)


@pytest.mark.parametrize("i", [0, 1])
def test_metrics_match(case, i):
    mask_type, steps = case
    check_step_metrics(steps[i], f"{mask_type} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_masks_match(case, i):
    mask_type, steps = case
    check_step_masks(steps[i], mask_type, f"{mask_type} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_running_stats_match(case, i):
    mask_type, steps = case
    check_step_running_stats(steps[i], f"{mask_type} step {i + 1}")


@pytest.mark.parametrize("i", [0, 1])
def test_adam_moments_and_update_match(case, i):
    mask_type, steps = case
    check_step_moments_and_update(steps[i], f"{mask_type} step {i + 1}")
