"""The port's data-parallel step in its ``fused_stn`` arm (the STN passes
stacked along the batch, BatchNorm on per-pass statistics of the global
batch) on two gloo ranks on the CPU, against the JAX package's
``make_train_step(fused_stn=True)`` over a 2-device mesh and against the
port's one-process ``fused_stn`` step, with the tolerances of
``tests/torch_port_ddp_util.py`` (its docstring).  A file of its
own: JAX compiles a second step here, and each file stays under 90 s.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_port_ddp_ranks as R
from torch_port_ddp_util import (
    BATCH,
    HW,
    W,
    check_against_jax,
    check_against_one,
    check_ranks_equal,
    data,
    jax_sharded_steps,
    key_for,
    one_process,
)
from torch_port_util import (  # noqa: F401
    jax_train_state,
    make_solver,
    one_torch_thread,
    random_variables,
    replay_draws,
    step_configs,
)

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.parallel import mesh as pmesh

BRANCHES = (2, 1)  # channel masking on the image code, spatial on the shape code


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    solver = make_solver()
    params, stats = random_variables(solver, seed=0)
    image, label = data()
    jlda, lda = step_configs("random")
    key = key_for(lda, *BRANCHES)
    draws = replay_draws(jax.random.PRNGKey(key), lda, BATCH, (HW, HW))
    sd = convert.from_jax(params, stats)
    store = str(tmp_path_factory.mktemp("mesh") / "store")
    kw = {"fused_stn": True}
    # the ranks, the one-process steps and JAX's compile side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        ranks = pool.submit(pmesh.launch, R.step_cases, W, "cpu", store, args=(
            lda, sd, torch.from_numpy(image), torch.from_numpy(label), [draws], kw))
        one = pool.submit(one_process, lda, sd, image, label, draws, **kw)
        batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
        jax_out = jax_sharded_steps(solver, jax_train_state(solver, params, stats), batch,
                                    [key], latent_da=jlda, fused_stn=True)[0]
        ranks, one = [r[0] for r in ranks.result()], one.result()
    return {"lda": lda, "sd": sd, "draws": draws, "jax": jax_out, "one": one, "ranks": ranks}


def test_fused_stn_draws_targeted_branches(run):
    assert (run["draws"].image.branch, run["draws"].shape.branch) == BRANCHES


def test_ddp_fused_stn_step_matches_jax_sharded_step(run):
    check_against_jax(run["ranks"], *run["jax"], "fused_stn")


def test_ddp_fused_stn_step_matches_one_process(run):
    check_against_one(run["ranks"], *run["one"], run["sd"], run["lda"], run["draws"],
                      "fused_stn")


def test_ddp_fused_stn_ranks_hold_equal_state(run):
    check_ranks_equal(run["ranks"], "fused_stn")
