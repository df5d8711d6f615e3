"""``tests/torch_port_curve.py``, the hand-run comparison of the port's
training curve with the JAX package's, kept working at a tiny width: the
port's ``train_network`` from JAX's initial weights at seed 40 on JAX's
replayed draws, at the configuration's learning rate (1e-4), beside JAX's
own ``train_network`` on the CPU, float32, 3 epochs of 2 steps each
(phantoms padded to 40 and cropped to 32, batch 4, 4 training and 2
validation phantoms).

Held: epoch 0's total loss within ``FIRST_RTOL`` = 1e-2 of JAX's (its
first step starts from the same weights), every later epoch's within
``LOSS_RTOL`` = 5e-2, and the validation Mean IoU within ``IOU_ATOL`` =
0.05 (measured, one torch thread: 0.15 %, 1.5 % and 0.55 % of the loss
over the three epochs; IoU within 0.010).  The later epochs are not held
tighter because each side trains on from its own weights: Adam's first
steps move every weight by about the learning rate in the direction of
its gradient's sign, so a weight whose gradient is within rounding of 0
moves the other way (test_torch_port_step.py's docstring), and a latent
mask can swap next to its threshold (the loop test's rule), which changes
that step's hard example; at this width one such step moves an epoch's
loss by a percent.  A wrong loss term, scale or update moves it by far
more (the curve falls by 10 % an epoch here).

The same run also restarts the port once from JAX's state at epoch 1's
start (``--restart_each_epoch``, one epoch): JAX's two steps of epoch 1 on
JAX's batches and draws from JAX's weights, so its gap is one epoch's from
a shared start.  Held: every ``loss/...`` term's epoch mean within
``FIRST_RTOL`` of JAX's, epoch 0's rule (both start from the same
weights).  The JAX run is shared by the two tests (a module fixture).
"""

import os
import tempfile

import numpy as np
import pytest
import torch_port_curve as C
from torch_port_util import one_torch_thread  # noqa: F401 - a fixture

CFG = {"name": "curve", "data": {"pad_size": [40, 40, 1], "crop_size": [32, 32, 1]},
       "learning": {"batch_size": 4}}
EPOCHS = 3
FIRST_RTOL = 1e-2
LOSS_RTOL = 5e-2
IOU_ATOL = 0.05
RESTART_EPOCH = 1


@pytest.fixture(scope="module")
def curve(tmp_path_factory):
    out = tmp_path_factory.mktemp("curve") / "curve.jsonl"
    rows = C.curves(40, EPOCHS, CFG, side="both", datasets=C.synthetic(4, 2, (40, 40)),
                    out=str(out), restart_each_epoch=True, restart_epochs=[RESTART_EPOCH])
    return rows, out


def test_port_curve_tracks_jax_at_a_tiny_width(curve):
    rows, out = curve
    assert [r["epoch"] for r in rows] == list(range(EPOCHS))
    assert len(out.read_text().splitlines()) == EPOCHS
    for r in rows:
        p, j = r["port"], r["jax"]
        assert set(p) == set(j) == set(C.KEYS)
        assert np.isfinite(list(p.values())).all()
        rtol = FIRST_RTOL if r["epoch"] == 0 else LOSS_RTOL
        print(f"epoch {r['epoch']}: loss gap {r['gap'] / j['loss/total']:.4%}, IoU gap "
              f"{p['iou/val_iou'] - j['iou/val_iou']:.4f}")
        assert abs(r["gap"]) <= rtol * j["loss/total"], r
        assert abs(p["iou/val_iou"] - j["iou/val_iou"]) <= IOU_ATOL, r
    # the loss falls on both sides
    assert rows[-1]["port"]["loss/total"] < rows[0]["port"]["loss/total"]


def test_port_restarted_from_jax_state_tracks_jax_for_an_epoch(curve):
    rows, _ = curve
    assert [r["epoch"] for r in rows if "restart" in r] == [RESTART_EPOCH]
    r = rows[RESTART_EPOCH]["restart"]
    assert set(r["port"]) == set(r["jax"]) == set(C.STEP_KEYS)
    for k in C.STEP_KEYS:
        print(f"restart at epoch {RESTART_EPOCH}: {k} gap {r['rel_gap'][k]:.4%}")
        assert np.isfinite(r["port"][k]), k
        assert abs(r["gap"][k]) <= FIRST_RTOL * abs(r["jax"][k]) + 1e-6, (k, r)
    # the restarted epoch's JAX side is the logged run's epoch
    logged = rows[RESTART_EPOCH]["jax"]["loss/total"]
    assert abs(r["jax"]["loss/total"] - logged) <= 1e-5 * logged


def test_tpu_log_curve_reads_a_run():
    """The reader of a JAX training log takes the first ``--synthetic`` run
    of a seed (the log of the TPU seed sweep that PERF.md compares with)."""
    lines = ["=== RUN ['--synthetic', '--max_epochs', '3', '--seed', '41'] @ 0\n",
             "default_cv0 network: FCN_16_standard epoch 0 training loss iter: 2, "
             "total loss: 20.5, train_sec: 1\n",
             "=== RUN ['--synthetic', '--max_epochs', '3', '--seed', '40'] @ 0\n",
             "default_cv0 network: FCN_16_standard epoch 0 training loss iter: 2, "
             "total loss: 10.25, train_sec: 1\n",
             "default_cv0 network: FCN_16_standard epoch 1 training loss iter: 2, "
             "total loss: 8.5, train_sec: 1 (window 30)\n",
             "=== RUN ['--json_config_path', 'x', '--synthetic', '--seed', '40'] @ 0\n",
             "default_cv0 network: FCN_16_standard epoch 0 training loss iter: 2, "
             "total loss: 99.0, train_sec: 1\n"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "log")
        with open(path, "w") as f:
            f.writelines(lines)
        assert C.tpu_log_curve(path, 40) == [{"loss/total": 10.25}, {"loss/total": 8.5}]
