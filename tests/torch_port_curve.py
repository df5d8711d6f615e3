"""The port's training curve against the JAX package's, from the same
start: a helper run by hand (not collected by pytest: its name does not
start with ``test_``; ``test_torch_port_curve.py`` runs it at a tiny
width).

The port trains on the CPU in float32 through its own ``train_network``
from JAX's initial weights at a seed (``init_state(PRNGKey(seed))``,
through ``convert.train_state_from_jax``), on JAX's draws replayed from
``PRNGKey(seed + 1)`` (``torch_port_util.JaxKeys``, the loop test's draw source), at
the configuration's own learning rate.  With ``--side both`` (or ``jax``) the JAX package's
``train_network`` runs beside it on the CPU (its per-batch path,
``TILED_WARP=0``, float32, or bfloat16 with ``--jax_bf16``) from the same
seed; ``--tpu_log`` reads a JAX run's printed losses instead (the
``saved/batch_trains_r5.log`` format).  Per epoch it prints the total
loss, the eight ``loss/...`` components and the validation Mean IoU of
each side, and the gap, as JSON lines::

    python tests/torch_port_curve.py --seed 40 --epochs 20 --side both --out curve.jsonl

``--restart_each_epoch`` (with ``--side both``) also restarts the port at
every epoch from JAX's state: JAX's ``train_network`` records, through its
solver's ``make_train_step`` and its driver's ``eval_dispatch`` (wrapped,
not edited), the train state at each epoch's first step and every step's
batch, key and metrics; for each epoch k the port loads that state
(``convert.train_state_from_jax``) and trains epoch k's steps on JAX's
batches with JAX's draws replayed from the keys.  Each row then carries
``"restart"``: the epoch's mean of each ``loss/...`` term on both sides
and the port's gap, absolute and relative; so an epoch's gap is that of
one epoch from a shared start, not the sum of the epochs before it::

    python tests/torch_port_curve.py --seed 40 --epochs 10 --restart_each_epoch --out r.jsonl

The full width is the ``--synthetic`` protocol's: batch 20, phantoms
padded to 224 and cropped to 192, 20 training and 10 validation slices
(one epoch is 2 steps and a validation).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import tempfile
from typing import Dict, List, Optional, Sequence

if __name__ == "__main__":  # as tests/conftest.py sets up JAX on the CPU
    _flags = os.environ.get("XLA_FLAGS", "")
    if "space-to-batch-converter" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_disable_hlo_passes=space-to-batch-converter"
                                   ).strip()
    os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]
from torch_port_util import JaxKeys, replay_draws  # noqa: E402

from cooperative_training_and_latent_space_data_augmentation_tpu.config import (  # noqa: E402
    ExperimentConfig as JaxExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.data import (  # noqa: E402
    synthetic as JS,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.train import (  # noqa: E402
    driver as JD,
)
from cooperative_training_and_latent_space_data_augmentation_tpu.train.cooperative import (  # noqa: E402
    CooperativeTripletSolver,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch import (  # noqa: E402
    convert,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.config import (  # noqa: E402
    ExperimentConfig,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.data import (  # noqa: E402
    synthetic as S,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train import (  # noqa: E402
    driver as D,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (  # noqa: E402
    CooperativeTrainer,
)

KEYS = ("loss/total",) + D.LOSS_KEYS[1:5] + D.LOSS_KEYS[6:] + ("iou/val_iou",)
# the step's loss terms, as JAX's step returns them
STEP_KEYS = D.LOSS_KEYS + ("loss/total",)


def _scalars(log_dir: str) -> List[Dict[str, float]]:
    """Per epoch {tag: value} from a ``scalars.jsonl``, with ``loss/total``
    the sum of the standard and hard totals."""
    by_epoch: Dict[int, Dict[str, float]] = {}
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            by_epoch.setdefault(r["step"], {})[r["tag"]] = r["value"]
    out = []
    for e in sorted(by_epoch):
        row = by_epoch[e]
        row["loss/total"] = row["loss/standard/total"] + row["loss/hard/total"]
        out.append(row)
    return out


def tpu_log_curve(path: str, seed: int) -> List[Dict[str, float]]:
    """The printed per-epoch total losses of the first ``--synthetic`` run
    of ``seed`` in a JAX training log."""
    out, inside = [], False
    for line in open(path, errors="replace"):
        if line.startswith("=== RUN"):
            if inside:
                break
            inside = ("'--synthetic'" in line and f"'--seed', '{seed}'" in line
                      and "--json_config_path" not in line)
            continue
        m = re.search(r"epoch (\d+) training loss iter: \d+, total loss: ([0-9.eE+-]+)", line)
        if inside and m and int(m.group(1)) == len(out):
            out.append({"loss/total": float(m.group(2))})
    return out


def run_port(seed: int, epochs: int, cfg_dict: Optional[dict], work: str,
             datasets) -> List[Dict[str, float]]:
    cfg = ExperimentConfig.from_dict(cfg_dict or {})
    hw = tuple(cfg.data.crop_hw)
    solver = CooperativeTripletSolver(input_hw=hw, learning_rate=cfg.learning.lr)
    state = solver.init_state(jax.random.PRNGKey(seed))
    trainer = CooperativeTrainer(cfg.latent_DA if cfg.learning.latent_DA else None,
                                 input_noise_std=cfg.learning.input_noise_std,
                                 learning_rate=cfg.learning.lr, device="cpu")
    trainer.load_train_state(convert.train_state_from_jax(
        jax.device_get(state.params), jax.device_get(state.batch_stats),
        jax.device_get(state.opt_state)))
    train_set, val_set = datasets(S)
    D.train_network("curve", train_set, val_set, trainer, cfg, os.path.join(work, "model"),
                    log_dir=os.path.join(work, "log"), log=True, seed=seed, max_epochs=epochs,
                    draws=JaxKeys(seed))
    return _scalars(os.path.join(work, "log"))


class JaxRecorder:
    """What JAX's ``train_network`` did, by wrapping its solver's
    ``make_train_step`` and its driver's ``eval_dispatch`` (each epoch's
    validation): ``epochs[k]`` holds epoch k's ``"start"`` (the train
    state its first step began from, on the host) and its ``"steps"``
    ({"batch", "key", "metrics"}, on the host)."""

    def __init__(self, solver: CooperativeTripletSolver):
        self.epochs: List[Dict[str, object]] = []
        self._new_epoch = True
        make = solver.make_train_step

        def make_train_step(*args, **kw):
            step = make(*args, **kw)

            def recording(state, batch, key):
                if self._new_epoch:
                    self.epochs.append({"start": jax.device_get(state), "steps": []})
                    self._new_epoch = False
                new, metrics = step(state, batch, key)
                self.epochs[-1]["steps"].append({
                    "batch": jax.device_get(batch), "key": jax.device_get(key),
                    "metrics": {k: float(v) for k, v in jax.device_get(metrics).items()}})
                return new, metrics

            return recording

        solver.make_train_step = make_train_step

    def wrap_eval(self, eval_dispatch):
        def marking(*args, **kw):
            self._new_epoch = True
            return eval_dispatch(*args, **kw)

        return marking


def run_jax(seed: int, epochs: int, cfg_dict: Optional[dict], work: str, datasets,
            bf16: bool = False, recorder: Optional[list] = None) -> List[Dict[str, float]]:
    """JAX's ``train_network``'s per-epoch scalars; with ``recorder`` (a
    list) a :class:`JaxRecorder` of the run is appended to it."""
    import jax.numpy as jnp

    cfg = JaxExperimentConfig.from_dict(cfg_dict or {})
    solver = CooperativeTripletSolver(input_hw=tuple(cfg.data.crop_hw),
                                      learning_rate=cfg.learning.lr,
                                      compute_dtype=jnp.bfloat16 if bf16 else None)
    env = {"TILED_WARP": "0", "FUSED_EPOCH": "0"}
    saved = {k: os.environ.get(k) for k in (*env, "PIPELINE_EPOCH", "MULTI_EPOCH")}
    save_images = JD.save_testing_images_results
    eval_dispatch = JD.eval_dispatch
    try:
        os.environ.update(env)
        os.environ.pop("PIPELINE_EPOCH", None)
        os.environ.pop("MULTI_EPOCH", None)
        JD.save_testing_images_results = lambda *a, **k: None
        if recorder is not None:
            recorder.append(JaxRecorder(solver))
            JD.eval_dispatch = recorder[-1].wrap_eval(eval_dispatch)
        train_set, val_set = datasets(JS)
        JD.train_network("curve", train_set, val_set, solver, cfg, os.path.join(work, "model"),
                         log_dir=os.path.join(work, "log"), log=True, seed=seed,
                         max_epochs=epochs, use_orbax=False)
    finally:
        JD.save_testing_images_results = save_images
        JD.eval_dispatch = eval_dispatch
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return _scalars(os.path.join(work, "log"))


def restart_port(recording: JaxRecorder, cfg_dict: Optional[dict],
                 epochs: Optional[Sequence[int]] = None) -> List[Dict[str, object]]:
    """For each epoch k recorded (or each of ``epochs``): the port from
    JAX's state at epoch k's start trains epoch k's steps on JAX's batches
    and replayed draws.  One row per epoch: {"epoch", "port", "jax" (each
    the epoch's mean of every term of :data:`STEP_KEYS`), "gap" (port -
    JAX), "rel_gap" (gap / |JAX|)}."""
    cfg = ExperimentConfig.from_dict(cfg_dict or {})
    lda = cfg.latent_DA if cfg.learning.latent_DA else None
    rows = []
    for k in range(len(recording.epochs)) if epochs is None else epochs:
        rec = recording.epochs[k]
        st = rec["start"]
        trainer = CooperativeTrainer(lda, input_noise_std=cfg.learning.input_noise_std,
                                     learning_rate=cfg.learning.lr, device="cpu")
        trainer.load_train_state(convert.train_state_from_jax(st.params, st.batch_stats,
                                                              st.opt_state))
        port = {key: 0.0 for key in STEP_KEYS}
        ref = {key: 0.0 for key in STEP_KEYS}
        for step in rec["steps"]:
            image, label = step["batch"]["image"], step["batch"]["label"]
            draws = replay_draws(step["key"], lda, image.shape[0], image.shape[1:3])
            got = trainer.train_step(torch.from_numpy(np.array(image)),
                                     torch.from_numpy(np.array(label)), draws)
            for key in STEP_KEYS:
                port[key] += float(got[key]) / len(rec["steps"])
                ref[key] += step["metrics"][key] / len(rec["steps"])
        gap = {key: port[key] - ref[key] for key in STEP_KEYS}
        rows.append({"epoch": k, "port": port, "jax": ref, "gap": gap,
                     "rel_gap": {key: gap[key] / abs(ref[key]) if ref[key] else 0.0
                                 for key in STEP_KEYS}})
    return rows


def synthetic(n_train: int = 20, n_val: int = 10, pad_hw=(224, 224)):
    """The ``--synthetic`` protocol's datasets, from module ``mod`` (the
    port's or the JAX package's ``data/synthetic.py``)."""
    return lambda mod: (mod.SyntheticSegDataset(length=n_train, pad_size=pad_hw, seed=0),
                        mod.SyntheticSegDataset(length=n_val, pad_size=pad_hw, seed=1))


def curves(seed: int, epochs: int, cfg_dict: Optional[dict] = None, side: str = "both",
           jax_bf16: bool = False, datasets=None, out: Optional[str] = None,
           tpu_log: Optional[str] = None, restart_each_epoch: bool = False,
           restart_epochs: Optional[Sequence[int]] = None) -> List[Dict[str, object]]:
    """Run the port (``side`` "port" or "both") and JAX ("jax" or "both";
    else the TPU log's losses, if given); one row per epoch: {"epoch",
    "port": {...} or None, "jax": {...} or None, "gap": port total - JAX
    total, or None}, appended to ``out`` as JSON lines.  With
    ``restart_each_epoch`` (JAX's run needed) each row also has "restart",
    the row of :func:`restart_port` for that epoch (every epoch, or those
    of ``restart_epochs``)."""
    datasets = datasets or synthetic()
    if restart_each_epoch and side == "port":
        raise ValueError("--restart_each_epoch restarts from JAX's states: run JAX too")
    recorder: Optional[list] = [] if restart_each_epoch else None
    with tempfile.TemporaryDirectory() as work:
        port = (run_port(seed, epochs, cfg_dict, os.path.join(work, "port"), datasets)
                if side in ("port", "both") else [])
        ref = (run_jax(seed, epochs, cfg_dict, os.path.join(work, "jax"), datasets, jax_bf16,
                       recorder)
               if side in ("jax", "both") else tpu_log_curve(tpu_log, seed)[:epochs]
               if tpu_log else [])
    restarts = {}
    if recorder:
        restarts = {r["epoch"]: r for r in restart_port(recorder[0], cfg_dict, restart_epochs)}
    rows = []
    for e in range(max(len(port), len(ref))):
        p = {k: port[e][k] for k in KEYS if k in port[e]} if e < len(port) else None
        j = {k: ref[e][k] for k in KEYS if k in ref[e]} if e < len(ref) else None
        gap = p["loss/total"] - j["loss/total"] if p and j else None
        rows.append({"epoch": e, "port": p, "jax": j, "gap": gap})
        if e in restarts:
            rows[-1]["restart"] = restarts[e]
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(rows[-1]) + "\n")
    return rows


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser("the port's training curve against JAX's")
    p.add_argument("--seed", type=int, default=40)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--side", choices=("port", "jax", "both"), default="both")
    p.add_argument("--jax_bf16", action="store_true")
    p.add_argument("--tpu_log", type=str, default=None)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--restart_each_epoch", action="store_true",
                   help="also restart the port at each epoch from JAX's state on JAX's batches")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    for row in curves(args.seed, args.epochs, side=args.side, jax_bf16=args.jax_bf16,
                      out=args.out, tpu_log=args.tpu_log,
                      restart_each_epoch=args.restart_each_epoch):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
