"""Checkpoints of the cooperative solver: per-module weights and crash
snapshots.

Counterpart of the persistence methods of the JAX package's
``train/cooperative.py`` (``save_model``, ``load_model``,
``save_snapshots``, ``load_snapshots``; :938-996), in the reference's own
format (advanced...py:107-131,666-738): one ``torch.save``d ``state_dict``
per module under ``{model_dir}/{best|epoch}/checkpoints/{module}.pth``,
and a resumable snapshot under
``{model_dir}/interrupted/checkpoints/{network_type}.pth``.  Tensors are
written from the host and read back to the host (``weights_only=True``),
then copied into the modules, so a checkpoint made on the card loads on
the CPU and back.  Adam's step is written from the host too, and a loaded
snapshot puts it where the loading trainer keeps it: on the host as
``torch.optim`` keeps it by default (a step on the card would be read back
every update), on the parameters' device for a ``capturable`` trainer,
whose graphed step updates it there.
"""

from __future__ import annotations

import os
from os.path import exists, join
from typing import Dict

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.cooperative import (
    CooperativeTrainer,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
    CooperativePredictor,
)


def host_copy(obj):
    """``obj`` with every tensor copied to the host (dicts and lists walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


def module_state_dicts(model: CooperativePredictor) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{module: state_dict}`` of the five subnetworks, on the host."""
    return {name: host_copy(getattr(model, name).state_dict()) for name in MODULE_NAMES}


def save_model(trainer: CooperativeTrainer, model_dir: str, epoch_iter) -> str:
    """Write each module's ``state_dict`` (parameters and BN running
    statistics) to ``{model_dir}/{epoch_iter}/checkpoints/{module}.pth``;
    returns that directory."""
    return save_state_dicts(module_state_dicts(trainer.model), model_dir, epoch_iter)


def save_state_dicts(state_dicts: Dict[str, Dict[str, torch.Tensor]], model_dir: str,
                     epoch_iter) -> str:
    """:func:`save_model` of ``{module: state_dict}`` held apart from a
    trainer (a device copy of an earlier epoch's state, the K-epoch
    window's best buffers), written from the host."""
    path = join(model_dir, str(epoch_iter), "checkpoints")
    os.makedirs(path, exist_ok=True)
    for name in MODULE_NAMES:
        torch.save(host_copy(state_dicts[name]), join(path, f"{name}.pth"))
    return path


def load_model(predictor: CooperativePredictor, checkpoint_dir: str) -> CooperativePredictor:
    """Load the per-module files :func:`save_model` wrote into ``predictor``
    (every module, every key)."""
    predictor.load_state_dicts({
        name: torch.load(join(checkpoint_dir, f"{name}.pth"), map_location="cpu",
                         weights_only=True)
        for name in MODULE_NAMES})
    return predictor


def snapshot_path(model_dir: str, network_type: str) -> str:
    return join(model_dir, "interrupted", "checkpoints", f"{network_type}.pth")


def state_payload(trainer: CooperativeTrainer, epoch: int) -> dict:
    """The trainer's whole state on the host: the network type, the epoch,
    every module's ``state_dict`` and the optimizer's (Adam's moments and
    step)."""
    return {"network_type": trainer.model.network_type, "epoch": int(epoch),
            "modules": module_state_dicts(trainer.model),
            "optimizer": host_copy(trainer.optimizer.state_dict())}


def load_payload(trainer: CooperativeTrainer, payload: dict) -> int:
    """Load a :func:`state_payload` into ``trainer``; returns its epoch."""
    if payload["network_type"] != trainer.model.network_type:
        raise ValueError(f"a state of {payload['network_type']}, a trainer of "
                         f"{trainer.model.network_type}")
    trainer.model.load_state_dicts(payload["modules"])
    trainer.optimizer.load_state_dict(payload["optimizer"])
    trainer.place_optimizer_state()
    return int(payload["epoch"])


def save_snapshot(trainer: CooperativeTrainer, model_dir: str, epoch: int) -> str:
    """The crash/resume snapshot, :func:`state_payload`; returns its path."""
    path = snapshot_path(model_dir, trainer.model.network_type)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state_payload(trainer, epoch), path)
    return path


def load_snapshot(trainer: CooperativeTrainer, path: str) -> int:
    """Load a snapshot into ``trainer``; returns the epoch to start at (the
    snapshot's), or 0 with a warning if ``path`` does not exist, as the JAX
    package's ``load_snapshots`` does."""
    if not exists(path):
        print(f"warning: {path} does not exist")
        return 0
    return load_payload(trainer, torch.load(path, map_location="cpu", weights_only=True))
