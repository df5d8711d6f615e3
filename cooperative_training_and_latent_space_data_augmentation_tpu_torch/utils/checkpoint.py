"""Whole-state checkpoints of the cooperative trainer, for resuming.

Counterpart of the JAX package's ``utils/checkpoint.py``
(``save_checkpoint``, ``restore_checkpoint``, ``latest_step``), which
writes orbax checkpoints of the whole train state beside the per-module
files.  This is not orbax's format: one ``torch.save`` file a step,
``{directory}/{step}/train_state.pth``, the trainer's
``train/checkpoint.py:state_payload`` (the network type, the five
modules' parameters and BatchNorm running statistics, Adam's moments and
step count, and the epoch, which the driver makes the step).  Like the
snapshots it holds no position of the draw source or of the batch order:
a resumed run draws from its seed anew, as the JAX package's does.  A
state of the JAX package still arrives through
``convert.load_jax_checkpoint`` and ``convert.train_state_from_jax``.

Tensors are written from the host and read back with
``map_location="cpu"``, then copied into the trainer's modules, so a
checkpoint loads into any topology: one written by rank 0 of a
data-parallel run (whose state every rank holds alike) into one process,
and the reverse.  A file is written under a temporary name and renamed,
so a step directory that :func:`latest_step` sees is complete.
``max_to_keep`` keeps the newest steps, as orbax's manager does.
"""

from __future__ import annotations

import os
import shutil
from os.path import isfile, join
from typing import List, Optional

import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
    load_payload,
    state_payload,
)

STATE_FILE = "train_state.pth"


def all_steps(directory: str) -> List[int]:
    """The steps with a complete checkpoint under ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and isfile(join(directory, d, STATE_FILE)))


def save_checkpoint(directory: str, state, step: int, max_to_keep: Optional[int] = 3) -> str:
    """Save the whole state of ``state`` (a ``CooperativeTrainer``) at
    ``step`` under ``directory``, then remove all but the newest
    ``max_to_keep`` steps (None keeps all); returns the file's path."""
    step_dir = join(directory, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = join(step_dir, STATE_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(state_payload(state, step), tmp)
    os.replace(tmp, path)
    if max_to_keep is not None:
        for old in all_steps(directory)[:-max_to_keep]:
            shutil.rmtree(join(directory, str(old)))
    return path


def restore_checkpoint(directory: str, target, step: Optional[int] = None):
    """Load the checkpoint of ``step`` (None: the latest) under
    ``directory`` into ``target`` (a ``CooperativeTrainer`` of the same
    network type, on any device) and return it; ``FileNotFoundError`` if
    there is none."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = join(directory, str(int(step)), STATE_FILE)
    if not isfile(path):
        raise FileNotFoundError(f"no checkpoint of step {step} under {directory}")
    load_payload(target, torch.load(path, map_location="cpu", weights_only=True))
    return target


def latest_step(directory: str) -> Optional[int]:
    """The newest step under ``directory``, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None
