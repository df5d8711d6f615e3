"""Scalar logging: a JSONL stream, a JSON export and a TensorBoard mirror.

A copy of the JAX package's ``utils/logging.py:ScalarLogger``, which
replaces the reference's ``SummaryWriter``
(train_adv_supervised_segmentation_triplet.py:120-121,241-255,277-283):
scalars go to ``{log_dir}/scalars.jsonl``, one ``{"step": s, "tag": t,
"value": v}`` a line, and :meth:`ScalarLogger.export_scalars_to_json`
writes them all as the reference's ``export_scalars_to_json`` does.  Every
scalar is also mirrored into a TensorBoard event file in ``log_dir`` by
``torch.utils.tensorboard.SummaryWriter`` (imported here only), which
starts at ``purge_step``: a resumed run's events from that step on replace
those an interrupted run left.  Where the ``tensorboard`` package is not
installed there is no mirror.  (The JAX logger's ``use_tensorboard``
switch is left out: no caller turns the mirror off.)

TensorBoard is told to write through its own TensorFlow stub (its
``no_tensorflow`` switch, the module ``tensorboard.compat.notf``):
writing event files needs no TensorFlow, whose import takes about 15 s
where it is installed.
"""

from __future__ import annotations

import json
import os
import sys
import types
from collections import defaultdict
from os.path import join
from typing import Dict, List, Optional


def _summary_writer():
    """``torch.utils.tensorboard.SummaryWriter``, or None without the
    ``tensorboard`` package."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter


class ScalarLogger:
    """Keeps every scalar in ``history`` ({tag: [(step, value), ...]}) and,
    with a ``log_dir``, appends it to ``{log_dir}/scalars.jsonl`` and to a
    TensorBoard event file there (``event_files`` lists the files it
    opened)."""

    def __init__(self, log_dir: Optional[str], purge_step: Optional[int] = None):
        self.log_dir = log_dir
        self._file = None
        self._tb = None
        self.event_files: List[str] = []
        self.history: Dict[str, list] = defaultdict(list)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(join(log_dir, "scalars.jsonl"), "a")
            writer = _summary_writer()
            if writer is not None:
                before = set(os.listdir(log_dir))
                self._tb = writer(log_dir=log_dir, purge_step=purge_step)
                self.event_files = sorted(join(log_dir, f)
                                          for f in set(os.listdir(log_dir)) - before)

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self.history[tag].append((step, value))
        if self._file:
            self._file.write(json.dumps({"step": step, "tag": tag, "value": value}) + "\n")
            self._file.flush()
        if self._tb:
            self._tb.add_scalar(tag, value, step)

    def export_scalars_to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({tag: vals for tag, vals in self.history.items()}, f)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
        if self._tb:
            self._tb.close()
            self._tb = None
