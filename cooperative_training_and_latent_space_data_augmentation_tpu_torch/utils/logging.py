"""Scalar logging: a JSONL stream and a JSON export.

A copy of the JAX package's ``utils/logging.py:ScalarLogger``, which
replaces the reference's ``SummaryWriter``
(train_adv_supervised_segmentation_triplet.py:120-121,241-255,277-283):
scalars go to ``{log_dir}/scalars.jsonl``, one ``{"step": s, "tag": t,
"value": v}`` a line, and :meth:`ScalarLogger.export_scalars_to_json`
writes them all as the reference's ``export_scalars_to_json`` does.  The
JAX package's TensorBoard mirror is left out.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from os.path import join
from typing import Dict, Optional


class ScalarLogger:
    """Keeps every scalar in ``history`` ({tag: [(step, value), ...]}) and,
    with a ``log_dir``, appends it to ``{log_dir}/scalars.jsonl``."""

    def __init__(self, log_dir: Optional[str]):
        self.log_dir = log_dir
        self._file = None
        self.history: Dict[str, list] = defaultdict(list)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int) -> None:
        value = float(value)
        self.history[tag].append((step, value))
        if self._file:
            self._file.write(json.dumps({"step": step, "tag": tag, "value": value}) + "\n")
            self._file.flush()

    def export_scalars_to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({tag: vals for tag, vals in self.history.items()}, f)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
