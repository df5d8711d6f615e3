"""Serving export: a trained predictor frozen into one archive file.

Counterpart of the JAX package's ``utils/serving.py``.  The JAX package
exports ``solver.predict`` with the parameters baked in as a StableHLO
blob that runs without the model code on any PJRT backend.  The port's
predict runs hand-written kernels through ctypes calls, which
``torch.export`` cannot trace, and no StableHLO or PJRT counterpart
exists, so the port's artifact is data, not a program: one versioned
``torch.save`` archive (a ``dict`` of tensors, strings, numbers and
booleans, read back with ``weights_only=True``) holding

* ``state_dicts``: the five subnetworks' state dicts, BatchNorm running
  statistics included (:func:`..train.checkpoint.module_state_dicts`);
* ``network_type``, ``image_ch``, ``num_classes``, ``temperature`` and
  ``widths`` (the FCN_16 plan's channels: the plan is fixed, and an
  archive whose widths differ from it is refused on load);
* ``conv_s2``, ``conv_nl`` and ``compute_dtype`` (``"float32"`` or
  ``"bfloat16"``): the configuration the predictor ran in;
* ``n_iter`` and ``softmax``: what the served function computes;
* ``input_hw``: the slice size it was exported for; the served function
  takes any batch size at that size and refuses another, as the JAX
  artifact, exported for one size with a symbolic batch, does.

Serving it needs this package: :func:`load_predictor` rebuilds
``train/predictor.py:CooperativePredictor`` on the card (or on the CPU
when asked), loads the state dicts strictly and returns
``fn(images_nhwc) -> probs or logits`` for any batch size, the JAX
artifact's contract: (B, H, W, image_ch) float32 in [0, 1] in, at the
exported (H, W), and (B, H, W, num_classes) float32 out, on the loading
device.  The kernels are built
from the package's sources at the first call, as for any predict.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.checkpoint import (
    module_state_dicts,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    CooperativePredictor,
)

FORMAT = "cooperative_predictor"
VERSION = 1
MAGIC_SUFFIX = ".pt"
WIDTHS = (16, 32, 64, 128, 128)  # FCN_16: the encoder stages' channels
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def export_predictor(predictor: CooperativePredictor, path: str,
                     input_hw: Tuple[int, int] = (192, 192), image_ch: int = 1,
                     n_iter: Optional[int] = None, softmax: bool = True) -> str:
    """Write ``predictor``'s archive to ``path`` (``.pt`` appended when the
    path has no extension) and return the path written.  ``n_iter``: FTN
    prediction plus ``n_iter - 1`` STN refinements (default the
    predictor's); ``softmax``: probabilities, else logits."""
    if image_ch != predictor.image_ch:
        raise ValueError(f"export_predictor: image_ch {image_ch}, the predictor takes "
                         f"{predictor.image_ch}")
    dtype = {v: k for k, v in DTYPES.items()}.get(predictor.compute_dtype)
    if dtype is None and predictor.compute_dtype is not None:
        raise ValueError(f"export_predictor: compute dtype {predictor.compute_dtype}")
    archive = {
        "format": FORMAT, "version": VERSION,
        "state_dicts": module_state_dicts(predictor),
        "network_type": predictor.network_type, "image_ch": predictor.image_ch,
        "num_classes": predictor.num_classes, "temperature": float(predictor.temperature),
        "widths": list(WIDTHS),
        "conv_s2": bool(predictor.conv_s2), "conv_nl": bool(predictor.conv_nl),
        "compute_dtype": dtype or "float32",
        "n_iter": int(predictor.n_iter if n_iter is None else n_iter),
        "softmax": bool(softmax), "input_hw": [int(v) for v in input_hw],
    }
    if not os.path.splitext(path)[1]:
        path = path + MAGIC_SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(archive, path)
    return path


def read_archive(path: str) -> dict:
    """The archive's dict, its format and version checked."""
    archive = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(archive, dict) or archive.get("format") != FORMAT:
        raise ValueError(f"{path}: not a {FORMAT} archive")
    if archive.get("version") != VERSION:
        raise ValueError(f"{path}: archive version {archive.get('version')}, this package "
                         f"reads {VERSION}")
    if list(archive.get("widths", ())) != list(WIDTHS):
        raise ValueError(f"{path}: archive widths {archive.get('widths')}, this package "
                         f"builds {list(WIDTHS)}")
    return archive


def build_predictor(archive: dict, device: Union[str, torch.device] = "cuda"
                    ) -> CooperativePredictor:
    """The archive's predictor on ``device``, its state dicts loaded."""
    predictor = CooperativePredictor(
        image_ch=archive["image_ch"], num_classes=archive["num_classes"],
        n_iter=archive["n_iter"], temperature=archive["temperature"],
        compute_dtype=DTYPES[archive["compute_dtype"]], device=device,
        conv_s2=archive["conv_s2"], conv_nl=archive["conv_nl"],
        network_type=archive["network_type"])
    predictor.load_state_dicts(archive["state_dicts"])
    return predictor


def load_predictor(path: str, device: Union[str, torch.device] = "cuda"
                   ) -> Callable[[Union[torch.Tensor, np.ndarray]], torch.Tensor]:
    """Load an archive: ``fn(images_nhwc) -> probs or logits`` on ``device``
    at the exported slice size
    (``"cuda"`` unless the caller asks for ``"cpu"``; without a card that is
    an error, never a quiet CPU run).  ``fn.predictor`` is the rebuilt
    :class:`CooperativePredictor`."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_predictor: device {device} but no CUDA device; pass "
                           f"device='cpu' to serve on the CPU")
    archive = read_archive(path)
    predictor = build_predictor(archive, device)
    n_iter, softmax = archive["n_iter"], archive["softmax"]
    shape = (*archive["input_hw"], archive["image_ch"])
    param = next(predictor.parameters())

    def fn(images):
        x = torch.as_tensor(images, dtype=torch.float32).to(param.device)
        if tuple(x.shape[1:]) != shape:
            raise ValueError(f"served predictor: input {tuple(x.shape)}, exported for "
                             f"(B, {', '.join(map(str, shape))})")
        return predictor.predict(x, n_iter=n_iter, softmax=softmax)

    fn.predictor = predictor
    return fn
