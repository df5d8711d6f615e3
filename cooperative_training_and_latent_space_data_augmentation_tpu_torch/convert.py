"""Weights of the JAX solver -> state dicts of the port's modules.

``from_jax(params, batch_stats)`` takes the JAX ``CooperativeTripletSolver``'s
``params`` and ``batch_stats`` as nested dicts of arrays keyed by the flax
auto-names (``ConvBlock_0/Conv_0/kernel``, ``BatchNorm_0/scale``, ...
``mean``/``var``) and returns ``{module_name: state_dict}`` for
:meth:`..train.predictor.CooperativePredictor.load_state_dicts`.

It maps HWIO conv kernels to OIHW, flax's k2s2 ``ConvTranspose`` kernel to
``nn.ConvTranspose2d``'s (C_in, C_out, 2, 2) with the spatial flip (flax
cross-correlates the dilated input, PyTorch convolves it), and BN
scale/bias/mean/var to weight/bias/running_mean/running_var.  It needs
numpy only (no JAX): arrays are read with ``np.asarray``.

``train_state_from_jax(params, batch_stats, opt_state)`` adds the optax
Adam state: its first and second moments ``mu`` and ``nu`` have the
params' tree and go through the same maps, and its ``count`` is the step.
:meth:`..train.cooperative.CooperativeTrainer.load_train_state` loads the
result, so a JAX run can be resumed in the port.

``load_jax_checkpoint(dir)`` reads the per-module ``{module}.msgpack``
files the JAX solver's ``save_model`` writes (``train/cooperative.py:
954-966``) into what ``from_jax`` returns, through
:func:`read_flax_msgpack`, a msgpack decoder on ``struct`` (no ``msgpack``
package, which the card's machine may lack).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from os.path import join
from typing import Any, Dict, Mapping

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.predictor import (
    MODULE_NAMES,
)

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _conv(p: Mapping) -> StateDict:
    """flax Conv {kernel HWIO, bias} -> {weight OIHW, bias}."""
    return {"weight": _t(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))),
            "bias": _t(p["bias"])}


def _conv_transpose(p: Mapping) -> StateDict:
    """flax ConvTranspose kernel[h, w, i, o] = torch weight[i, o, kH-1-h, kW-1-w]."""
    k = np.asarray(p["kernel"])[::-1, ::-1]
    return {"weight": _t(np.transpose(k, (2, 3, 0, 1))), "bias": _t(p["bias"])}


def _bn(p: Mapping, s: Mapping) -> StateDict:
    return {"weight": _t(p["scale"]), "bias": _t(p["bias"]),
            "running_mean": _t(s["mean"]), "running_var": _t(s["var"])}


def _put(out: StateDict, prefix: str, sd: StateDict) -> None:
    for k, v in sd.items():
        out[f"{prefix}.{k}"] = v


def _conv_bn_stack(out: StateDict, prefix: str, p: Mapping, s: Mapping,
                   convs=("Conv_0", "Conv_1")) -> None:
    """flax conv3-BN-LReLU-conv3-BN -> Sequential indices 0, 1, 3, 4."""
    _put(out, f"{prefix}.0", _conv(p[convs[0]]))
    _put(out, f"{prefix}.1", _bn(p["BatchNorm_0"], s["BatchNorm_0"]))
    _put(out, f"{prefix}.3", _conv(p[convs[1]]))
    _put(out, f"{prefix}.4", _bn(p["BatchNorm_1"], s["BatchNorm_1"]))


def _res_core(out: StateDict, prefix: str, p: Mapping, s: Mapping) -> None:
    """flax _ResCore: Conv_0 is the 1x1 shortcut, Conv_1/Conv_2 the branch."""
    _put(out, f"{prefix}.conv_input", _conv(p["Conv_0"]))
    _conv_bn_stack(out, f"{prefix}.conv", p, s, convs=("Conv_1", "Conv_2"))


def encoder(p: Mapping, s: Mapping, prefix: str = "") -> StateDict:
    """flax Encoder -> port Encoder state dict."""
    out: StateDict = {}
    _conv_bn_stack(out, f"{prefix}inc", p["ConvBlock_0"], s["ConvBlock_0"])
    for i in range(4):
        pd, sd = p[f"ResConvDown_{i}"], s[f"ResConvDown_{i}"]
        _put(out, f"{prefix}down{i + 1}.down", _conv(pd["Conv_0"]))
        _res_core(out, f"{prefix}down{i + 1}", pd["_ResCore_0"], sd["_ResCore_0"])
    _put(out, f"{prefix}final_conv.0", _conv(p["Conv_0"]))
    _put(out, f"{prefix}final_conv.1", _bn(p["BatchNorm_0"], s["BatchNorm_0"]))
    return out


def decoder(p: Mapping, s: Mapping) -> StateDict:
    """flax Decoder -> port Decoder state dict."""
    out: StateDict = {}
    for i in range(4):
        pu, su = p[f"ResUp_{i}"], s[f"ResUp_{i}"]
        if "ConvTranspose_0" in pu:
            _put(out, f"up{i + 1}.up", _conv_transpose(pu["ConvTranspose_0"]))
        _res_core(out, f"up{i + 1}", pu["_ResCore_0"], su["_ResCore_0"])
    _put(out, "final_conv", _conv(p["Conv_0"]))
    return out


def dual_branch_encoder(p: Mapping, s: Mapping) -> StateDict:
    """flax DualBranchEncoder -> port DualBranchEncoder state dict."""
    out = encoder(p["general_encoder"], s["general_encoder"], "general_encoder.")
    _conv_bn_stack(out, "code_decoupler", p["code_decoupler"], s["code_decoupler"])
    return out


def from_jax(params: Mapping, batch_stats: Mapping) -> Dict[str, StateDict]:
    """The JAX solver's ``params``/``batch_stats`` -> ``{module: state_dict}``."""
    return {
        "image_encoder": dual_branch_encoder(params["image_encoder"],
                                             batch_stats["image_encoder"]),
        "segmentation_decoder": decoder(params["segmentation_decoder"],
                                        batch_stats["segmentation_decoder"]),
        "shape_encoder": encoder(params["shape_encoder"], batch_stats["shape_encoder"]),
        "shape_decoder": decoder(params["shape_decoder"], batch_stats["shape_decoder"]),
        "image_decoder": decoder(params["image_decoder"], batch_stats["image_decoder"]),
    }


@dataclass
class TrainState:
    """A JAX train state in the port's terms: ``state_dicts`` as
    :func:`from_jax` gives them; Adam's moments ``exp_avg`` (optax ``mu``)
    and ``exp_avg_sq`` (``nu``) as ``{module: {parameter name: tensor}}``;
    ``step``, the number of Adam steps taken (optax ``count``)."""

    state_dicts: Dict[str, StateDict]
    exp_avg: Dict[str, StateDict]
    exp_avg_sq: Dict[str, StateDict]
    step: int


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) of an optax adam state,
    found by its fields (the port does not import optax)."""
    if hasattr(opt_state, "mu"):
        return opt_state
    for part in opt_state:
        if hasattr(part, "mu"):
            return part
    raise ValueError("train_state_from_jax: no Adam state (count, mu, nu) in opt_state")


def train_state_from_jax(params: Mapping, batch_stats: Mapping, opt_state) -> TrainState:
    """The JAX solver's ``TrainState`` fields -> :class:`TrainState`."""
    adam = _adam_state(opt_state)

    def moments(tree) -> Dict[str, StateDict]:
        full = from_jax(tree, batch_stats)
        return {m: {k: v for k, v in sd.items()
                    if not k.rsplit(".", 1)[-1].startswith("running_")}
                for m, sd in full.items()}

    return TrainState(from_jax(params, batch_stats), moments(adam.mu), moments(adam.nu),
                      int(np.asarray(adam.count)))


# ------------------------------------------------------ flax msgpack files
# msgpack's fixed-width types: first byte -> (struct format, byte count)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
          0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
          0xd2: (">i", 4), 0xd3: (">q", 8)}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}  # a length field of n bytes
# first byte -> (kind, bytes of its length field) for str, bin, array, map, ext
_SIZED = {0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4), 0xde: ("map", 2), 0xdf: ("map", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_FLAX_NDARRAY = 1  # flax.serialization._MsgpackExtType.ndarray


class _Reader:
    """A cursor over one msgpack buffer."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (needs {n} more)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        b = self.unpack(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_LENGTH[width], width)
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte {self.pos - 1}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = self.unpack(">b", 1)
        data = bytes(self.take(n))
        if code != _FLAX_NDARRAY:
            raise ValueError(f"msgpack: ext type {code} is not flax's ndarray (1)")
        # flax packs (shape, dtype name, C-order bytes)
        shape, dtype, raw = _Reader(data).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)


def read_flax_msgpack(path: str) -> Any:
    """The tree a flax ``serialization.to_bytes`` file holds, as
    ``flax.serialization.msgpack_restore`` returns it: maps as dicts,
    arrays as lists, flax's ndarray extension (type 1) as numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: {len(reader.buf) - reader.pos} bytes after the tree")
    return tree


def load_jax_checkpoint(checkpoint_dir: str) -> Dict[str, StateDict]:
    """A JAX checkpoint directory (``.../model/best/checkpoints``: one
    ``{module}.msgpack`` of ``{"params": ..., "batch_stats": ...}`` a
    module) -> ``{module: state_dict}`` for
    :meth:`..train.predictor.CooperativePredictor.load_state_dicts`."""
    params, stats = {}, {}
    for name in MODULE_NAMES:
        tree = read_flax_msgpack(join(checkpoint_dir, f"{name}.msgpack"))
        params[name], stats[name] = tree["params"], tree["batch_stats"]
    return from_jax(params, stats)
