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

``baseline_from_jax(network, params, batch_stats)`` does the same for a
baseline network of the JAX package's ``train/segmentation.py`` (a registry
name or a port module: the UNets, the FCN, their layers, ``UNet3D`` and
``DomainSpecificEncoder``), through one table of (port key, flax
collection and path, transform) entries (:func:`baseline_entries`);
``baseline_train_state_from_jax`` adds the ``{"online", "ema"}`` split,
optax's Adam state and the Adam-bound clip's state.  Transposed kernels of
any size are flipped on every spatial axis (flax does not flip, PyTorch
does).

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
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

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


def _find_state(opt_state, test):
    """The first node of an optax state (nested tuples) that ``test`` accepts."""
    if test(opt_state):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _find_state(part, test)
            if found is not None:
                return found
    return None


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) of an optax adam state,
    found by its fields (the port does not import optax)."""
    adam = _find_state(opt_state, lambda s: hasattr(s, "mu") and hasattr(s, "nu"))
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    return adam


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


# ------------------------------------------------------- baseline networks
# one entry: (port state-dict key, flax collection, flax path, transform)
Entry = Tuple[str, str, Tuple[str, ...], str]


def kernel_to_torch(k: np.ndarray, kind: str) -> np.ndarray:
    """flax kernel -> PyTorch weight: ``conv`` (*k, I, O) -> (O, I, *k);
    ``convT`` (*k, I, O) flipped on every spatial axis -> (I, O, *k);
    ``dense`` (I, O) -> (O, I); ``copy`` as it is."""
    if kind == "copy":
        return k
    n = k.ndim
    if kind == "convT":
        k = k[(slice(None, None, -1),) * (n - 2)]
        return np.transpose(k, (n - 2, n - 1) + tuple(range(n - 2)))
    return np.transpose(k, (n - 1, n - 2) + tuple(range(n - 2)))


def _baseline_children(m: nn.Module) -> List[Tuple[str, Tuple[str, ...]]]:
    """(port submodule path, flax path) of ``m``'s children."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import (
        encoder_decoder as ed,
        layers as ly,
        unet,
        unet3d,
    )

    def norm(i):
        return ("Norm_%d" % i, "BatchNorm_0")

    if isinstance(m, unet.DoubleConv):
        return [("conv1", ("SNConv_0",)), ("norm1", norm(0)), ("conv2", ("SNConv_1",)),
                ("norm2", norm(1))]
    if isinstance(m, unet.ResBlock):
        return [("shortcut", ("SNConv_0",)), ("conv1", ("SNConv_1",)), ("norm1", norm(0)),
                ("conv2", ("SNConv_2",)), ("norm2", norm(1))]
    if isinstance(m, unet.ConvBNRelu):
        return [("conv", ("Conv_0",)), ("bn", ("BatchNorm_0",))]
    stages = ["inc"] + [f"down{i}" for i in range(1, 5)] + [f"up{i}" for i in range(1, 5)]
    if isinstance(m, unet.DeeplySupervisedUNet):
        return ([(n, ("DoubleConv_%d" % i,)) for i, n in enumerate(stages)]
                + [("dsv2", ("Conv_0",)), ("dsv3", ("Conv_1",)), ("outc", ("Conv_2",))])
    if isinstance(m, unet.UNet):
        return [(n, ("DoubleConv_%d" % i,)) for i, n in enumerate(stages)] + [("outc", ("Conv_0",))]
    if isinstance(m, unet.ResConvUNet):
        return ([(n, ("ResBlock_%d" % i,)) for i, n in enumerate(stages)]
                + [(f"deconv{i + 1}", ("ConvTranspose_%d" % i,)) for i in range(4)]
                + [("outc", ("Conv_0",))])
    if isinstance(m, unet.FCN):
        n_trunk = len(m.trunk)
        return ([(f"trunk.{i}", ("ConvBNRelu_%d" % i,)) for i in range(n_trunk)]
                + [(f"lateral.{i}", ("ConvBNRelu_%d" % (n_trunk + i),)) for i in range(5)]
                + [(f"fuse.{i}", ("ConvBNRelu_%d" % (n_trunk + 5 + i),)) for i in range(2)]
                + [("outc", ("Conv_0",))])
    if isinstance(m, unet3d.UnetConv3):
        return [("conv1", ("Conv_0",)), ("bn1", ("BatchNorm_0",)), ("conv2", ("Conv_1",)),
                ("bn2", ("BatchNorm_1",))]
    if isinstance(m, unet3d.UnetUp3):
        return ([("up", ("ConvTranspose_0",))] if m.is_deconv else []) + [
            ("conv", ("UnetConv3_0",))]
    if isinstance(m, unet3d.UNet3D):
        return [("conv%d" % (i + 1), ("UnetConv3_%d" % i,)) for i in range(3)] + [
            ("up1", ("UnetUp3_0",)), ("up2", ("UnetUp3_1",)), ("outc", ("Conv_0",))]
    if isinstance(m, ed.DomainSpecificEncoder):
        out = [("conv1", ("Conv_0",)), ("norm_1", ("norm_1",)), ("conv2", ("Conv_1",)),
               ("norm_2", ("norm_2",))]
        for i in range(1, 5):
            c = 2 + 4 * (i - 1)
            out += [(f"down{i}.down", ("Conv_%d" % c,)),
                    (f"down{i}.conv_input", ("Conv_%d" % (c + 1),)),
                    (f"down{i}.conv1", ("Conv_%d" % (c + 2),)),
                    (f"down{i}.norm_1", (f"down{i}_norm_1",)),
                    (f"down{i}.conv2", ("Conv_%d" % (c + 3),)),
                    (f"down{i}.norm_2", (f"down{i}_norm_2",))]
        return out + [("final_conv", ("Conv_18",)), ("final_norm", ("final_norm",))]
    if isinstance(m, ly.DomainSpecificBatchNorm):
        return [(f"banks.{d}", ("bn_%d" % d,)) for d in range(len(m.banks))]
    if isinstance(m, ly.BatchInstanceNorm):
        return [("bn", ("BatchNorm_0",))]
    if isinstance(m, ly.ChannelSELayer):
        return [("fc1", ("Dense_0",)), ("fc2", ("Dense_1",))]
    if isinstance(m, ly.SpatialSELayer):
        return [("conv", ("Conv_0",))]
    if isinstance(m, ly.ChannelSpatialSELayer):
        return [("cse", ("ChannelSELayer_0",)), ("sse", ("SpatialSELayer_0",))]
    if isinstance(m, ly.SelfAttention):
        return [("query", ("Conv_0",)), ("key", ("Conv_1",)), ("value", ("Conv_2",))]
    return []


def baseline_entries(module: nn.Module) -> List[Entry]:
    """Every state-dict key of a baseline ``module`` with the flax
    collection and path it comes from and the transform on the way."""
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models import (
        blocks,
        layers as ly,
        unet3d,
    )
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
        Conv,
    )

    own = {ly.BatchInstanceNorm: ("rho", "gamma", "beta"), ly.SelfAttention: ("gamma",)}
    out: List[Entry] = []

    def leaf_conv(prefix, path, kind):
        out.extend([(prefix + "weight", "params", path + ("kernel",), kind),
                    (prefix + "bias", "params", path + ("bias",), "copy")])

    def walk(m, prefix, path):
        if isinstance(m, blocks.SNConv):
            leaf_conv(prefix, path + ("Conv_0",), "conv")
            if m.if_SN:
                for name in ("u", "sigma"):
                    out.append((prefix + name, "batch_stats",
                                path + ("SpectralNorm_0", f"Conv_0/kernel/{name}"), "copy"))
        elif isinstance(m, (Conv, unet3d.Conv3d)):
            leaf_conv(prefix, path, "conv")
        elif isinstance(m, blocks.ConvTranspose):
            leaf_conv(prefix, path, "convT")
        elif isinstance(m, nn.Linear):
            out.append((prefix + "weight", "params", path + ("kernel",), "dense"))
        elif isinstance(m, (blocks.BatchNorm, ly.BiasedBatchNorm)):
            if m.weight is not None:
                out.extend([(prefix + "weight", "params", path + ("scale",), "copy"),
                            (prefix + "bias", "params", path + ("bias",), "copy")])
            out.extend([(prefix + "running_mean", "batch_stats", path + ("mean",), "copy"),
                        (prefix + "running_var", "batch_stats", path + ("var",), "copy")])
        elif isinstance(m, blocks.ResUp):
            if m.up_type in ("Conv2", "Conv4"):
                leaf_conv(prefix + "up.", path + ("ConvTranspose_0",), "convT")
            core = path + ("_ResCore_0",)
            leaf_conv(prefix + "conv_input.", core + ("Conv_0",), "conv")
            for idx, name in ((0, "Conv_1"), (3, "Conv_2")):
                leaf_conv(f"{prefix}conv.{idx}.", core + (name,), "conv")
            for idx, name in ((1, "BatchNorm_0"), (4, "BatchNorm_1")):
                walk(m.conv[idx], f"{prefix}conv.{idx}.", core + (name,))
        else:
            for name in own.get(type(m), ()):
                out.append((prefix + name, "params", path + (name,), "copy"))
            for attr, sub in _baseline_children(m):
                walk(m.get_submodule(attr), f"{prefix}{attr}.", path + sub)

    walk(module, "", ())
    return out


def _at(tree: Mapping, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _network(network: Union[str, nn.Module], params: Mapping, image_ch: int) -> nn.Module:
    if isinstance(network, nn.Module):
        return network
    from cooperative_training_and_latent_space_data_augmentation_tpu_torch.train.segmentation import (
        NETWORK_REGISTRY,
    )

    num_classes = int(np.asarray(params["Conv_0"]["kernel"]).shape[-1])
    return NETWORK_REGISTRY[network](num_classes, image_ch)


def baseline_from_jax(network: Union[str, nn.Module], params: Mapping, batch_stats: Mapping,
                      image_ch: int = 1) -> StateDict:
    """A JAX baseline's ``params``/``batch_stats`` (numpy leaves, flax
    auto-names) -> the state dict of the port's ``network`` (a module, or a
    ``NETWORK_REGISTRY`` name, built with the head's class count and
    ``image_ch`` input channels)."""
    model = _network(network, params, image_ch)
    trees = {"params": params, "batch_stats": batch_stats}
    return {key: _t(kernel_to_torch(np.asarray(_at(trees[col], path)), kind))
            for key, col, path, kind in baseline_entries(model)}


@dataclass
class BaselineTrainState:
    """A JAX ``SegmentationSolver`` state in the port's terms: the online
    network's ``state_dict``; ``ema``, the EMA parameters (None without
    EMA); Adam's moments ``exp_avg``/``exp_avg_sq`` by parameter name;
    ``step``, the update count; ``clip_nu``, the Adam-bound clip's own
    second moments (None without the clip)."""

    state_dict: StateDict
    ema: Optional[StateDict]
    exp_avg: StateDict
    exp_avg_sq: StateDict
    step: int
    clip_nu: Optional[StateDict]


def baseline_train_state_from_jax(network: Union[str, nn.Module], params: Mapping,
                                  batch_stats: Mapping, opt_state,
                                  image_ch: int = 1) -> BaselineTrainState:
    """A JAX ``SegmentationSolver``'s ``TrainState`` fields -> a
    :class:`BaselineTrainState`."""
    ema = "online" in params
    online = params["online"] if ema else params
    model = _network(network, online, image_ch)
    names = {n for n, _ in model.named_parameters()}

    def param_part(tree) -> StateDict:
        return {k: v for k, v in baseline_from_jax(model, tree, batch_stats).items() if k in names}

    adam = _adam_state(opt_state)
    clip = _find_state(opt_state, lambda s: isinstance(s, Mapping) and set(s) == {"nu", "count"})
    return BaselineTrainState(
        baseline_from_jax(model, online, batch_stats),
        param_part(params["ema"]) if ema else None,
        param_part(adam.mu), param_part(adam.nu), int(np.asarray(adam.count)),
        param_part(clip["nu"]) if clip is not None else None)
