"""The port's state dicts in the JAX solver's flax layout (not a test module).

``to_flax(state_dicts)`` is the inverse of ``convert.from_jax``: it gives
the ``(params, batch_stats)`` trees, keyed by the flax auto-names, that
``from_jax`` maps back to the same state dicts.  ``baseline_to_flax(module)``
does the same for a baseline network through ``convert.baseline_entries``,
and ``write_flax_msgpack`` writes a tree as flax's ``serialization.to_bytes``
does (a msgpack encoder on ``struct``), so a card test can make a JAX
solver's ``.msgpack`` checkpoint where JAX is absent.  A predictor drawn by the
port's ``init_parameters`` draws from the JAX package's initial
distributions, so ``to_flax`` of it is a JAX-initialised state in JAX's
layout, made without JAX: the card tests, which run where JAX is absent,
load models through ``from_jax`` from it.  It imports neither JAX nor the
JAX package; ``test_torch_port_eval.py`` holds it against the JAX solver's
own parameter tree.
"""

import struct
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from cooperative_training_and_latent_space_data_augmentation_tpu_torch import convert

Tree = Dict[str, object]


def _a(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _conv(sd: Mapping, key: str) -> Tree:
    """{weight OIHW, bias} -> flax Conv {kernel HWIO, bias}."""
    return {"kernel": np.ascontiguousarray(_a(sd[f"{key}.weight"]).transpose(2, 3, 1, 0)),
            "bias": _a(sd[f"{key}.bias"])}


def _conv_transpose(sd: Mapping, key: str) -> Tree:
    """torch weight[i, o, kH-1-h, kW-1-w] -> flax kernel[h, w, i, o]."""
    k = _a(sd[f"{key}.weight"]).transpose(2, 3, 0, 1)[::-1, ::-1]
    return {"kernel": np.ascontiguousarray(k), "bias": _a(sd[f"{key}.bias"])}


def _bn(sd: Mapping, key: str) -> Tuple[Tree, Tree]:
    return ({"scale": _a(sd[f"{key}.weight"]), "bias": _a(sd[f"{key}.bias"])},
            {"mean": _a(sd[f"{key}.running_mean"]), "var": _a(sd[f"{key}.running_var"])})


def _stack(sd: Mapping, prefix: str, convs=("Conv_0", "Conv_1")) -> Tuple[Tree, Tree]:
    """Sequential indices 0, 1, 3, 4 -> conv3-BN-LReLU-conv3-BN."""
    p = {convs[0]: _conv(sd, f"{prefix}.0"), convs[1]: _conv(sd, f"{prefix}.3")}
    s = {}
    for bn, i in (("BatchNorm_0", 1), ("BatchNorm_1", 4)):
        p[bn], s[bn] = _bn(sd, f"{prefix}.{i}")
    return p, s


def _res_core(sd: Mapping, prefix: str) -> Tuple[Tree, Tree]:
    p, s = _stack(sd, f"{prefix}.conv", ("Conv_1", "Conv_2"))
    p["Conv_0"] = _conv(sd, f"{prefix}.conv_input")
    return p, s


def _encoder(sd: Mapping, prefix: str = "") -> Tuple[Tree, Tree]:
    p, s = {}, {}
    p["ConvBlock_0"], s["ConvBlock_0"] = _stack(sd, f"{prefix}inc")
    for i in range(4):
        cp, cs = _res_core(sd, f"{prefix}down{i + 1}")
        p[f"ResConvDown_{i}"] = {"Conv_0": _conv(sd, f"{prefix}down{i + 1}.down"),
                                 "_ResCore_0": cp}
        s[f"ResConvDown_{i}"] = {"_ResCore_0": cs}
    p["Conv_0"] = _conv(sd, f"{prefix}final_conv.0")
    p["BatchNorm_0"], s["BatchNorm_0"] = _bn(sd, f"{prefix}final_conv.1")
    return p, s


def _decoder(sd: Mapping) -> Tuple[Tree, Tree]:
    p, s = {}, {}
    for i in range(4):
        cp, cs = _res_core(sd, f"up{i + 1}")
        p[f"ResUp_{i}"] = {"_ResCore_0": cp}
        if f"up{i + 1}.up.weight" in sd:
            p[f"ResUp_{i}"]["ConvTranspose_0"] = _conv_transpose(sd, f"up{i + 1}.up")
        s[f"ResUp_{i}"] = {"_ResCore_0": cs}
    p["Conv_0"] = _conv(sd, "final_conv")
    return p, s


def _dual_branch_encoder(sd: Mapping) -> Tuple[Tree, Tree]:
    gp, gs = _encoder(sd, "general_encoder.")
    cp, cs = _stack(sd, "code_decoupler")
    return {"general_encoder": gp, "code_decoupler": cp}, {"general_encoder": gs,
                                                           "code_decoupler": cs}


def to_flax(state_dicts: Mapping[str, Mapping[str, torch.Tensor]]) -> Tuple[Tree, Tree]:
    """``{module: state_dict}`` -> the JAX solver's (params, batch_stats)."""
    builders = {"image_encoder": _dual_branch_encoder, "segmentation_decoder": _decoder,
                "shape_encoder": _encoder, "shape_decoder": _decoder,
                "image_decoder": _decoder}
    params, stats = {}, {}
    for name, build in builders.items():
        params[name], stats[name] = build(state_dicts[name])
    return params, stats



def kernel_to_flax(w: np.ndarray, kind: str) -> np.ndarray:
    """The inverse of ``convert.kernel_to_torch``."""
    if kind == "copy":
        return w
    n = w.ndim
    if kind == "convT":
        k = np.transpose(w, tuple(range(2, n)) + (0, 1))
        return np.ascontiguousarray(k[(slice(None, None, -1),) * (n - 2)])
    return np.ascontiguousarray(np.transpose(w, tuple(range(2, n)) + (1, 0)))


def baseline_to_flax(module: torch.nn.Module) -> Tuple[Tree, Tree]:
    """A baseline network's state -> the JAX network's (params,
    batch_stats), the inverse of ``convert.baseline_from_jax``."""
    sd = module.state_dict()
    trees = {"params": {}, "batch_stats": {}}
    for key, col, path, kind in convert.baseline_entries(module):
        node = trees[col]
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = kernel_to_flax(_a(sd[key]), kind)
    return trees["params"], trees["batch_stats"]


def _pack(obj) -> bytes:
    """msgpack of a tree of dicts, strings, ints, lists and arrays, arrays
    as flax's ndarray extension (type 1: the msgpack of (shape, dtype name,
    C-order bytes))."""
    if isinstance(obj, dict):
        head = bytes([0x80 | len(obj)]) if len(obj) < 16 else b"\xde" + struct.pack(">H", len(obj))
        return head + b"".join(_pack(k) + _pack(v) for k, v in obj.items())
    if isinstance(obj, str):
        b = obj.encode()
        if len(b) < 32:
            return bytes([0xa0 | len(b)]) + b
        return b"\xd9" + struct.pack(">B", len(b)) + b
    if isinstance(obj, bytes):
        return b"\xc6" + struct.pack(">I", len(obj)) + obj
    if isinstance(obj, int):
        return bytes([obj]) if 0 <= obj < 128 else b"\xce" + struct.pack(">I", obj)
    if isinstance(obj, (list, tuple)):
        return bytes([0x90 | len(obj)]) + b"".join(_pack(v) for v in obj)
    arr = np.ascontiguousarray(np.asarray(obj))
    payload = _pack([list(arr.shape), arr.dtype.name, arr.tobytes()])
    return b"\xc9" + struct.pack(">I", len(payload)) + b"\x01" + payload


def write_flax_msgpack(path: str, tree: Tree) -> None:
    """Write ``tree`` as flax's ``serialization.to_bytes`` would."""
    with open(path, "wb") as f:
        f.write(_pack(tree))
