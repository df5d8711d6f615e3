"""The port's state dicts in the JAX solver's flax layout (not a test module).

``to_flax(state_dicts)`` is the inverse of ``convert.from_jax``: it gives
the ``(params, batch_stats)`` trees, keyed by the flax auto-names, that
``from_jax`` maps back to the same state dicts.  A predictor drawn by the
port's ``init_parameters`` draws from the JAX package's initial
distributions, so ``to_flax`` of it is a JAX-initialised state in JAX's
layout, made without JAX: the card tests, which run where JAX is absent,
load models through ``from_jax`` from it.  It imports neither JAX nor the
JAX package; ``test_torch_port_eval.py`` holds it against the JAX solver's
own parameter tree.
"""

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

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

