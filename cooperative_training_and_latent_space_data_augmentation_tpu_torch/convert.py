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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import numpy as np
import torch

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
