"""FTN/STN encoders and decoders, NCHW, eval mode.

Counterpart of ``cooperative_training_and_latent_space_data_augmentation_tpu/
models/encoder_decoder.py`` (``Encoder``, ``Decoder``, ``CodeDecoupler``,
``DualBranchEncoder``).  With ``feature_reduce=4`` (the FCN_16_standard
plan) the widths are 16/32/64/128/128 and a 192x192 input gives a 12x12x128
latent.

Mixed precision as in the JAX package: the conv stacks compute in
``dtype`` (bf16 on the card); the latent head, the output head and the code
decoupler compute in float32; BatchNorm always computes in float32.

``conv_s2`` is the JAX package's ``PALLAS_CONV_S2`` switch, off by default:
the encoders' stride-2 downsamples with at most 64 channels run on kernel
K4 (:class:`..models.blocks.ResConvDown`).  ``conv_nl`` is its
``PALLAS_CONV_NL`` switch, also off by default: the 3x3 convs of the
residual stages whose channels pass the NL rule run on kernel K5 (at full
width the encoders' ``down3`` and ``down4``, four convs a pass, and the
decoders' ``up1``, one).  The two combine freely.  The code decoupler never
takes K5 (:func:`code_decoupler`).  ``dropout``: the rate of the channel
dropout after each residual stage (the JAX package's ``encoder_dropout``
and ``decoder_dropout``; :class:`..models.blocks.ResCore`); the code
decoupler has none.

:class:`DomainSpecificEncoder` (the JAX package's, with a static
``domain_id``) is the encoder's topology with a bank of flax-style
BatchNorms per domain in place of every norm
(:class:`..models.layers.DomainSpecificBatchNorm`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BatchNorm,
    LeakyReLU,
    ResConvDown,
    ResUp,
    conv_bn_stack,
    layer_dropout,
    leaky_relu,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.layers import (
    DomainSpecificBatchNorm,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import Conv

_ACTS = {"relu": torch.relu, "sigmoid": torch.sigmoid, None: None}


class Encoder(nn.Module):
    """Skip-free conv encoder: inc double conv -> LeakyReLU -> 4 stride-2
    residual stages -> float32 1x1 conv + BN -> ``act``."""

    def __init__(self, in_ch: int, feature_reduce: int = 4,
                 act: Optional[str] = "relu", dtype: Optional[torch.dtype] = None,
                 conv_s2: bool = False, conv_nl: bool = False,
                 dropout: Optional[float] = None):
        super().__init__()
        f = feature_reduce
        widths = (64 // f, 128 // f, 256 // f, 512 // f, 512 // f)
        self.inc = conv_bn_stack(in_ch, widths[0], dtype, conv_nl)
        for i in range(4):
            self.add_module(f"down{i + 1}", ResConvDown(widths[i], widths[i + 1], dtype,
                                                        conv_s2, conv_nl, dropout))
        self.final_conv = nn.Sequential(
            Conv(widths[4], widths[4], 1, dtype=torch.float32), BatchNorm(widths[4]))
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.inc(x))
        for down in (self.down1, self.down2, self.down3, self.down4):
            x = down(x)
        x = self.final_conv(x.float())
        return self.act(x) if self.act is not None else x


class Decoder(nn.Module):
    """Skip-free conv decoder: 4 x2 residual up stages -> float32 1x1 conv
    -> optional ``last_act``."""

    def __init__(self, output_channel: int, feature_reduce: int = 4,
                 up_type: str = "NN", last_act: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, conv_nl: bool = False,
                 dropout: Optional[float] = None):
        super().__init__()
        f = feature_reduce
        widths = (512 // f, 256 // f, 128 // f, 64 // f, 64 // f)
        for i in range(4):
            self.add_module(f"up{i + 1}", ResUp(widths[i], widths[i + 1], up_type, dtype,
                                                conv_nl, dropout))
        self.final_conv = Conv(widths[4], output_channel, 1, dtype=torch.float32)
        self.last_act = _ACTS[last_act]

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = z
        for up in (self.up1, self.up2, self.up3, self.up4):
            x = up(x)
        x = self.final_conv(x.float())
        return self.last_act(x) if self.last_act is not None else x


def code_decoupler(features: int) -> nn.Sequential:
    """z_i -> z_s filter, conv3-BN-LReLU-conv3-BN-ReLU, always float32.

    Takes no ``conv_nl``: its two 128->128 3x3 convs would pass the NL
    channel rule, but the JAX package builds them with flax's stock
    ``nn.Conv`` (``models/encoder_decoder.py:174,178`` there), not with its
    dispatching ``Conv``, so under ``PALLAS_CONV_NL=1`` they stay on XLA.
    Here they stay on ``F.conv2d``."""
    return nn.Sequential(
        Conv(features, features, 3, padding=1, dtype=torch.float32),
        BatchNorm(features), LeakyReLU(),
        Conv(features, features, 3, padding=1, dtype=torch.float32),
        BatchNorm(features), nn.ReLU())


class DualBranchEncoder(nn.Module):
    """FTN encoder: x -> (z_i, z_s = code_decoupler(z_i))."""

    def __init__(self, in_ch: int, feature_reduce: int = 4,
                 dtype: Optional[torch.dtype] = None, conv_s2: bool = False,
                 conv_nl: bool = False, dropout: Optional[float] = None):
        super().__init__()
        self.general_encoder = Encoder(in_ch, feature_reduce, "relu", dtype, conv_s2,
                                       conv_nl, dropout)
        self.code_decoupler = code_decoupler(512 // feature_reduce)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z_i = self.general_encoder(x)
        return z_i, self.code_decoupler(z_i)


class _DomainSpecificDown(nn.Module):
    """Stride-2 pad-1 3x3 downsample, then LReLU(conv1x1 + [conv3-DSBN-LReLU-
    conv3-DSBN]) and optional channel dropout (the reference's
    ``ds_res_convdown``)."""

    def __init__(self, c_in: int, features: int, num_domains: int,
                 dropout: Optional[float]):
        super().__init__()
        self.down = Conv(c_in, c_in, 3, stride=2, padding=1)
        self.conv_input = Conv(c_in, features, 1)
        self.conv1 = Conv(c_in, features, 3, padding=1)
        self.norm_1 = DomainSpecificBatchNorm(features, num_domains)
        self.conv2 = Conv(features, features, 3, padding=1)
        self.norm_2 = DomainSpecificBatchNorm(features, num_domains)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, domain_id: int) -> torch.Tensor:
        h = self.down(x)
        r = leaky_relu(self.norm_1(self.conv1(h), domain_id))
        r = self.norm_2(self.conv2(r), domain_id)
        return layer_dropout(leaky_relu(self.conv_input(h) + r), self.dropout, self.training)


class DomainSpecificEncoder(nn.Module):
    """Encoder with per-domain BatchNorm banks: conv3-DSBN-LReLU-conv3-DSBN-
    LReLU -> 4 stride-2 residual stages (widths (128, 256, 512, 512) //
    feature_reduce) -> 1x1 conv + DSBN -> ``act``.  Every conv computes in
    the input's dtype.  ``forward(x, domain_id)`` runs, and in train mode
    moves the statistics of, only bank ``domain_id``."""

    def __init__(self, in_ch: int = 1, feature_reduce: int = 1, num_domains: int = 2,
                 act: Optional[str] = "sigmoid", dropout: Optional[float] = None):
        super().__init__()
        f = feature_reduce
        widths = (64 // f, 128 // f, 256 // f, 512 // f, 512 // f)
        self.conv1 = Conv(in_ch, widths[0], 3, padding=1)
        self.norm_1 = DomainSpecificBatchNorm(widths[0], num_domains)
        self.conv2 = Conv(widths[0], widths[0], 3, padding=1)
        self.norm_2 = DomainSpecificBatchNorm(widths[0], num_domains)
        for i in range(4):
            self.add_module(f"down{i + 1}", _DomainSpecificDown(widths[i], widths[i + 1],
                                                                num_domains, dropout))
        self.final_conv = Conv(widths[4], widths[4], 1)
        self.final_norm = DomainSpecificBatchNorm(widths[4], num_domains)
        self.act = _ACTS[act]

    def forward(self, x: torch.Tensor, domain_id: int = 0) -> torch.Tensor:
        h = leaky_relu(self.norm_1(self.conv1(x), domain_id))
        h = leaky_relu(self.norm_2(self.conv2(h), domain_id))
        for down in (self.down1, self.down2, self.down3, self.down4):
            h = down(h, domain_id)
        h = self.final_norm(self.final_conv(h), domain_id)
        return self.act(h) if self.act is not None else h
