"""The baseline segmentation networks, NCHW: the UNet family and the
Bai-style FCN.

Counterpart of the JAX package's ``models/unet.py`` (the reference's
``segmentation_models/unet.py``, ``fcn.py`` and ``resconvunet.py``):
``DoubleConv``, ``ConvBNRelu``, ``UNet``, ``UNetv2``, ``ResBlock``,
``ResConvUNet``, ``DeeplySupervisedUNet`` and ``FCN``.

Mixed precision as there: the convs compute in ``dtype`` (None: the input's)
and every norm in float32 (BatchNorm returns the input's dtype, instance
norm float32); the logits heads compute in float32.  Every conv is a
:class:`..ops.conv_chw.Conv`, so the 3x3 stride-1 convs with at most 64
channels on either side run on kernel K1 (with K1 dx and K2 in the
backward) and the rest on ``F.conv2d``.  Channel dropout takes its keep
masks from :func:`..models.blocks.dropout_masks`, in forward order.

Every network takes an NCHW float input and returns NCHW logits, and
:meth:`input_convs` names the convs that read the input (they need no
input gradient, so no K1 dx).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BatchNorm,
    ConvTranspose,
    SNConv,
    layer_dropout,
    norm_layer,
    upsample_bilinear,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import Conv


class DoubleConv(nn.Module):
    """conv3-norm-ReLU-conv3-norm-ReLU with the reference's ``norm`` and
    ``if_SN`` knobs."""

    def __init__(self, c_in: int, features: int, norm: str = "batch", if_SN: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = SNConv(c_in, features, 3, if_SN, dtype)
        self.norm1 = norm_layer(norm, features)
        self.conv2 = SNConv(features, features, 3, if_SN, dtype)
        self.norm2 = norm_layer(norm, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.norm1(self.conv1(x)))
        return torch.relu(self.norm2(self.conv2(x)))


class ConvBNRelu(nn.Module):
    """conv-BN-ReLU: a ``kernel`` x ``kernel`` conv (SAME at stride 1, pad 1
    at stride 2, no padding for 1x1)."""

    def __init__(self, c_in: int, features: int, kernel: int = 3, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(c_in, features, kernel, stride, 0 if kernel == 1 else 1, dtype)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class UNet(nn.Module):
    """inc double conv -> 4 x [maxpool 2 + double conv] -> 4 x [bilinear
    x2 + skip concat + double conv] -> float32 1x1 head.  Widths (64, 128,
    256, 512, 512) // feature_scale down and (256, 128, 64, 64) //
    feature_scale up: UNet_64, UNet_32, UNet_16 for 1, 2, 4.
    ``encoder_dropout`` hits each stage's output, ``decoder_dropout`` each
    skip concat before its double conv."""

    BOTTLENECK = 512

    def __init__(self, in_ch: int = 1, num_classes: int = 4, feature_scale: int = 4,
                 norm: str = "batch", if_SN: bool = False,
                 encoder_dropout: Optional[float] = None,
                 decoder_dropout: Optional[float] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = feature_scale
        enc = (64 // f, 128 // f, 256 // f, 512 // f, self.BOTTLENECK // f)
        dec = (256 // f, 128 // f, 64 // f, 64 // f)

        def dc(c_in, c_out):
            return DoubleConv(c_in, c_out, norm, if_SN, dtype)

        self.inc = dc(in_ch, enc[0])
        for i in range(4):
            self.add_module(f"down{i + 1}", dc(enc[i], enc[i + 1]))
        prev = enc[4]
        for i in range(4):
            self.add_module(f"up{i + 1}", dc(enc[3 - i] + prev, dec[i]))
            prev = dec[i]
        self.outc = Conv(dec[3], num_classes, 1, dtype=torch.float32)
        self.encoder_dropout = encoder_dropout
        self.decoder_dropout = decoder_dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        h = x
        for i, stage in enumerate((self.inc, self.down1, self.down2, self.down3, self.down4)):
            h = stage(h if i == 0 else F.max_pool2d(h, 2))
            h = layer_dropout(h, self.encoder_dropout, self.training)
            skips.append(h)
        for up, skip in zip((self.up1, self.up2, self.up3, self.up4), reversed(skips[:4])):
            a = torch.cat([skip, upsample_bilinear(h)], dim=1)
            h = up(layer_dropout(a, self.decoder_dropout, self.training))
        return self.outc(h.float())

    def input_convs(self) -> List[Conv]:
        return [self.inc.conv1]


class UNetv2(UNet):
    """:class:`UNet` with a 1024 // feature_scale bottleneck and no
    dropout."""

    BOTTLENECK = 1024

    def __init__(self, in_ch: int = 1, num_classes: int = 4, feature_scale: int = 4,
                 norm: str = "batch", if_SN: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__(in_ch, num_classes, feature_scale, norm, if_SN, dtype=dtype)


class ResBlock(nn.Module):
    """ReLU residual block ``relu(conv1x1(x) + [conv3-norm-relu-conv3-norm](x))``
    with optional channel dropout after it."""

    def __init__(self, c_in: int, features: int, norm: str = "batch", if_SN: bool = False,
                 dropout: Optional[float] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.shortcut = SNConv(c_in, features, 1, if_SN, dtype)
        self.conv1 = SNConv(c_in, features, 3, if_SN, dtype)
        self.norm1 = norm_layer(norm, features)
        self.conv2 = SNConv(features, features, 3, if_SN, dtype)
        self.norm2 = norm_layer(norm, features)
        self.dropout = dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.shortcut(x)
        h = torch.relu(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        out = torch.relu(shortcut.to(h.dtype) + h)
        return layer_dropout(out, self.dropout, self.training)


class ResConvUNet(nn.Module):
    """UNet of residual blocks: res inc -> 4 x [maxpool + res block] ->
    4 x [k4s2 transposed conv (channels kept) + concat with the skip (after
    it) + res block] -> float32 1x1 head."""

    def __init__(self, in_ch: int = 1, num_classes: int = 4, feature_scale: int = 4,
                 norm: str = "batch", if_SN: bool = False,
                 encoder_dropout: Optional[float] = None,
                 decoder_dropout: Optional[float] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = feature_scale
        enc = (64 // f, 128 // f, 256 // f, 512 // f, 512 // f)
        dec = (256 // f, 128 // f, 64 // f, 64 // f)

        def rb(c_in, c_out, drop):
            return ResBlock(c_in, c_out, norm, if_SN, drop, dtype)

        self.inc = rb(in_ch, enc[0], encoder_dropout)
        for i in range(4):
            self.add_module(f"down{i + 1}", rb(enc[i], enc[i + 1], encoder_dropout))
        prev = enc[4]
        for i in range(4):
            self.add_module(f"deconv{i + 1}",
                            ConvTranspose(prev, prev, (4, 4), (2, 2), (1, 1), dtype))
            self.add_module(f"up{i + 1}", rb(prev + enc[3 - i], dec[i], decoder_dropout))
            prev = dec[i]
        self.outc = Conv(dec[3], num_classes, 1, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        h = x
        for i, stage in enumerate((self.inc, self.down1, self.down2, self.down3, self.down4)):
            h = stage(h if i == 0 else F.max_pool2d(h, 2))
            skips.append(h)
        for i, skip in enumerate(reversed(skips[:4])):
            a = getattr(self, f"deconv{i + 1}")(h)
            h = getattr(self, f"up{i + 1}")(torch.cat([a, skip], dim=1))
        return self.outc(h.float())

    def input_convs(self) -> List[Conv]:
        return [self.inc.shortcut, self.inc.conv1]


class DeeplySupervisedUNet(nn.Module):
    """UNet with mixed deep-supervision heads: 1x1 float32 heads on the
    second and third decoder stages, ``mixed = up2(dsv2) + dsv3``, and
    ``final = head(d4) + up2(mixed)``; ``multi_out`` returns ``(head(d4),
    up2(mixed), final)``.  Widths base x (1, 2, 4, 8, 8).  Channel dropout
    hits the outputs of down2..down4 and the skip concats of up1..up3."""

    def __init__(self, in_ch: int = 1, num_classes: int = 4, base_n_filters: int = 64,
                 dropout: Optional[float] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        b = base_n_filters
        enc = (b, 2 * b, 4 * b, 8 * b, 8 * b)
        dec = (4 * b, 2 * b, b, b)

        def dc(c_in, c_out):
            return DoubleConv(c_in, c_out, dtype=dtype)

        self.inc = dc(in_ch, enc[0])
        for i in range(4):
            self.add_module(f"down{i + 1}", dc(enc[i], enc[i + 1]))
        prev = enc[4]
        for i in range(4):
            self.add_module(f"up{i + 1}", dc(enc[3 - i] + prev, dec[i]))
            prev = dec[i]
        self.dsv2 = Conv(dec[1], num_classes, 1, dtype=torch.float32)
        self.dsv3 = Conv(dec[2], num_classes, 1, dtype=torch.float32)
        self.outc = Conv(dec[3], num_classes, 1, dtype=torch.float32)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, multi_out: bool = False):
        skips = []
        h = x
        for i, stage in enumerate((self.inc, self.down1, self.down2, self.down3, self.down4)):
            h = stage(h if i == 0 else F.max_pool2d(h, 2))
            if i >= 2:
                h = layer_dropout(h, self.dropout, self.training)
            skips.append(h)
        outs = []
        for i, (up, skip) in enumerate(zip((self.up1, self.up2, self.up3, self.up4),
                                           reversed(skips[:4]))):
            a = torch.cat([skip, upsample_bilinear(h)], dim=1)
            if i < 3:
                a = layer_dropout(a, self.dropout, self.training)
            h = up(a)
            outs.append(h)
        dsv2 = self.dsv2(outs[1].float())
        dsv3 = self.dsv3(outs[2].float())
        mixed_up = upsample_bilinear(upsample_bilinear(dsv2) + dsv3)
        out = self.outc(h.float())
        final = out + mixed_up
        return (out, mixed_up, final) if multi_out else final

    def input_convs(self) -> List[Conv]:
        return [self.inc.conv1]


class FCN(nn.Module):
    """Bai-style multi-scale FCN: a VGG-like trunk of conv-BN-ReLU blocks
    (widths (64, 128, 256, 512, 512) // feature_scale, stride-2 convs
    between levels), a 3x3 lateral conv-BN-ReLU to 64 // feature_scale on
    each level's output, each upsampled to full size in one align-corners
    step (x2, x4, x8, x16), concatenated, fused by two 1x1 conv-BN-ReLU to
    64 channels, and a float32 1x1 head.  ``decoder_dropout`` hits both
    fusion outputs."""

    # trunk blocks per level: the first of levels 2..5 has stride 2
    LEVELS = (2, 2, 3, 3, 3)

    def __init__(self, in_ch: int = 1, num_classes: int = 4, feature_scale: int = 4,
                 decoder_dropout: Optional[float] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        f = feature_scale
        filters = (64 // f, 128 // f, 256 // f, 512 // f, 512 // f)
        trunk, prev = [], in_ch
        for level, n in enumerate(self.LEVELS):
            for j in range(n):
                stride = 2 if level > 0 and j == 0 else 1
                trunk.append(ConvBNRelu(prev, filters[level], stride=stride, dtype=dtype))
                prev = filters[level]
        self.trunk = nn.ModuleList(trunk)
        self.lateral = nn.ModuleList(ConvBNRelu(c, filters[0], dtype=dtype) for c in filters)
        self.fuse = nn.ModuleList([ConvBNRelu(5 * filters[0], 64, kernel=1, dtype=dtype),
                                   ConvBNRelu(64, 64, kernel=1, dtype=dtype)])
        self.outc = Conv(64, num_classes, 1, dtype=torch.float32)
        self.decoder_dropout = decoder_dropout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        levels, h, k = [], x, 0
        for n in self.LEVELS:
            for block in self.trunk[k:k + n]:
                h = block(h)
            k += n
            levels.append(h)
        outs = [lat(level) for lat, level in zip(self.lateral, levels)]
        feats = torch.cat([outs[0]] + [upsample_bilinear(o, 2 ** i)
                                       for i, o in enumerate(outs) if i > 0], dim=1)
        for fuse in self.fuse:
            feats = layer_dropout(fuse(feats), self.decoder_dropout, self.training)
        return self.outc(feats.float())

    def input_convs(self) -> List[Conv]:
        return [self.trunk[0].conv]
