"""3-D UNet parts, NCDHW.

Counterpart of the JAX package's ``models/unet3d.py`` (the reference's
``unet_parts.UnetConv3`` and ``UnetUp3``) and its minimal volumetric UNet:
H and W halve at each level, depth is kept (cardiac stacks are thin).
Everything computes in the input's dtype on ``F.conv3d`` (full f32 when
f32); no kernel of the port serves 3-D convs.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from cooperative_training_and_latent_space_data_augmentation_tpu_torch.models.blocks import (
    BatchNorm,
    ConvTranspose,
)
from cooperative_training_and_latent_space_data_augmentation_tpu_torch.ops.conv_chw import (
    full_f32,
)


class Conv3d(nn.Module):
    """SAME stride-1 cubic 3-D conv with ``nn.Conv3d``'s state dict,
    computing in the input's dtype, bias added after."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kernel_size, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_f32(x.dtype):
            y = F.conv3d(x, self.weight.to(x.dtype), None, padding=self.weight.shape[2] // 2)
        return y + self.bias.to(x.dtype).view(-1, 1, 1, 1)


class UnetConv3(nn.Module):
    """[conv3x3x3 - (BN) - ReLU] x 2."""

    def __init__(self, c_in: int, features: int, is_batchnorm: bool = True):
        super().__init__()
        self.conv1 = Conv3d(c_in, features)
        self.bn1 = BatchNorm(features) if is_batchnorm else nn.Identity()
        self.conv2 = Conv3d(features, features)
        self.bn2 = BatchNorm(features) if is_batchnorm else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(x)))


class UnetUp3(nn.Module):
    """3-D up block: x upsampled (trilinear with half-pixel centres, depth
    by ``z_scale_factor``, H and W by 2; or with ``is_deconv`` a "SAME"
    transposed conv to ``features``: k (1, 4, 4) s (1, 2, 2) at z scale 1,
    else k 4 s 2), concatenated after the skip, then :class:`UnetConv3`."""

    def __init__(self, x_ch: int, skip_ch: int, features: int, is_deconv: bool = False,
                 is_batchnorm: bool = True, z_scale_factor: int = 1):
        super().__init__()
        self.is_deconv = is_deconv
        self.z_scale_factor = z_scale_factor
        if is_deconv:
            zs = z_scale_factor
            kernel, stride, pad = (((1, 4, 4), (1, 2, 2), (0, 1, 1)) if zs == 1
                                   else ((4, 4, 4), (2, 2, 2), (1, 1, 1)))
            self.up = ConvTranspose(x_ch, features, kernel, stride, pad, None)
            x_ch = features
        self.conv = UnetConv3(skip_ch + x_ch, features, is_batchnorm)

    def forward(self, skip: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if self.is_deconv:
            x = self.up(x)
        else:
            d, h, w = x.shape[2:]
            x = F.interpolate(x, size=(d * self.z_scale_factor, 2 * h, 2 * w),
                              mode="trilinear", align_corners=False)
        return self.conv(torch.cat([skip, x], dim=1))


class UNet3D(nn.Module):
    """Three :class:`UnetConv3` levels (widths (64, 128, 256) //
    feature_scale, (1, 2, 2) max pooling between), two trilinear
    :class:`UnetUp3` and a 1x1x1 head in the input's dtype."""

    def __init__(self, in_ch: int = 1, num_classes: int = 4, feature_scale: int = 4,
                 is_batchnorm: bool = True):
        super().__init__()
        f = feature_scale
        w = (64 // f, 128 // f, 256 // f)
        self.conv1 = UnetConv3(in_ch, w[0], is_batchnorm)
        self.conv2 = UnetConv3(w[0], w[1], is_batchnorm)
        self.conv3 = UnetConv3(w[1], w[2], is_batchnorm)
        self.up1 = UnetUp3(w[2], w[1], w[1], is_batchnorm=is_batchnorm)
        self.up2 = UnetUp3(w[1], w[0], w[0], is_batchnorm=is_batchnorm)
        self.outc = Conv3d(w[0], num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv1(x)
        x2 = self.conv2(F.max_pool3d(x1, (1, 2, 2)))
        x3 = self.conv3(F.max_pool3d(x2, (1, 2, 2)))
        return self.outc(self.up2(x1, self.up1(x2, x3)))

