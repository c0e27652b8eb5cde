"""nnU-Net-style 3D UNet, counterpart of ``ldiffusion_tpu/models/dynunet3d.py:32-188``
(reference ``get_network_from_plans.py:9-77``): per stage [conv with the
stage's per-axis kernel → InstanceNorm → LeakyReLU(0.01)] × n (thin axes of
anisotropic volumes use kernel 1 while they are thin), strided-conv
downsampling with per-axis strides, transpose-conv upsampling with skip
concat, 1×1×1 segmentation heads at every decoder stage. Submodule names
follow the flax tree (``enc_{s}_{c}``, ``up_{d}``, ``dec_{d}_{c}``,
``seg_{d}``). ``block_type="residual"`` makes the encoder stages BasicBlockD
residual blocks (the ResEnc planners; ``n_blocks_per_stage``, the ResEnc-M
schedule by default); the decoder stays plain.

Layout: NCDHW at the boundary, ``channels_last_3d`` inside (cuDNN's fast 3D
layout). ``compute_dtype`` (e.g. bfloat16) runs the convolutions in that
dtype over parameters kept in theirs; the InstanceNorm computes its
statistics and the normalisation in float32 and returns x's dtype, as the
flax module does (``:68-77``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ldiffusion_tpu_torch.models.dynunet import _conv, encoder_blocks

Triple = Tuple[int, int, int]


@dataclasses.dataclass(frozen=True)
class DynUNet3DConfig:
    in_channels: int = 1
    num_classes: int = 2
    features_per_stage: Tuple[int, ...] = (32, 64, 128, 256, 320, 320)
    strides: Tuple[Triple, ...] = ((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2),
                                   (2, 2, 2), (2, 2, 2))
    kernel_sizes: Tuple[Triple, ...] = ((3, 3, 3),) * 6
    n_conv_per_stage: int = 2
    deep_supervision: bool = True
    norm_eps: float = 1e-5
    negative_slope: float = 0.01
    block_type: str = "plain"             # "plain" | "residual"
    n_blocks_per_stage: Tuple[int, ...] = ()

    @property
    def n_stages(self) -> int:
        return len(self.features_per_stage)

    @staticmethod
    def tiny(num_classes: int = 2, in_channels: int = 1) -> "DynUNet3DConfig":
        return DynUNet3DConfig(in_channels=in_channels, num_classes=num_classes,
                               features_per_stage=(8, 16, 32),
                               strides=((1, 1, 1), (2, 2, 2), (1, 2, 2)),
                               kernel_sizes=((3, 3, 3),) * 3)


class InstanceNorm3D(nn.Module):
    """Affine per-sample, per-channel norm over (D, H, W), all in float32."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=(2, 3, 4), keepdim=True, correction=0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        w = self.weight.float()[:, None, None, None]
        b = self.bias.float()[:, None, None, None]
        return (y * w + b).to(x.dtype)


def _conv3d(cin, cout, kernel, stride=(1, 1, 1)):
    return nn.Conv3d(cin, cout, tuple(kernel), stride=tuple(stride),
                     padding=tuple(k // 2 for k in kernel))


class ConvBlock3D(nn.Module):
    def __init__(self, cin: int, features: int, kernel: Triple, stride: Triple,
                 cfg: DynUNet3DConfig):
        super().__init__()
        self.negative_slope = cfg.negative_slope
        self.conv = _conv3d(cin, features, kernel, stride)
        self.norm = InstanceNorm3D(features, cfg.norm_eps)

    def forward(self, x):
        return F.leaky_relu(self.norm(_conv(self.conv, x)), self.negative_slope)


class ResidualBlock3D(nn.Module):
    """3D BasicBlockD (``ldiffusion_tpu/models/dynunet3d.py:98-126``):
    conv(stride)-norm-lrelu → conv-norm, plus the input through a 1×1×1
    conv(stride) + norm when the shape changes; lrelu after the sum. The
    strided 1×1×1 conv is a 1×1×1 conv of the subsampled input (the same
    numbers; see ``models/dynunet.py:ResidualBlock``)."""

    def __init__(self, cin: int, features: int, kernel: Triple, stride: Triple,
                 cfg: DynUNet3DConfig):
        super().__init__()
        self.negative_slope = cfg.negative_slope
        self.conv1 = _conv3d(cin, features, kernel, stride)
        self.norm1 = InstanceNorm3D(features, cfg.norm_eps)
        self.conv2 = _conv3d(features, features, kernel)
        self.norm2 = InstanceNorm3D(features, cfg.norm_eps)
        self.stride = tuple(stride)
        self.projects = self.stride != (1, 1, 1) or cin != features
        if self.projects:
            self.downsample_conv = nn.Conv3d(cin, features, 1)
            self.downsample_norm = InstanceNorm3D(features, cfg.norm_eps)

    def forward(self, x):
        h = F.leaky_relu(self.norm1(_conv(self.conv1, x)), self.negative_slope)
        h = self.norm2(_conv(self.conv2, h))
        if self.projects:
            sd, sh, sw = self.stride
            x = self.downsample_norm(_conv(self.downsample_conv, x[:, :, ::sd, ::sh, ::sw]))
        return F.leaky_relu(h + x, self.negative_slope)


def _conv_transpose3d(conv: nn.ConvTranspose3d, x):
    if conv.weight.dtype == x.dtype:
        return conv(x)
    return F.conv_transpose3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                              conv.stride, conv.padding)


class DynUNet3D(nn.Module):
    def __init__(self, config: DynUNet3DConfig = DynUNet3DConfig(),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype = compute_dtype
        block = ResidualBlock3D if cfg.block_type == "residual" else ConvBlock3D
        self.blocks = encoder_blocks(cfg)
        cin = cfg.in_channels
        for s, feats in enumerate(cfg.features_per_stage):
            k = tuple(cfg.kernel_sizes[s])
            for c in range(self.blocks[s]):
                stride = tuple(cfg.strides[s]) if c == 0 else (1, 1, 1)
                self.add_module(f"enc_{s}_{c}", block(cin, feats, k, stride, cfg))
                cin = feats
        for d in range(cfg.n_stages - 2, -1, -1):
            feats = cfg.features_per_stage[d]
            stride = tuple(cfg.strides[d + 1])
            self.add_module(f"up_{d}", nn.ConvTranspose3d(cin, feats, stride, stride=stride))
            cin = 2 * feats
            k = tuple(cfg.kernel_sizes[d])
            for c in range(cfg.n_conv_per_stage):
                self.add_module(f"dec_{d}_{c}", ConvBlock3D(cin, feats, k, (1, 1, 1), cfg))
                cin = feats
            if cfg.deep_supervision or d == 0:
                self.add_module(f"seg_{d}", nn.Conv3d(feats, cfg.num_classes, 1))

    def forward(self, x, train: bool = False):
        """x: (B, C_in, D, H, W) → full-resolution logits (B, classes, D, H,
        W) float32; with ``train`` and deep supervision, every head's logits,
        highest resolution first."""
        cfg = self.config
        dtype = self.compute_dtype or self.seg_0.weight.dtype
        x = x.to(dtype).contiguous(memory_format=torch.channels_last_3d)
        skips = []
        for s in range(cfg.n_stages):
            for c in range(self.blocks[s]):
                x = getattr(self, f"enc_{s}_{c}")(x)
            skips.append(x)
        heads = []
        every_head = train and cfg.deep_supervision
        for d in range(cfg.n_stages - 2, -1, -1):
            x = torch.cat([_conv_transpose3d(getattr(self, f"up_{d}"), x), skips[d]], dim=1)
            for c in range(cfg.n_conv_per_stage):
                x = getattr(self, f"dec_{d}_{c}")(x)
            if every_head or d == 0:
                heads.append(_conv(getattr(self, f"seg_{d}"), x).float())
        return heads[::-1] if every_head else heads[-1]
