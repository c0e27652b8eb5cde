"""Attention-decorated segmentation nets, counterpart of
``ldiffusion_tpu/models/conductor.py`` (reference ``model/conductor.py``):
``CBAM`` (channel and spatial attention), ``ASPP`` (atrous pyramid plus a
global branch), the ConvNeXt-Tiny backbone, ``TissueSegNet`` (backbone →
CBAM → ASPP → conv decoder → bilinear upsample) and
``TissueSegWithDepthHeatmap`` (the RGB-D net with a heatmap head). Nothing
in either package calls them; they are kept for component parity.

Modules take NCHW tensors and carry the JAX modules' names, so
``models/convert.py`` maps them one to one. Flax's conventions are kept:
LayerNorm eps 1e-6 over the channels, the tanh-approximated GELU, BatchNorm
with flax's momentum 0.9 and biased variance (``dynunet.BatchNorm``), one
MLP shared by the channel gate's average and max paths, the ASPP's global
branch broadcast (not upsampled), dropout 0.5 after the ASPP projection in
training only. ``train`` is an argument, as flax's: it makes BatchNorm
normalise with the batch and fold it into the running statistics, and turns
the dropout on. No torchvision weight conversion exists in either package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ldiffusion_tpu_torch.models.dynunet import BatchNorm
from ldiffusion_tpu_torch.ops.resize import resize_bilinear

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


class BasicConv(nn.Module):
    """Conv (no bias) → BatchNorm → ReLU."""

    def __init__(self, in_channels: int, features: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features, kernel_size, stride=stride, padding=padding,
                              dilation=dilation, bias=False)
        self.bn = BatchNorm(features, 1e-5)

    def forward(self, x, train: bool = False):
        return F.relu(self.bn(self.conv(x), train))


class ChannelAttention(nn.Module):
    """sigmoid(mlp(avg) + mlp(max)) over the spatial average and maximum."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // ratio, bias=False)
        self.fc2 = nn.Linear(channels // ratio, channels, bias=False)

    def forward(self, x):
        def mlp(v):
            return self.fc2(F.relu(self.fc1(v)))

        gate = torch.sigmoid(mlp(x.mean(dim=(2, 3))) + mlp(x.amax(dim=(2, 3))))
        return gate[:, :, None, None]


class SpatialAttention(nn.Module):
    """sigmoid(conv([channel mean | channel max]))."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel_size, padding=(kernel_size - 1) // 2, bias=False)

    def forward(self, x):
        cat = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv(cat))


class CBAM(nn.Module):
    def __init__(self, channels: int, ratio: int = 16, kernel_size: int = 7):
        super().__init__()
        self.channel_att = ChannelAttention(channels, ratio)
        self.spatial_att = SpatialAttention(kernel_size)

    def forward(self, x):
        x = x * self.channel_att(x)
        return x * self.spatial_att(x)


class ASPP(nn.Module):
    """Atrous branches (dilations 1, 6, 12, 18) and a global-average branch,
    concatenated, projected 1×1, dropout 0.5 in training."""

    def __init__(self, in_channels: int, out_channels: int = 256,
                 dilations: Tuple[int, ...] = (1, 6, 12, 18)):
        super().__init__()
        for i, d in enumerate(dilations):
            if d == 1:
                branch = BasicConv(in_channels, out_channels, 1)
            else:
                branch = BasicConv(in_channels, out_channels, 3, padding=d, dilation=d)
            self.add_module(f"branch_{i}", branch)
        self.n_branches = len(dilations)
        self.global_branch = BasicConv(in_channels, out_channels, 1)
        self.project = BasicConv(out_channels * (len(dilations) + 1), out_channels, 1)
        self.dropout = 0.5

    def forward(self, x, train: bool = False):
        outs = [getattr(self, f"branch_{i}")(x, train) for i in range(self.n_branches)]
        g = self.global_branch(x.mean(dim=(2, 3), keepdim=True), train)
        outs.append(g.expand(-1, -1, *x.shape[2:]))
        out = self.project(torch.cat(outs, dim=1), train)
        return F.dropout(out, self.dropout, training=train)


def _layer_norm(x, norm: nn.LayerNorm):
    """LayerNorm over the channels of an NCHW tensor."""
    y = F.layer_norm(x.permute(0, 2, 3, 1), norm.normalized_shape, norm.weight, norm.bias,
                     norm.eps)
    return y.permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.pwconv1 = nn.Linear(dim, dim * 4)
        self.pwconv2 = nn.Linear(dim * 4, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        h = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        h = self.pwconv2(F.gelu(self.pwconv1(h), approximate="tanh")) * self.gamma
        return x + h.permute(0, 3, 1, 2)


class ConvNeXtTiny(nn.Module):
    """Stages (3, 3, 9, 3) × dims (96, 192, 384, 768): (B, 3, H, W) →
    (B, 768, H/32, W/32)."""

    def __init__(self, dims: Tuple[int, ...] = (96, 192, 384, 768),
                 depths: Tuple[int, ...] = (3, 3, 9, 3)):
        super().__init__()
        self.depths = tuple(depths)
        self.stem_conv = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = nn.LayerNorm(dims[0], eps=LAYER_NORM_EPS)
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            if i > 0:
                self.add_module(f"down_{i}_norm", nn.LayerNorm(dims[i - 1], eps=LAYER_NORM_EPS))
                self.add_module(f"down_{i}_conv", nn.Conv2d(dims[i - 1], dim, 2, stride=2))
            for j in range(depth):
                self.add_module(f"stage_{i}_block_{j}", ConvNeXtBlock(dim))

    def forward(self, x):
        x = _layer_norm(self.stem_conv(x), self.stem_norm)
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = getattr(self, f"down_{i}_conv")(_layer_norm(x, getattr(self, f"down_{i}_norm")))
            for j in range(depth):
                x = getattr(self, f"stage_{i}_block_{j}")(x)
        return x


@dataclasses.dataclass(frozen=True)
class TissueSegNetConfig:
    num_classes: int = 7
    backbone_dims: Tuple[int, ...] = (96, 192, 384, 768)
    backbone_depths: Tuple[int, ...] = (3, 3, 9, 3)

    @staticmethod
    def tiny(num_classes: int = 7) -> "TissueSegNetConfig":
        return TissueSegNetConfig(num_classes=num_classes, backbone_dims=(8, 16, 32, 32),
                                  backbone_depths=(1, 1, 1, 1))


class TissueSegNet(nn.Module):
    """ConvNeXt → CBAM → ASPP → 3×3 BasicConv → 1×1 conv → bilinear to the
    input's size; returns {"out": (B, classes, H, W) float32}."""

    def __init__(self, config: TissueSegNetConfig = TissueSegNetConfig()):
        super().__init__()
        self.config = cfg = config
        top = cfg.backbone_dims[-1]
        width = min(256, top * 2)
        self.backbone = ConvNeXtTiny(cfg.backbone_dims, cfg.backbone_depths)
        self.cbam = CBAM(top, ratio=min(16, top))
        self.aspp = ASPP(top, width)
        self.decoder_conv = BasicConv(width, width, 3, padding=1)
        self.decoder_out = nn.Conv2d(width, cfg.num_classes, 1)

    def forward(self, x, train: bool = False):
        feat = self.aspp(self.cbam(self.backbone(x)), train)
        out = self.decoder_out(self.decoder_conv(feat, train))
        return {"out": resize_bilinear(out.float(), x.shape[2:], channel_last=False)}


DEPTH_WIDTHS = (64, 128, 256, 512)


class TissueSegWithDepthHeatmap(nn.Module):
    """RGB-D segmentation with a heatmap head: a ConvNeXt on the RGB, four
    stride-2 BasicConvs on the depth, fused into a heatmap; CBAM + ASPP on
    the RGB features with the heatmap appended, decoded. Returns {"seg",
    "heatmap"}, each (B, classes, H, W) float32."""

    def __init__(self, num_classes: int, backbone_dims: Tuple[int, ...] = (96, 192, 384, 768),
                 backbone_depths: Tuple[int, ...] = (3, 3, 9, 3)):
        super().__init__()
        top = backbone_dims[-1]
        width = min(256, top * 2)
        self.rgb_backbone = ConvNeXtTiny(backbone_dims, backbone_depths)
        cin = 1
        for i, ch in enumerate(DEPTH_WIDTHS):
            self.add_module(f"depth_{i}", BasicConv(cin, ch, 7 if i == 0 else 3, stride=2,
                                                    padding=3 if i == 0 else 1))
            cin = ch
        self.depth_proj = BasicConv(cin, top, 1)
        self.hm_0 = BasicConv(2 * top, 512, 3, padding=1)
        self.hm_1 = BasicConv(512, 256, 3, padding=1)
        self.hm_out = nn.Conv2d(256, num_classes, 1)
        self.cbam = CBAM(top, ratio=min(16, top))
        self.aspp = ASPP(top, width)
        self.dec_0 = BasicConv(width + num_classes, 256, 3, padding=1)
        self.dec_1 = BasicConv(256, 256, 3, padding=1)
        self.dec_out = nn.Conv2d(256, num_classes, 1)

    def forward(self, rgb, depth, train: bool = False):
        rgb_feat = self.rgb_backbone(rgb)
        d = depth
        for i in range(len(DEPTH_WIDTHS)):
            d = getattr(self, f"depth_{i}")(d, train)
        d = self.depth_proj(d, train)
        if d.shape[2:] != rgb_feat.shape[2:]:
            d = resize_bilinear(d, rgb_feat.shape[2:], channel_last=False)
        hm = self.hm_1(self.hm_0(torch.cat([rgb_feat, d], dim=1), train), train)
        heatmap = self.hm_out(hm)
        size = rgb.shape[2:]
        seg = self.aspp(self.cbam(rgb_feat), train)
        seg = self.dec_1(self.dec_0(torch.cat([seg, heatmap], dim=1), train), train)
        seg = self.dec_out(seg)
        return {"seg": resize_bilinear(seg.float(), size, channel_last=False),
                "heatmap": resize_bilinear(heatmap.float(), size, channel_last=False)}
