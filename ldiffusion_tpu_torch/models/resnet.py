"""Bottleneck ResNet trunk (ResNet-152 by default), counterpart of
``ldiffusion_tpu/models/resnet.py``: ``torchvision.models.resnet152`` up to
its last conv stage, the frozen patch encoder of the cell classifier
(reference ``model/conductor.py:144-145``: ``children()[:-2]``).

Module names are torchvision's (``conv1``, ``bn1``, ``layer{i}.{j}.conv{1,2,3}``
/ ``bn{1,2,3}`` / ``downsample.{0,1}``), so a torchvision state dict without
its ``fc.*`` entries loads with ``load_state_dict``; ``models/convert.py``'s
``resnet_from_flax`` / ``resnet_to_flax`` convert from and to the JAX
encoder's ``{"params", "batch_stats"}``. BatchNorm is eps 1e-5 and the trunk
is built in eval mode (running statistics). Input (B, 3, H, W), output
(B, 2048, H/32, W/32) at ResNet-50/152 width.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 8, 36, 3)  # resnet152
    width: int = 64

    @staticmethod
    def resnet50() -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(3, 4, 6, 3))

    @staticmethod
    def resnet152() -> "ResNetConfig":
        return ResNetConfig()

    @staticmethod
    def tiny() -> "ResNetConfig":
        return ResNetConfig(stage_sizes=(1, 1), width=8)

    @property
    def out_channels(self) -> int:
        """Channels of the last stage: width · 2^(stages − 1) · 4 (bottleneck)."""
        return self.width * 2 ** (len(self.stage_sizes) - 1) * 4


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int):
        super().__init__()
        out = features * 4
        self.conv1 = nn.Conv2d(in_channels, features, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(features, eps=1e-5)
        self.conv3 = nn.Conv2d(features, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=1e-5)
        self.downsample = None
        if in_channels != out or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_channels, out, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out, eps=1e-5))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNetEncoder(nn.Module):
    """Stem (7×7/2 conv, BN, ReLU, 3×3/2 max pool, padding 1) + the stages."""

    def __init__(self, config: ResNetConfig = ResNetConfig()):
        super().__init__()
        self.config = config
        self.conv1 = nn.Conv2d(3, config.width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(config.width, eps=1e-5)
        cin = config.width
        for i, n_blocks in enumerate(config.stage_sizes):
            feats = config.width * 2 ** i
            blocks = []
            for j in range(n_blocks):
                blocks.append(Bottleneck(cin, feats, 2 if (j == 0 and i > 0) else 1))
                cin = feats * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.eval()

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i in range(len(self.config.stage_sizes)):
            x = getattr(self, f"layer{i + 1}")(x)
        return x
