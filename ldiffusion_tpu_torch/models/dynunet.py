"""nnU-Net-style 2D UNet, counterpart of ``ldiffusion_tpu/models/dynunet.py``:
per stage [conv3x3 → norm → LeakyReLU(0.01)] × n, strided-conv downsampling,
transpose-conv upsampling with skip concat, 1x1 segmentation heads at every
decoder stage (deep supervision). Submodule names follow the flax tree
(``enc_{s}_{c}``, ``up_{d}``, ``dec_{d}_{c}``, ``seg_{d}``).

``norm="instance"`` (nnU-Net's) or ``"batch"`` (nnUNetTrainerBN);
``block_type="residual"`` makes the encoder stages BasicBlockD residual
blocks (ResidualEncoderUNet, the ResEnc planners; ``n_blocks_per_stage``,
the ResEnc-M schedule by default); the decoder stays plain.

``forward(x)`` (inference) returns the full-resolution logits only; with
``train=True`` and deep supervision it returns every head's logits, highest
resolution first, as ``ldiffusion_tpu/models/dynunet.py:198-217`` does.
``compute_dtype`` (e.g. bfloat16) runs the convolutions and norms in that
dtype over parameters kept in theirs (float32 masters), as flax's
``dtype``/``param_dtype`` split does; None computes in the parameters' dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ldiffusion_tpu_torch.core.dist import all_reduce_sum


@dataclasses.dataclass(frozen=True)
class DynUNetConfig:
    in_channels: int = 3
    num_classes: int = 7
    features_per_stage: Tuple[int, ...] = (32, 64, 128, 256, 512, 512, 512)
    strides: Tuple[int, ...] = (1, 2, 2, 2, 2, 2, 2)
    n_conv_per_stage: int = 2
    kernel_size: int = 3
    deep_supervision: bool = True
    norm_eps: float = 1e-5
    negative_slope: float = 0.01
    norm: str = "instance"
    block_type: str = "plain"
    n_blocks_per_stage: Tuple[int, ...] = ()

    @property
    def n_stages(self) -> int:
        return len(self.features_per_stage)

    @staticmethod
    def tiny(num_classes: int = 7) -> "DynUNetConfig":
        return DynUNetConfig(num_classes=num_classes, features_per_stage=(8, 16, 32),
                             strides=(1, 2, 2))


class InstanceNorm(nn.Module):
    """Affine per-sample, per-channel spatial norm. Statistics in float32,
    the normalisation in the compute dtype (as the reference's AMP regime)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, train: bool = False):
        var, mean = torch.var_mean(x.float(), dim=(2, 3), keepdim=True, correction=0)
        rstd = torch.rsqrt(var + self.eps)
        y = (x - mean.to(x.dtype)) * rstd.to(x.dtype)
        return y * self.weight.to(y.dtype)[:, None, None] + self.bias.to(y.dtype)[:, None, None]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` (torch's momentum 0.1): in training
    the batch's statistics normalise and are folded into the running ones,
    with the biased variance, as flax does (``nn.BatchNorm2d`` folds in the
    unbiased one); in evaluation the running statistics normalise. Statistics
    and the normalisation in float32, the output in x's dtype.

    ``group`` (``set_norm_group``): the training statistics are the global
    batch's over the group's ranks, as the JAX trainer's pjit gives them
    (the reference's SyncBatchNorm). Each rank's ``var_mean`` is merged by
    Chan's rule, all-reduced with autograd (``core.dist.all_reduce_sum``):
    the global mean Σ n·mean / N, then the variance Σ n·(var + (mean −
    global mean)²) / N. So the running statistics stay equal on every rank,
    and a group of one rank gives ``var_mean``'s numbers (exactly when the
    count is a power of two). Not ``nn.SyncBatchNorm``: it folds in the
    unbiased variance."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.group = None
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = False):
        xf = x.float()
        if train:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            if self.group is not None:  # Chan's merge of the ranks' (n, mean, var)
                n = torch.full((1,), xf.numel() / xf.shape[1], device=xf.device)
                sums = all_reduce_sum(torch.cat([mean * n, n]), self.group)
                mean_g = sums[:-1] / sums[-1]
                var = all_reduce_sum(n * (var + (mean - mean_g) ** 2), self.group) / sums[-1]
                mean = mean_g
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
        else:
            var, mean = self.running_var, self.running_mean
        scale = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean[:, None, None]) * scale[:, None, None] + self.bias.float()[:, None, None]
        return y.to(x.dtype)


def set_norm_group(net: nn.Module, group) -> nn.Module:
    """Give every ``BatchNorm`` of ``net`` the process group its training
    statistics are reduced over (None: this process's batch)."""
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return net


def _norm(cfg: "DynUNetConfig", channels: int) -> nn.Module:
    if cfg.norm == "batch":
        return BatchNorm(channels, cfg.norm_eps)
    if cfg.norm != "instance":
        raise ValueError(f"norm={cfg.norm!r}: use 'instance' or 'batch'")
    return InstanceNorm(channels, cfg.norm_eps)


def _conv(conv: nn.Module, x):
    """``conv(x)`` with the weights cast to x's dtype when they differ."""
    if conv.weight.dtype == x.dtype:
        return conv(x)
    return conv._conv_forward(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))


def _conv_transpose(conv: nn.ConvTranspose2d, x):
    if conv.weight.dtype == x.dtype:
        return conv(x)
    return F.conv_transpose2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                              conv.stride, conv.padding)


class ConvBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int, cfg: DynUNetConfig):
        super().__init__()
        k = cfg.kernel_size
        self.negative_slope = cfg.negative_slope
        self.conv = nn.Conv2d(in_channels, features, k, stride=stride, padding=k // 2)
        self.norm = _norm(cfg, features)

    def forward(self, x, train: bool = False):
        return F.leaky_relu(self.norm(_conv(self.conv, x), train), self.negative_slope)


class ResidualBlock(nn.Module):
    """BasicBlockD (``ldiffusion_tpu/models/dynunet.py:121-153``):
    conv(stride)-norm-lrelu → conv-norm, plus the input, through a 1x1
    conv(stride) + norm when the shape changes; lrelu after the sum. The
    strided 1x1 conv is computed as a 1x1 conv of the subsampled input (the
    same numbers): PyTorch's CPU backward of a strided 1x1 conv over a
    channels-last input corrupts the heap now and then."""

    def __init__(self, in_channels: int, features: int, stride: int, cfg: DynUNetConfig):
        super().__init__()
        k = cfg.kernel_size
        self.negative_slope = cfg.negative_slope
        self.conv1 = nn.Conv2d(in_channels, features, k, stride=stride, padding=k // 2)
        self.norm1 = _norm(cfg, features)
        self.conv2 = nn.Conv2d(features, features, k, padding=k // 2)
        self.norm2 = _norm(cfg, features)
        self.stride = stride
        self.projects = stride != 1 or in_channels != features
        if self.projects:
            self.downsample_conv = nn.Conv2d(in_channels, features, 1)
            self.downsample_norm = _norm(cfg, features)

    def forward(self, x, train: bool = False):
        h = F.leaky_relu(self.norm1(_conv(self.conv1, x), train), self.negative_slope)
        h = self.norm2(_conv(self.conv2, h), train)
        if self.projects:
            s = self.stride
            x = self.downsample_norm(_conv(self.downsample_conv, x[:, :, ::s, ::s]), train)
        return F.leaky_relu(h + x, self.negative_slope)


# ResEnc-M encoder blocks a stage (nnUNetPlannerResEncM)
RESENC_M_BLOCKS = (1, 3, 4, 6, 6, 6, 6)


def encoder_blocks(cfg) -> Tuple[int, ...]:
    """Blocks a stage: ``n_conv_per_stage`` conv blocks (plain), or the
    residual blocks of ``n_blocks_per_stage`` (the ResEnc-M schedule when
    empty)."""
    if cfg.block_type == "plain":
        return (cfg.n_conv_per_stage,) * cfg.n_stages
    if cfg.block_type != "residual":
        raise ValueError(f"block_type={cfg.block_type!r}: use 'plain' or 'residual'")
    return tuple(cfg.n_blocks_per_stage or RESENC_M_BLOCKS[:cfg.n_stages])


class DynUNet(nn.Module):
    def __init__(self, config: DynUNetConfig = DynUNetConfig(),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = cfg = config
        self.compute_dtype = compute_dtype
        cin = cfg.in_channels
        block = ResidualBlock if cfg.block_type == "residual" else ConvBlock
        self.blocks = encoder_blocks(cfg)
        for s, feats in enumerate(cfg.features_per_stage):
            for c in range(self.blocks[s]):
                self.add_module(f"enc_{s}_{c}", block(
                    cin, feats, cfg.strides[s] if c == 0 else 1, cfg))
                cin = feats
        for d in range(cfg.n_stages - 2, -1, -1):
            feats = cfg.features_per_stage[d]
            stride = cfg.strides[d + 1]
            self.add_module(f"up_{d}", nn.ConvTranspose2d(cin, feats, stride, stride=stride))
            cin = 2 * feats
            for c in range(cfg.n_conv_per_stage):
                self.add_module(f"dec_{d}_{c}", ConvBlock(cin, feats, 1, cfg))
                cin = feats
            if cfg.deep_supervision or d == 0:
                self.add_module(f"seg_{d}", nn.Conv2d(feats, cfg.num_classes, 1))

    def forward(self, x, train: bool = False):
        """x: (B, C_in, H, W) → full-resolution logits (B, classes, H, W)
        float32; with ``train`` and deep supervision, the list of every
        head's logits, highest resolution first. ``train`` also makes
        BatchNorm layers normalise with the batch and update their running
        statistics, as flax's ``train``."""
        cfg = self.config
        dtype = self.compute_dtype or self.seg_0.weight.dtype
        x = x.to(dtype).contiguous(memory_format=torch.channels_last)
        skips = []
        for s in range(cfg.n_stages):
            for c in range(self.blocks[s]):
                x = getattr(self, f"enc_{s}_{c}")(x, train)
            skips.append(x)
        heads = []
        every_head = train and cfg.deep_supervision
        for d in range(cfg.n_stages - 2, -1, -1):
            x = torch.cat([_conv_transpose(getattr(self, f"up_{d}"), x), skips[d]], dim=1)
            for c in range(cfg.n_conv_per_stage):
                x = getattr(self, f"dec_{d}_{c}")(x, train)
            if every_head or d == 0:
                heads.append(_conv(getattr(self, f"seg_{d}"), x).float())
        return heads[::-1] if every_head else heads[-1]
