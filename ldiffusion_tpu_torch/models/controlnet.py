"""ControlNet of the multimodal (RGB-D) augment, counterpart of
``ldiffusion_tpu/models/controlnet.py``: a copy of the SD UNet's encoder
conditioned on an image (the depth map) through a small conv embedding, with
a 1×1 zero convolution after every down resnet/attention, every downsample
and the mid block. Its residuals feed
``UNet2DCondition(..., down_block_residuals=..., mid_residual=...)``.

The structure is the JAX module's, which is not diffusers'
``ControlNetModel``: each conditioning stage maps c_in → c_out and then
c_out → c_out with stride 2 (``cond_{i}_a``, ``cond_{i}_b``), where
diffusers maps c_in → c_in and then c_in → c_out, so no diffusers ControlNet
checkpoint fits either package; weights move between the two packages with
``models/convert.py:controlnet_from_flax`` / ``controlnet_to_flax``. The
Transformer2D blocks take GroupNorm's default 32 groups, not the config's
``norm_num_groups`` as the UNet's do (the JAX module builds them so).
Module names follow diffusers: ``controlnet_cond_embedding.{conv_in,
blocks.k, conv_out}``, ``controlnet_down_blocks.k``, ``controlnet_mid_block``.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ldiffusion_tpu_torch.models.convert import controlnet_rows
from ldiffusion_tpu_torch.models.layers import TimeEmbedding, name_quant_sites, timestep_embedding
from ldiffusion_tpu_torch.models.unet import (
    UNet2DConditionConfig,
    build_down_blocks,
    build_mid_block,
)

ATTN_GROUPS = 32  # the JAX ControlNet's Transformer2D default


class ConditioningEmbedding(nn.Module):
    """conv → SiLU, then per stage conv → SiLU → stride-2 conv → SiLU, then
    the (zero-initialised in JAX) ``conv_out`` to the UNet's first width."""

    def __init__(self, in_channels: int, channels: Tuple[int, ...], out_channels: int):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, channels[0], 3, padding=1)
        self.blocks = nn.ModuleList()
        for c_in, c_out in zip(channels[:-1], channels[1:]):
            self.blocks.append(nn.Conv2d(c_in, c_out, 3, padding=1))
            self.blocks.append(nn.Conv2d(c_out, c_out, 3, stride=2, padding=1))
        self.conv_out = nn.Conv2d(channels[-1], out_channels, 3, padding=1)

    def forward(self, c):
        c = F.silu(self.conv_in(c))
        for conv in self.blocks:
            c = F.silu(conv(c))
        return self.conv_out(c)


class ControlNet(nn.Module):
    def __init__(self, config: UNet2DConditionConfig = UNet2DConditionConfig(),
                 conditioning_channels: int = 3,
                 conditioning_embed_channels: Tuple[int, ...] = (16, 32, 96, 256)):
        super().__init__()
        self.config = cfg = config
        self.conditioning_embed_channels = tuple(conditioning_embed_channels)
        ch0 = cfg.block_out_channels[0]
        self.time_embedding = TimeEmbedding(ch0, ch0 * 4)
        self.controlnet_cond_embedding = ConditioningEmbedding(
            conditioning_channels, self.conditioning_embed_channels, ch0)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.down_blocks, skips = build_down_blocks(cfg, ATTN_GROUPS)
        self.mid_block = build_mid_block(cfg, ATTN_GROUPS)
        self.controlnet_down_blocks = nn.ModuleList([nn.Conv2d(c, c, 1) for c in skips])
        mid = cfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid, mid, 1)
        # the encoder's rows are the UNet's: one static scale dict serves both nets
        name_quant_sites(self, controlnet_rows(cfg, self.conditioning_embed_channels))

    def forward(self, sample, timesteps, encoder_hidden_states, controlnet_cond,
                conditioning_scale: float = 1.0):
        """sample: (B, 4, h, w) latents; controlnet_cond: (B, 3, 8h, 8w) the
        conditioning image. Returns (down-block residuals, one per UNet skip,
        and the mid residual), in the module's dtype."""
        dtype = self.conv_in.weight.dtype
        t = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        if t.shape[0] == 1 and sample.shape[0] > 1:
            t = t.expand(sample.shape[0])
        temb = self.time_embedding(
            timestep_embedding(t, self.config.block_out_channels[0]).to(dtype))
        ctx = encoder_hidden_states.to(dtype)
        cl = torch.channels_last
        c = self.controlnet_cond_embedding(controlnet_cond.to(dtype).contiguous(memory_format=cl))
        h = self.conv_in(sample.to(dtype).contiguous(memory_format=cl)) + c

        zero_convs = iter(self.controlnet_down_blocks)
        residuals = [next(zero_convs)(h)]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
                residuals.append(next(zero_convs)(h))
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                residuals.append(next(zero_convs)(h))

        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx)
        h = self.mid_block.resnets[1](h, temb)
        mid = self.controlnet_mid_block(h)
        return tuple(r * conditioning_scale for r in residuals), mid * conditioning_scale
