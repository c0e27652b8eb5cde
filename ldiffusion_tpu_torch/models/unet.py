"""SD v1.5 UNet2DCondition, counterpart of ``ldiffusion_tpu/models/unet.py``,
with diffusers' module tree and state-dict names (``down_blocks.i.resnets.j``,
``...attentions.j``, ``mid_block``, ``up_blocks``...).

Quirk kept: ``attention_head_dim`` is the NUMBER of heads (SD v1.5 config);
the head size is channels // heads.
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Tuple

import torch
from torch import nn

from ldiffusion_tpu_torch.models.layers import (
    Downsample,
    FusedGroupNormSiLU,
    ResnetBlock,
    TimeEmbedding,
    Transformer2D,
    Upsample,
    name_quant_sites,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNet2DConditionConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8  # SD v1.5: number of heads; head size = ch // heads
    norm_num_groups: int = 32
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")

    @staticmethod
    def sd15() -> "UNet2DConditionConfig":
        return UNet2DConditionConfig()

    @staticmethod
    def tiny(cross_attention_dim: int = 32) -> "UNet2DConditionConfig":
        return UNet2DConditionConfig(
            block_out_channels=(32, 64), layers_per_block=1,
            cross_attention_dim=cross_attention_dim, attention_head_dim=2,
            norm_num_groups=8, down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))


class _Block(nn.Module):
    """A down/up block: ``resnets``, optional ``attentions`` and
    ``downsamplers``/``upsamplers`` lists, as in diffusers."""


def build_down_blocks(cfg: UNet2DConditionConfig, attn_groups: int):
    """The down path's blocks (diffusers names) and the channels of each skip
    they leave, ``conv_in``'s first. ``attn_groups``: the Transformer2D
    GroupNorm's groups (the UNet's ``norm_num_groups``; the ControlNet's
    default 32)."""
    ch0 = cfg.block_out_channels[0]
    heads, tdim = cfg.attention_head_dim, ch0 * 4
    skips = [ch0]
    blocks = nn.ModuleList()
    cin = ch0
    for i, (btype, ch) in enumerate(zip(cfg.down_block_types, cfg.block_out_channels)):
        blk = _Block()
        blk.resnets = nn.ModuleList()
        if btype == "CrossAttnDownBlock2D":
            blk.attentions = nn.ModuleList()
        for _ in range(cfg.layers_per_block):
            blk.resnets.append(ResnetBlock(cin, ch, groups=cfg.norm_num_groups,
                                           temb_channels=tdim))
            if btype == "CrossAttnDownBlock2D":
                blk.attentions.append(Transformer2D(ch, heads, ch // heads,
                                                    cfg.cross_attention_dim,
                                                    groups=attn_groups))
            cin = ch
            skips.append(ch)
        if i < len(cfg.block_out_channels) - 1:
            blk.downsamplers = nn.ModuleList([Downsample(ch)])
            skips.append(ch)
        blocks.append(blk)
    return blocks, skips


def build_mid_block(cfg: UNet2DConditionConfig, attn_groups: int) -> nn.Module:
    mid, tdim = cfg.block_out_channels[-1], cfg.block_out_channels[0] * 4
    heads = cfg.attention_head_dim
    blk = _Block()
    blk.resnets = nn.ModuleList(
        [ResnetBlock(mid, mid, groups=cfg.norm_num_groups, temb_channels=tdim)
         for _ in range(2)])
    blk.attentions = nn.ModuleList(
        [Transformer2D(mid, heads, mid // heads, cfg.cross_attention_dim, groups=attn_groups)])
    return blk


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNet2DConditionConfig = UNet2DConditionConfig()):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        heads, groups, ctx = cfg.attention_head_dim, cfg.norm_num_groups, cfg.cross_attention_dim
        tdim = ch0 * 4
        n = len(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimeEmbedding(ch0, tdim)

        self.down_blocks, skips = build_down_blocks(cfg, groups)
        self.mid_block = build_mid_block(cfg, groups)

        self.up_blocks = nn.ModuleList()
        h_ch = cfg.block_out_channels[-1]
        for i, (btype, ch) in enumerate(zip(cfg.up_block_types,
                                            reversed(cfg.block_out_channels))):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            if btype == "CrossAttnUpBlock2D":
                blk.attentions = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(h_ch + skips.pop(), ch, groups=groups,
                                               temb_channels=tdim))
                if btype == "CrossAttnUpBlock2D":
                    blk.attentions.append(Transformer2D(ch, heads, ch // heads, ctx,
                                                        groups=groups))
                h_ch = ch
            if i < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = FusedGroupNormSiLU(ch0, groups, 1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)
        from ldiffusion_tpu_torch.models.convert import unet_rows  # convert imports this module

        name_quant_sites(self, unet_rows(cfg))

    def forward(self, sample, timesteps, encoder_hidden_states, down_block_residuals=None,
                mid_residual=None):
        """sample: (B, C_in, H, W) latents; timesteps: int, () or (B,);
        encoder_hidden_states: (B, S_text, cross_attention_dim).
        ``down_block_residuals`` / ``mid_residual``: a ControlNet's residuals,
        added to the skip list after the down path and to the mid block's
        output (diffusers' ``down_block_additional_residuals``).
        Returns the epsilon prediction (B, C_out, H, W), float32."""
        dtype = self.conv_in.weight.dtype
        if isinstance(timesteps, torch.Tensor):
            t = timesteps.to(sample.device).reshape(-1)
        elif isinstance(timesteps, numbers.Number):
            # a host number is filled in on the device: no host-to-device
            # copy, which a captured program could not hold
            t = torch.full((1,), timesteps, dtype=torch.as_tensor(timesteps).dtype,
                           device=sample.device)
        else:
            t = torch.as_tensor(timesteps, device=sample.device).reshape(-1)
        if t.shape[0] == 1 and sample.shape[0] > 1:
            t = t.expand(sample.shape[0])
        temb = self.time_embedding(
            timestep_embedding(t, self.config.block_out_channels[0]).to(dtype))
        ctx = encoder_hidden_states.to(dtype)
        h = self.conv_in(sample.to(dtype).contiguous(memory_format=torch.channels_last))

        residuals = [h]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(h, temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
                residuals.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                residuals.append(h)
        if down_block_residuals is not None:
            residuals = [r + extra.to(r.dtype) for r, extra in zip(residuals, down_block_residuals)]

        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx)
        h = self.mid_block.resnets[1](h, temb)
        if mid_residual is not None:
            h = h + mid_residual.to(h.dtype)

        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, residuals.pop()], dim=1), temb)
                if hasattr(blk, "attentions"):
                    h = blk.attentions[j](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        return self.conv_out(self.conv_norm_out(h)).float()
