"""SD v1.5 VAE (AutoencoderKL), counterpart of ``ldiffusion_tpu/models/vae.py``,
with diffusers' state-dict names. ``encode_mean`` is the deterministic encode
the pipeline uses, ``encode_sample`` the multimodal augment's draw;
``decode_latents`` divides by the scaling factor 0.18215 and maps to [0, 1]
while ``decode`` does not — the reference mixes the two and the fine-tuned
UNet is trained around that convention."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ldiffusion_tpu_torch.models.layers import (
    Downsample,
    FusedGroupNormSiLU,
    ResnetBlock,
    Upsample,
    VAEAttention,
    name_quant_sites,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @staticmethod
    def sd15() -> "VAEConfig":
        return VAEConfig()

    @staticmethod
    def tiny() -> "VAEConfig":
        return VAEConfig(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8)


class _Block(nn.Module):
    pass


def _mid_block(ch: int, groups: int) -> nn.Module:
    mid = _Block()
    mid.resnets = nn.ModuleList([ResnetBlock(ch, ch, 1e-6, groups) for _ in range(2)])
    mid.attentions = nn.ModuleList([VAEAttention(ch, groups)])
    return mid


def _run_mid(mid, h):
    h = mid.resnets[0](h)
    h = mid.attentions[0](h)
    return mid.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        cin = chans[0]
        for i, ch in enumerate(chans):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock(cin, ch, 1e-6, g))
                cin = ch
            if i < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch, asymmetric_pad=True)])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(chans[-1], g)
        self.conv_norm_out = FusedGroupNormSiLU(chans[-1], g, 1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        chans, g = cfg.block_out_channels, cfg.norm_num_groups
        rev = list(reversed(chans))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _mid_block(rev[0], g)
        self.up_blocks = nn.ModuleList()
        cin = rev[0]
        for i, ch in enumerate(rev):
            blk = _Block()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock(cin, ch, 1e-6, g))
                cin = ch
            if i < len(rev) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = FusedGroupNormSiLU(chans[0], g, 1e-6)
        self.conv_out = nn.Conv2d(chans[0], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)
        from ldiffusion_tpu_torch.models.convert import vae_rows  # convert imports this module

        name_quant_sites(self, vae_rows(config))

    def _in(self, x):
        return x.to(self.quant_conv.weight.dtype).contiguous(memory_format=torch.channels_last)

    def encode_moments(self, x):
        """x: (B, 3, H, W) → (mean, logvar), each (B, 4, H/8, W/8) float32."""
        moments = self.quant_conv(self.encoder(self._in(x)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean.float(), logvar.clamp(-30.0, 20.0).float()

    def encode_mean(self, x):
        return self.encode_moments(x)[0]

    def encode_sample(self, x, noise=None, generator=None):
        """A draw of the latent distribution, mean + std·ε: ``noise`` is the
        standard-normal ε of the latents' shape (B, 4, H/8, W/8), else drawn
        from ``generator``."""
        mean, logvar = self.encode_moments(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.device, mean.dtype)

    def decode(self, z):
        """Raw decode: latents → image in [-1, 1], float32."""
        return self.decoder(self.post_quant_conv(self._in(z))).float()

    def decode_latents(self, z):
        """diffusers ``decode_latents``: unscale by 0.18215, decode, map to [0, 1]."""
        img = self.decode(z / self.config.scaling_factor)
        return (img / 2.0 + 0.5).clamp(0.0, 1.0)
