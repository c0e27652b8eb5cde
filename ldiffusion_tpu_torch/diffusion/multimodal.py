"""The depth-conditioned (ControlNet) multimodal augment, counterpart of
``ldiffusion_tpu/diffusion/multimodal.py`` (reference
``ldiffusion_augment_for_multimodal``, ``segmentor.py:301-386``).

The whole batch in one call: the RGB is VAE-encoded as a draw of the latent
distribution (×0.18215), Laplace(0, 1) noise scaled by the depth map resized
to the latent grid is added, the ControlNet runs on the depth map (three
channels) and the UNet predicts the noise with its residuals at the PNDM
``set_timesteps(1)`` timestep, the latents are de-noised linearly
(``noisy − eps · depth``) and decoded (÷0.18215) by the raw VAE decode.

Both draws (the encode's standard normal and the Laplace noise) are
arguments or come, in that order, from one ``torch.Generator``; the JAX
package draws them from ``split(key)`` (tests hand its draws in).
"""
from __future__ import annotations

from typing import Optional

import torch

from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents, apply_proj
from ldiffusion_tpu_torch.diffusion.schedulers import laplace_noise
from ldiffusion_tpu_torch.models.controlnet import ControlNet
from ldiffusion_tpu_torch.ops.resize import resize_bilinear

DEFAULT_MM_PROMPT_IDS = (49406, 320, 6613, 1063, 533, 49407)  # "a remote sense image"


def multimodal_augment(components: SDComponents, controlnet: ControlNet, rgb, dtm,
                       generator: Optional[torch.Generator] = None, enc_noise=None, noise=None,
                       prompt_ids=DEFAULT_MM_PROMPT_IDS):
    """rgb: (B, H, W, 3) in [0, 1]; dtm: (B, H, W, 1) in [0, 1]; ``enc_noise``
    (standard normal) and ``noise`` (unit Laplace): (B, H/8, W/8, 4) each, or
    None to draw them from ``generator``. Returns the reconstructed images
    (B, H, W, 3), float32."""
    sf = components.vae_config.scaling_factor
    b = rgb.shape[0]
    ids = torch.tensor([list(prompt_ids)] * b, dtype=torch.long, device=components.device)
    emb = apply_proj(components.proj, components.text(ids))

    x = (rgb * 2.0 - 1.0).permute(0, 3, 1, 2)
    if enc_noise is not None:
        enc_noise = enc_noise.permute(0, 3, 1, 2)
    latents = components.vae.encode_sample(x, enc_noise, generator) * sf
    c, lh, lw = latents.shape[1:]
    depth_lat = resize_bilinear(dtm, (lh, lw)).permute(0, 3, 1, 2).expand(-1, c, -1, -1)
    if noise is None:
        noise = laplace_noise(latents.shape, generator, latents.device, latents.dtype)
    else:
        noise = noise.permute(0, 3, 1, 2).to(latents.dtype)
    noisy = latents + noise * depth_lat

    t = components.scheduler.set_timesteps(1).values[0]
    depth_cond = dtm.permute(0, 3, 1, 2).expand(-1, 3, -1, -1)
    down_res, mid_res = controlnet(noisy, t, emb, depth_cond)
    eps = components.unet(noisy, t, emb, down_block_residuals=down_res, mid_residual=mid_res)
    denoised = noisy - eps * depth_lat
    return components.vae.decode(denoised / sf).permute(0, 2, 3, 1)
