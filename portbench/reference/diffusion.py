"""The diffusion side of the reference: SD-v1.5's noise schedule, the PLMS
timesteps, the Laplace draw, the fixed prompt, the one-step transform
(tissue inference) and the stage-1 trajectory (L-Diffusion
``ldiffusion.py:121-295``), in plain PyTorch and NumPy."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# [bos, a, pathological, slide, eos]: "A pathological slide" under the CLIP vocabulary
PROMPT_IDS = (49406, 320, 29018, 10556, 49407)
GRAY = (0.2989, 0.5870, 0.1140)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
TRAIN_STEPS = 1000
STEPS_OFFSET = 1


def alphas_cumprod() -> np.ndarray:
    """SD v1.5's scaled-linear schedule: ᾱ in float64, stored as float32."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, TRAIN_STEPS, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas, dtype=np.float64).astype(np.float32)


def plms_timesteps(n: int):
    """PNDM with skip_prk_steps: n > 1 steps visit n + 1 timesteps (the
    second-to-last repeated). Returns (timesteps, step ratio)."""
    ratio = TRAIN_STEPS // n
    base = (np.arange(0, n) * ratio).round().astype(np.int64) + STEPS_OFFSET
    ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1] if n > 1 else base[::-1]
    return [int(t) for t in ts], ratio


def laplace_noise(shape, generator, device):
    """Laplace(0, 1) by the inverse CDF from one uniform draw."""
    u = torch.empty(shape, device=device, dtype=torch.float32)
    u.uniform_(-1.0 + torch.finfo(torch.float32).eps / 2, 1.0, generator=generator)
    return torch.sign(u) * torch.log1p(-u.abs())


def text_embedding(text, proj, batch: int):
    """The fixed prompt through the frozen text tower, then the trained projection."""
    ids = torch.tensor([PROMPT_IDS], dtype=torch.long, device=proj.weight.device)
    with torch.no_grad():
        hidden = text(ids)
    emb = proj(hidden)
    return emb.expand((batch,) + emb.shape[1:])


def normalise(images_u8):
    """(B, H, W, 3) uint8 → ImageNet-normalised float32."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def resize(x, size):
    """Bilinear, half-pixel centres, no antialias; NCHW."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=False)


def one_step_transform(unet, vae, emb, images):
    """images (B, H, W, 3) ImageNet-normalised → (B, H, W, 3) in [0, 1]:
    VAE mean latents (unscaled), one UNet pass at PNDM's single timestep,
    PNDM's first step from it, ``decode_latents``."""
    (t,), ratio = plms_timesteps(1)
    latents = vae.encode_mean(images.permute(0, 3, 1, 2))
    eps = unet(latents, t, emb)
    acp = alphas_cumprod()
    a_t, a_prev = acp[t], acp[0]  # the previous timestep is negative: ᾱ_0
    b_t, b_prev = np.float32(1.0) - a_t, np.float32(1.0) - a_prev
    coeff = np.sqrt(a_prev / a_t)
    denom = a_t * np.sqrt(b_prev) + np.sqrt(a_t * b_t * a_prev)
    prev = float(coeff) * latents - float(a_prev - a_t) * eps / float(denom)
    return vae.decode_latents(prev).permute(0, 2, 3, 1)


def trajectory(unet, vae, emb, images, noise, steps: int, remat: bool = True):
    """The stage-1 forward: at each PLMS timestep the clean latents plus
    Laplace noise × sqrt(1 − ᾱ_t) go through the UNet, whose output is
    decoded raw, resized to 64² and reduced to gray. Returns (grays
    (B, 64, 64, T), the last decode at 64² (B, 64, 64, 3)). ``remat``
    recomputes each timestep in the backward (the same values)."""
    ts, _ = plms_timesteps(steps)
    acp = alphas_cumprod()
    with torch.no_grad():
        latents = vae.encode_mean(images.permute(0, 3, 1, 2))

    def step(noisy, emb, t):
        rgb64 = resize(vae.decode(unet(noisy, t, emb)), (64, 64)).permute(0, 2, 3, 1)
        r, g, b = rgb64.unbind(-1)
        return r * GRAY[0] + g * GRAY[1] + b * GRAY[2], rgb64

    grays, rgb64 = [], None
    for t, eps in zip(ts, noise):
        scale = float(np.sqrt(np.float32(1.0) - acp[t]))
        noisy = latents + eps.permute(0, 3, 1, 2) * scale
        if remat:
            gray, rgb64 = checkpoint(step, noisy, emb, t, use_reentrant=False,
                                     preserve_rng_state=False)
        else:
            gray, rgb64 = step(noisy, emb, t)
        grays.append(gray)
    return torch.stack(grays, dim=-1), rgb64
