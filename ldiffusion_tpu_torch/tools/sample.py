"""Save the decoded image at every reverse step, counterpart of
``ldiffusion_tpu/tools/sample.py`` (reference ``sample.py:1-68``):

    python -m ldiffusion_tpu_torch.tools.sample --diffusion-path SD_DIR \\
        --image roi.png [--ldiffusion-weight UNET_DIR] [--num-steps 5] [--out-dir OUT]

The image is loaded ImageNet-normalised (as ``load_image`` returns it) and
VAE-encoded to its mean; at every PNDM visit (n steps visit n + 1
timesteps) Laplace noise scaled by sqrt(1 − alpha_bar_t) is added to the
current latents, the UNet predicts from them, the scheduler steps the
current latents, and their ``decode_latents`` is written as
``step_{i:02d}_t{t}.png``. ``random:...`` takes the tiny seeded components
at 64², any other path a diffusers SD directory at 512². Runs on the card
unless ``main(argv, device="cpu")``.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from ldiffusion_tpu_torch.data.dataset import load_image
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents, trajectory_text_emb


def sample_steps(components: SDComponents, image: np.ndarray, num_steps: int, out_dir: str,
                 seed: int = 0, laplace: bool = True, noise=None):
    """image: (H, W, 3) float32. ``noise``: the unit Laplace draw of each
    visit, (visits, 1, H/8, W/8, 4), or None to draw them from a generator
    seeded with ``seed``. Returns the PNG paths, one a visit."""
    os.makedirs(out_dir, exist_ok=True)
    sch = components.scheduler
    ts = sch.set_timesteps(num_steps)
    dev = components.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    paths = []
    with torch.inference_mode():
        emb = trajectory_text_emb(components, 1)
        latents = components.vae.encode_mean(
            torch.as_tensor(image)[None].permute(0, 3, 1, 2).to(dev))
        state = sch.init_state()
        for i, t in enumerate(ts.values):
            x = latents
            if laplace:
                draw = None if noise is None else torch.as_tensor(noise[i]).permute(0, 3, 1, 2)
                x = sch.add_laplace_noise(x, t, draw, gen)
            eps = components.unet(x, t, emb)
            latents, state = sch.step(ts, state, eps, t, latents)
            decoded = components.vae.decode_latents(latents)[0].permute(1, 2, 0)
            arr = (np.clip(decoded.float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            path = os.path.join(out_dir, f"step_{i:02d}_t{t}.png")
            Image.fromarray(arr).save(path)
            paths.append(path)
    return paths


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description="Save per-step reverse-diffusion decodes")
    p.add_argument("--diffusion-path", required=True)
    p.add_argument("--ldiffusion-weight", default=None)
    p.add_argument("--image", required=True)
    p.add_argument("--num-steps", type=int, default=5)
    p.add_argument("--out-dir", default="sample_out")
    args = p.parse_args(argv)
    tiny = args.diffusion_path.startswith("random:")
    comps = (SDComponents.random(device=device) if tiny
             else SDComponents.load(args.diffusion_path, device=device,
                                    unet_override_dir=args.ldiffusion_weight))
    size = 64 if tiny else 512
    paths = sample_steps(comps, load_image(args.image, (size, size)), args.num_steps,
                         args.out_dir)
    print("\n".join(paths))
    return paths


if __name__ == "__main__":
    main()
