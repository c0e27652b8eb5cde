"""Per-pixel trajectory features to CSV, counterpart of
``ldiffusion_tpu/tools/pixel_latent_vector.py`` (reference
``pixel_latent_vector.py:1-109``, whose broken imports the JAX package
repaired):

    python -m ldiffusion_tpu_torch.tools.pixel_latent_vector --diffusion-path SD_DIR \\
        --image-dir IMAGES --label-dir LABELS [--num-inference-steps 25] [--out FILE.csv]

For each 64² image (and its 64² labels) the stage-1 trajectory runs over
max(1, n // 5) inference steps (PLMS: one more timestep than steps); the
gray decode of each timestep is one feature. Up to
``max_pixels_per_image`` pixels an image, picked by
``np.random.default_rng(seed + i)`` as in the JAX package, are written as
rows ``image, y, x, label, step_0..``. Runs on the card unless
``main(argv, device="cpu")``.
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import Callable, Optional

import numpy as np
import torch

from ldiffusion_tpu_torch.data.dataset import SegmentationDataset, list_pairs
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents, trajectory_features
from ldiffusion_tpu_torch.diffusion.schedulers import laplace_noise


def dump_pixel_latent_vectors(components: SDComponents, dataset: SegmentationDataset,
                              num_inference_steps: int, out_csv: str,
                              max_images: Optional[int] = None,
                              max_pixels_per_image: int = 4096, seed: int = 0,
                              draw_noise: Optional[Callable] = None):
    """``draw_noise(shape)`` gives each image's unit Laplace trajectory noise
    of ``shape`` (timesteps, 1, 8, 8, latent channels), image by image; by
    default a generator seeded with ``seed`` draws it."""
    os.makedirs(os.path.dirname(out_csv) or ".", exist_ok=True)
    dev = components.device
    if draw_noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def draw_noise(shape):
            return laplace_noise(shape, gen, dev)

    steps = max(1, int(num_inference_steps / 5))
    n_t = len(components.scheduler.set_timesteps(steps))
    lat = 64 // components.latent_factor
    noise_shape = (n_t, 1, lat, lat, components.vae_config.latent_channels)
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    with open(out_csv, "w", newline="") as f:
        writer = csv.writer(f)
        for i in range(n):
            img, lab = dataset.get(i, image_size=64, label_size=64)
            with torch.inference_mode():
                traj, _ = trajectory_features(
                    components, torch.from_numpy(img[None].astype(np.float32)).to(dev),
                    torch.as_tensor(draw_noise(noise_shape)).to(dev), steps, remat=False)
            traj = traj[0].float().cpu().numpy()          # (64, 64, T)
            t_dim = traj.shape[-1]
            if i == 0:
                writer.writerow(["image", "y", "x", "label"] + [f"step_{t}" for t in range(t_dim)])
            flat = traj.reshape(-1, t_dim)
            labs = lab.reshape(-1)
            take = min(max_pixels_per_image, flat.shape[0])
            idx = np.random.default_rng(seed + i).choice(flat.shape[0], take, replace=False)
            for j in idx:
                y, x = divmod(int(j), traj.shape[1])
                writer.writerow([i, y, x, int(labs[j])] + [f"{v:.6f}" for v in flat[j]])
    return out_csv


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description="Dump per-pixel diffusion trajectory "
                                            "features to CSV")
    p.add_argument("--diffusion-path", required=True)
    p.add_argument("--image-dir", required=True)
    p.add_argument("--label-dir", required=True)
    p.add_argument("--level", default="tissue")
    p.add_argument("--num-inference-steps", type=int, default=25)
    p.add_argument("--out", default="pixel_latent_vectors.csv")
    p.add_argument("--max-images", type=int, default=None)
    args = p.parse_args(argv)
    comps = (SDComponents.random(device=device) if args.diffusion_path.startswith("random:")
             else SDComponents.load(args.diffusion_path, device=device))
    images, labels = list_pairs(args.image_dir, args.label_dir)
    ds = SegmentationDataset(images, labels, args.level)
    out = dump_pixel_latent_vectors(comps, ds, args.num_inference_steps, args.out,
                                    args.max_images)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
