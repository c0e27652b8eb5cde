"""Materialise a diffusion-transformed segmentation dataset (counterpart of
``ldiffusion_tpu/segmentor/dataset_builder.py``; reference
``utils.py:210-294``): every train and test image goes through the one-step
diffusion transform and is written in the ``DatasetXXX_Custom`` layout
(imagesTr/labelsTr/imagesTs/labelsTs + ``dataset.json``). The transform is
skipped when the images differ in size (reference ``utils.py:213``).

The transform is the same ``one_step_transform`` that inference runs, in
batches of ``batch_size`` (the JAX ``DiffusionTransform``, one jitted
program per batch size): one ``core/graphs.py`` program per input shape in
the transform's own memory pool, eager at its first use, captured as a CUDA
graph at its second and replayed after (on the CPU each call runs the
function). On the card a build through one transform launches the port's
flash forward and GroupNorm kernels from graph replays from its third
batch on.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from ldiffusion_tpu_torch.core.graphs import Jit
from ldiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD, load_image
from ldiffusion_tpu_torch.data.labels import label_lut
from ldiffusion_tpu_torch.diffusion.pipeline import (
    SDComponents,
    one_step_transform,
    trajectory_text_emb,
)


class DiffusionTransform:
    """The one-step diffusion feature transform in batches of
    ``batch_size`` on the components' device: the prompt embedding for the
    batch made once, one program per input shape (module docstring), the
    last chunk zero-padded and its pad rows dropped."""

    def __init__(self, components: SDComponents, batch_size: int = 1):
        self.c = components
        self.batch_size = batch_size
        dev = components.device
        self.program = Jit(self._transform, dev,
                           torch.cuda.graph_pool_handle() if dev.type == "cuda" else None,
                           name="transform")
        with torch.inference_mode():
            self._emb = trajectory_text_emb(components, batch_size)

    def _transform(self, images):
        return one_step_transform(self.c, images, self._emb)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W, 3) ImageNet-normalised → (N, H, W, 3) float32 in
        [0, 1]. Each chunk's output is copied to the host before the next
        chunk runs."""
        b, out = self.batch_size, []
        for s in range(0, images.shape[0], b):
            chunk = np.ascontiguousarray(images[s:s + b], np.float32)
            n = chunk.shape[0]
            if n < b:
                chunk = np.concatenate([chunk, np.zeros((b - n,) + chunk.shape[1:], np.float32)])
            out.append(self.program(torch.from_numpy(chunk)).float().cpu().numpy()[:n])
        return np.concatenate(out) if out else images


def check_images_same_size(paths: Sequence[str]) -> bool:
    """reference ``utils.py:155-163``."""
    sizes = set()
    for p in paths:
        with Image.open(p) as img:
            sizes.add(img.size)
            if len(sizes) > 1:
                return False
    return True


def next_dataset_dir(root: str) -> Tuple[int, str]:
    """The next ``DatasetXXX_Custom`` id under ``root`` (reference
    ``utils.py:214-227``)."""
    rootp = Path(root)
    rootp.mkdir(parents=True, exist_ok=True)
    max_num = 0
    for d in rootp.iterdir():
        if d.is_dir() and d.name.startswith("Dataset"):
            try:
                max_num = max(max_num, int(d.name[7:10]))
            except ValueError:
                continue
    new_num = max_num + 1
    return new_num, str(rootp / f"Dataset{new_num:03d}_Custom")


def build_transformed_dataset(
    train_images: Sequence[str], train_labels: Sequence[str],
    test_images: Sequence[str], test_labels: Sequence[str],
    num_classes: int, level: str, transform: Optional[DiffusionTransform],
    root: str, image_size: int = 1024,
) -> Tuple[int, str]:
    """Returns (dataset number, dataset path). ``transform=None`` copies the
    raw images (the reference's fallback for mixed sizes)."""
    use_diffusion = (transform is not None and check_images_same_size(train_images)
                     and check_images_same_size(test_images))
    num, path = next_dataset_dir(root)
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        os.makedirs(os.path.join(path, sub))
    lut = label_lut(level)

    def write_split(images, labels, img_dir, lbl_dir, prefix):
        for idx, (ip, lp) in enumerate(zip(images, labels)):
            case = f"{prefix}_{idx:03d}"
            img = load_image(ip, (image_size, image_size))
            out = transform(img[None])[0] if use_diffusion else img * IMAGENET_STD + IMAGENET_MEAN
            Image.fromarray((np.clip(out, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(path, img_dir, f"{case}_0000.png"))
            with Image.open(lp) as f:
                lbl = f.convert("L")
            if lbl.size != (image_size, image_size):
                lbl = lbl.resize((image_size, image_size), Image.NEAREST)
            Image.fromarray(lut[np.asarray(lbl, np.uint8)]).save(
                os.path.join(path, lbl_dir, f"{case}.png"))

    write_split(train_images, train_labels, "imagesTr", "labelsTr", "case")
    write_split(test_images, test_labels, "imagesTs", "labelsTs", "caseTs")

    dataset_json = {
        "channel_names": {"0": "R", "1": "G", "2": "B"},
        "labels": {"background": 0, **{f"class{i}": i for i in range(1, num_classes)}},
        "numTraining": len(train_images),
        "file_ending": ".png",
    }
    with open(os.path.join(path, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=4)
    return num, path


def load_transformed_dataset(path: str, split: str = "Tr"):
    """A materialised split back as (images (H, W, 3) float32 in [0, 1],
    labels (H, W) int32) lists."""
    img_dir = os.path.join(path, f"images{split}")
    lbl_dir = os.path.join(path, f"labels{split}")
    images, labels = [], []
    for fn in sorted(os.listdir(img_dir)):
        with Image.open(os.path.join(img_dir, fn)) as f:
            images.append(np.asarray(f.convert("RGB"), np.float32) / 255.0)
        with Image.open(os.path.join(lbl_dir, f"{fn[:-9]}.png")) as f:  # strip _0000.png
            labels.append(np.asarray(f, np.uint8).astype(np.int32))
    return images, labels
