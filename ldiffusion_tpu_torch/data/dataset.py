"""Dataset loading, splitting and batched iteration (counterpart of
``ldiffusion_tpu/data/dataset.py``): PIL + numpy on the host. Under a
process group every process iterates the same global batches (the same
seed) and loads its own rows of the images (``iter_batches(rows=...)``, the
``local_batch_slice`` the JAX package leaves to the caller)."""
from __future__ import annotations

import os
import random
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ldiffusion_tpu_torch.data.labels import convert_labels

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """RGB image → (H, W, 3) float32; bilinear resize to ``size=(H, W)`` and
    ImageNet normalisation."""
    with Image.open(path) as f:
        img = f.convert("RGB")
    if size is not None:
        img = img.resize((size[1], size[0]), Image.BILINEAR)
    return (np.asarray(img, np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def load_label(path: str, level: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Grayscale label PNG → (H, W) uint8 class ids; resized with nearest
    where its size differs from ``size``."""
    with Image.open(path) as f:
        img = f.convert("L")
    if size is not None and img.size != (size[1], size[0]):
        img = img.resize((size[1], size[0]), Image.NEAREST)
    return convert_labels(np.asarray(img, np.uint8), level)


def list_pairs(image_dir: str, label_dir: str) -> Tuple[List[str], List[str]]:
    """Sorted image and label paths, paired by position."""
    images = sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir))
    labels = sorted(os.path.join(label_dir, f) for f in os.listdir(label_dir))
    if len(images) != len(labels):
        raise ValueError(f"image/label count mismatch: {len(images)} vs {len(labels)}")
    return images, labels


def split_dataset(images: Sequence[str], labels: Sequence[str], train_ratio: float = 0.7,
                  seed: Optional[int] = 0):
    """Shuffled split (70/30 by default), seeded as in the JAX package."""
    idx = list(range(len(images)))
    random.Random(seed).shuffle(idx)
    split = int(len(images) * train_ratio)
    tr, te = idx[:split], idx[split:]
    return ([images[i] for i in tr], [labels[i] for i in tr],
            [images[i] for i in te], [labels[i] for i in te])


class SegmentationDataset:
    """Pairs of (image path, label path), loaded item by item."""

    def __init__(self, image_paths: Sequence[str], label_paths: Sequence[str],
                 level: str, image_size: int = 1024):
        self.image_paths = list(image_paths)
        self.label_paths = list(label_paths)
        self.level = level
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.image_paths)

    def get(self, i: int, image_size: Optional[int] = None,
            label_size: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        s = image_size or self.image_size
        ls = label_size or s
        return (load_image(self.image_paths[i], (s, s)),
                load_label(self.label_paths[i], self.level, (ls, ls)))

    def iter_batches(self, batch_size: int, image_size: Optional[int] = None,
                     label_size: Optional[int] = None, shuffle: bool = True,
                     seed: int = 0, drop_last: bool = True, loop: bool = True,
                     rows: Optional[slice] = None) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(images (B, s, s, 3) float32, labels (B, ls, ls) int32) batches,
        reshuffled every pass; endless unless ``loop`` is False. ``rows``:
        this process's rows of each batch, the only images it loads; the
        labels stay whole (the stage-1 contrastive draws read every image's
        labels, so they do not depend on the number of processes)."""
        rng = np.random.default_rng(seed)
        n = len(self)
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            end = n - (n % batch_size) if drop_last else n
            for start in range(0, max(end, 1), batch_size):
                idx = order[start:start + batch_size]
                if len(idx) == 0 or (drop_last and len(idx) < batch_size):
                    continue
                s = image_size or self.image_size
                ls = label_size or s
                ims = [load_image(self.image_paths[i], (s, s))
                       for i in (idx if rows is None else idx[rows])]
                labs = [load_label(self.label_paths[i], self.level, (ls, ls)) for i in idx]
                yield np.stack(ims), np.stack(labs).astype(np.int32)
            if not loop:
                return
