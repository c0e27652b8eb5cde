"""Dataset fingerprint (counterpart of
``ldiffusion_tpu/segmentor/fingerprint.py:29-165``; reference
``fingerprint_extractor.py:18-199``): per case the crop-to-nonzero shape and
up to 10k sampled foreground intensities per channel (≤ 1e7 in all),
aggregated to mean/std/percentiles. Natural 2D images have the spacing
(999, 1, 1); volumes carry their own (``extract_fingerprint_3d``)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NATURAL_2D_SPACING = (999.0, 1.0, 1.0)
FG_SAMPLES_PER_CASE = 10_000
MAX_TOTAL_FG_SAMPLES = 10_000_000


def crop_to_nonzero_bbox(image: np.ndarray) -> Tuple[slice, slice]:
    """bbox of any-channel-nonzero pixels of (H, W, C) (reference
    ``cropping.py:8-50``); the whole image when none is nonzero."""
    mask = np.any(image != 0, axis=-1)
    ys, xs = np.where(mask)
    if ys.size == 0:
        return slice(0, image.shape[0]), slice(0, image.shape[1])
    return slice(int(ys.min()), int(ys.max()) + 1), slice(int(xs.min()), int(xs.max()) + 1)


def _sample_fg(rng, img, lab, budget, per_channel) -> int:
    """Up to 10k foreground intensities of each channel of one case (2D or
    3D) into ``per_channel``; returns the samples left in the budget."""
    fg = lab > 0
    n_fg = int(fg.sum())
    if n_fg > 0 and budget > 0:
        take = min(FG_SAMPLES_PER_CASE, n_fg, budget)
        idx = rng.choice(n_fg, size=take, replace=False)
        budget -= take
        coords = tuple(np.argwhere(fg)[idx].T)
        for c in range(img.shape[-1]):
            per_channel.setdefault(c, []).append(img[coords + (c,)])
    return budget


def _fingerprint(spacings, shapes, shapes_after_crop, per_channel, num_channels,
                 save_path) -> Dict:
    intensity = {}
    for c, chunks in per_channel.items():
        v = np.concatenate(chunks)
        intensity[str(c)] = {
            "mean": float(np.mean(v)),
            "std": float(np.std(v)),
            "min": float(np.min(v)),
            "max": float(np.max(v)),
            "percentile_00_5": float(np.percentile(v, 0.5)),
            "percentile_99_5": float(np.percentile(v, 99.5)),
            "median": float(np.median(v)),
        }
    fp = {
        "spacings": spacings,
        "shapes_after_crop": [list(s) for s in shapes_after_crop],
        "original_shapes": [list(s) for s in shapes],
        "foreground_intensity_properties_per_channel": intensity,
        "num_cases": len(shapes),
        "num_channels": num_channels,
    }
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "w") as f:
            json.dump(fp, f, indent=2)
    return fp


def extract_fingerprint(images: Sequence[np.ndarray], labels: Sequence[np.ndarray],
                        seed: int = 1234, save_path: Optional[str] = None) -> Dict:
    """images: (H, W, C) float arrays; labels: (H, W) ints → the fingerprint
    dict (the content of ``dataset_fingerprint.json``)."""
    rng = np.random.default_rng(seed)
    shapes: List[Tuple[int, int]] = []
    shapes_after_crop: List[Tuple[int, int]] = []
    per_channel: Dict[int, List[np.ndarray]] = {}
    budget = MAX_TOTAL_FG_SAMPLES
    for img, lab in zip(images, labels):
        shapes.append(tuple(img.shape[:2]))
        ys, xs = crop_to_nonzero_bbox(img)
        shapes_after_crop.append((ys.stop - ys.start, xs.stop - xs.start))
        budget = _sample_fg(rng, img, lab, budget, per_channel)
    return _fingerprint([list(NATURAL_2D_SPACING)] * len(shapes), shapes, shapes_after_crop,
                        per_channel, images[0].shape[-1] if images else 3, save_path)


def extract_fingerprint_3d(volumes: Sequence[np.ndarray], labels: Sequence[np.ndarray],
                           spacings: Optional[Sequence[Sequence[float]]] = None,
                           seed: int = 1234, save_path: Optional[str] = None) -> Dict:
    """volumes: (Z, H, W, C) float arrays; labels: (Z, H, W) ints; spacings:
    (z, y, x) per case (unit when None) → the fingerprint
    ``segmentor/planner3d.py:plan_all_configurations`` reads
    (``ldiffusion_tpu/segmentor/fingerprint.py:112-165``)."""
    rng = np.random.default_rng(seed)
    shapes, shapes_after_crop = [], []
    per_channel: Dict[int, List[np.ndarray]] = {}
    budget = MAX_TOTAL_FG_SAMPLES
    for vol, lab in zip(volumes, labels):
        shapes.append(tuple(vol.shape[:3]))
        nz = np.argwhere(np.any(vol != 0, axis=-1))
        if nz.size == 0:
            shapes_after_crop.append(tuple(vol.shape[:3]))
        else:
            mins, maxs = nz.min(axis=0), nz.max(axis=0) + 1
            shapes_after_crop.append(tuple(int(b - a) for a, b in zip(mins, maxs)))
        budget = _sample_fg(rng, vol, lab, budget, per_channel)
    return _fingerprint([list(s) for s in (spacings or [(1.0, 1.0, 1.0)] * len(shapes))],
                        shapes, shapes_after_crop, per_channel,
                        volumes[0].shape[-1] if volumes else 1, save_path)


def verify_dataset_integrity(images: Sequence[np.ndarray], labels: Sequence[np.ndarray],
                             num_classes: int) -> List[str]:
    """Geometry, label range and finiteness checks (reference
    ``verify_dataset_integrity.py``). Returns the problems found."""
    problems = []
    if len(images) != len(labels):
        problems.append(f"count mismatch: {len(images)} images vs {len(labels)} labels")
    for i, (img, lab) in enumerate(zip(images, labels)):
        if img.shape[:2] != lab.shape[:2]:
            problems.append(f"case {i}: image {img.shape[:2]} vs label {lab.shape[:2]}")
        mx = int(lab.max()) if lab.size else 0
        if mx >= num_classes:
            problems.append(f"case {i}: label value {mx} >= num_classes {num_classes}")
        if not np.isfinite(img).all():
            problems.append(f"case {i}: non-finite image values")
    return problems
