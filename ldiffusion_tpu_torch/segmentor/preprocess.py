"""Preprocessing (counterpart of ``ldiffusion_tpu/segmentor/preprocess.py:
31-290``; reference ``default_preprocessor.py:33-296``): crop to nonzero (the
bbox is kept), per-channel z-score (the one normalisation scheme the planners
emit), and at most 10k sampled locations per foreground class for
oversampling. PNG cases have unit spacing, so resampling is the identity;
volumes are resampled to the plan's spacing (``preprocess_case_3d``, through
``segmentor/resample.py``). The cascade's input appends the previous stage's
segmentation as one-hot channels of the foreground labels
(``append_prev_stage_channels``). ``PreprocessedDataset`` stores 2D and 3D
cases in memory or as ``<case>.npz`` + ``<case>.json`` in the JAX package's
layout. ``-preprocessor_name`` resolves through ``get_preprocessor``
(``ldiffusion_tpu/segmentor/preprocess.py:183-220``). The other
normalisation schemes (CT, rescale to [0, 1], RGB / 255, none) are there by
name in ``NORMALIZATION_SCHEMES`` for ``normalize``; no planner of either
package emits them.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ldiffusion_tpu_torch.core.registry import find_class, register
from ldiffusion_tpu_torch.segmentor.fingerprint import crop_to_nonzero_bbox

FG_LOCS_PER_CLASS = 10_000


@dataclasses.dataclass
class PreprocessedCase:
    data: np.ndarray          # (*spatial, C) float32, normalised
    seg: np.ndarray           # (*spatial) int16
    properties: Dict          # bbox, original shape, class locations


def zscore_normalize(image: np.ndarray) -> np.ndarray:
    """Per-image, per-channel z-score (``ZScoreNormalization``)."""
    mean = image.mean(axis=(0, 1), keepdims=True)
    std = image.std(axis=(0, 1), keepdims=True)
    return ((image - mean) / np.maximum(std, 1e-8)).astype(np.float32)


def ct_normalize(image: np.ndarray, intensity_props: Dict) -> np.ndarray:
    """``CTNormalization``: each channel clipped to the fingerprint's 0.5 and
    99.5 percentiles, then z-scored with the fingerprint's mean and std."""
    out = np.empty_like(image, np.float32)
    for c in range(image.shape[-1]):
        p = intensity_props[str(c)]
        x = np.clip(image[..., c], p["percentile_00_5"], p["percentile_99_5"])
        out[..., c] = (x - p["mean"]) / max(p["std"], 1e-8)
    return out


def rescale_to_01(image: np.ndarray) -> np.ndarray:
    """``RescaleTo01Normalization``: per channel, min → 0, max → 1."""
    mn = image.min(axis=(0, 1), keepdims=True)
    mx = image.max(axis=(0, 1), keepdims=True)
    return ((image - mn) / np.maximum(mx - mn, 1e-8)).astype(np.float32)


def rgb_to_01(image: np.ndarray) -> np.ndarray:
    """``RGBTo01Normalization``: uint8-range input / 255."""
    return (image / 255.0).astype(np.float32)


def no_norm(image: np.ndarray) -> np.ndarray:
    """``NoNormalization``: float32, values as they are."""
    return image.astype(np.float32)


NORMALIZATION_SCHEMES = {
    "zscore_image": lambda img, props: zscore_normalize(img),
    "ct": ct_normalize,
    "rescale_to_01": lambda img, props: rescale_to_01(img),
    "rgb_to_01": lambda img, props: rgb_to_01(img),
    "none": lambda img, props: no_norm(img),
}


def normalize(image: np.ndarray, scheme: str = "zscore_image",
              intensity_props: Optional[Dict] = None) -> np.ndarray:
    """``image`` (H, W, C) under the named scheme; ``intensity_props`` is
    the fingerprint's per-channel statistics (the CT scheme reads them)."""
    return NORMALIZATION_SCHEMES[scheme](image, intensity_props or {})


def sample_fg_locations(seg: np.ndarray, num_classes: int, seed: int = 1234,
                        per_class: int = FG_LOCS_PER_CLASS) -> Dict[int, np.ndarray]:
    """At most ``per_class`` (y, x) locations of each present foreground class."""
    rng = np.random.default_rng(seed)
    out = {}
    for c in range(1, num_classes):
        coords = np.argwhere(seg == c)
        if coords.shape[0] == 0:
            continue
        if coords.shape[0] > per_class:
            coords = coords[rng.choice(coords.shape[0], per_class, replace=False)]
        out[c] = coords.astype(np.int32)
    return out


def preprocess_case(image: np.ndarray, seg: np.ndarray, num_classes: int,
                    seed: int = 1234) -> PreprocessedCase:
    """image: (H, W, C) float32; seg: (H, W) int."""
    orig_shape = image.shape[:2]
    ys, xs = crop_to_nonzero_bbox(image)
    image = image[ys, xs]
    seg = seg[ys, xs].astype(np.int16)
    props = {
        "original_shape": list(orig_shape),
        "bbox": [[ys.start, ys.stop], [xs.start, xs.stop]],
        "class_locations": sample_fg_locations(seg, num_classes, seed),
    }
    return PreprocessedCase(data=zscore_normalize(image), seg=seg, properties=props)


def preprocess_case_3d(image: np.ndarray, seg: np.ndarray, num_classes: int,
                       spacing: Sequence[float] = (1.0, 1.0, 1.0),
                       target_spacing: Optional[Sequence[float]] = None,
                       seed: int = 1234) -> PreprocessedCase:
    """image: (Z, H, W, C) float32; seg: (Z, H, W) int. Crop to nonzero →
    z-score over the volume → resample to ``target_spacing`` (separate-z when
    anisotropic) → foreground locations (``preprocess.py:119-157``)."""
    from ldiffusion_tpu_torch.segmentor.resample import compute_new_shape, resample_data_3d

    orig_shape = image.shape[:3]
    idx = np.argwhere(np.any(image != 0, axis=-1))
    if idx.size == 0:
        sl = tuple(slice(0, s) for s in orig_shape)
    else:
        mins, maxs = idx.min(axis=0), idx.max(axis=0) + 1
        sl = tuple(slice(int(a), int(b)) for a, b in zip(mins, maxs))
    image = image[sl]
    seg = seg[sl].astype(np.int16)
    mean = image.mean(axis=(0, 1, 2), keepdims=True)
    std = image.std(axis=(0, 1, 2), keepdims=True)
    data = ((image - mean) / np.maximum(std, 1e-8)).astype(np.float32)
    if target_spacing is not None and tuple(target_spacing) != tuple(spacing):
        new_shape = compute_new_shape(data.shape[:3], spacing, target_spacing)
        data = resample_data_3d(data, new_shape, spacing, order=3)
        seg = resample_data_3d(seg, new_shape, spacing, is_seg=True).astype(np.int16)
    props = {
        "original_shape": list(orig_shape),
        "spacing": list(spacing),
        "target_spacing": list(target_spacing or spacing),
        "bbox": [[s.start, s.stop] for s in sl],
        "class_locations": sample_fg_locations(seg, num_classes, seed),
    }
    return PreprocessedCase(data=data, seg=seg, properties=props)


def append_prev_stage_channels(case: PreprocessedCase, prev_seg: np.ndarray,
                               num_classes: int) -> PreprocessedCase:
    """The cascade's input: the previous stage's segmentation (on this case's
    grid) appended as one-hot channels of the foreground labels only, no
    background channel (reference ``label_handling.py:283-322``)."""
    if prev_seg.shape != case.seg.shape:
        raise ValueError(f"previous stage {prev_seg.shape} vs case {case.seg.shape}")
    onehot = np.eye(num_classes, dtype=np.float32)[np.maximum(prev_seg, 0)][..., 1:]
    return PreprocessedCase(data=np.concatenate([case.data, onehot], axis=-1), seg=case.seg,
                            properties=dict(case.properties))


class DefaultPreprocessor:
    """The ``-preprocessor_name`` plugin point (reference
    ``plan_and_preprocess_entrypoints.py:49-53``): subclass and
    ``@register("preprocessor")`` to change the per-case preprocessing."""

    def run_case(self, image: np.ndarray, seg: np.ndarray, num_classes: int,
                 seed: int = 1234) -> PreprocessedCase:
        return preprocess_case(image, seg, num_classes, seed=seed)

    def run_case_3d(self, image: np.ndarray, seg: np.ndarray, num_classes: int,
                    spacing: Sequence[float] = (1.0, 1.0, 1.0),
                    target_spacing: Optional[Sequence[float]] = None,
                    seed: int = 1234) -> PreprocessedCase:
        return preprocess_case_3d(image, seg, num_classes, spacing=spacing,
                                  target_spacing=target_spacing, seed=seed)


register("preprocessor")(DefaultPreprocessor)


def get_preprocessor(name: Optional[str]) -> DefaultPreprocessor:
    """``-preprocessor_name`` → an instance (the registry, then a walk over
    ``ldiffusion_tpu_torch.segmentor``); an unknown name raises KeyError."""
    if not name:
        return DefaultPreprocessor()
    return find_class("preprocessor", name,
                      search_modules=["ldiffusion_tpu_torch.segmentor"])()


class PreprocessedDataset:
    """Case-keyed preprocessed store (reference ``nnunet_dataset.py:11-111``):
    in memory, or npz-backed in a directory."""

    def __init__(self, cases: Optional[Dict[str, PreprocessedCase]] = None,
                 directory: Optional[str] = None):
        self.cases = cases or {}
        self.directory = directory

    @classmethod
    def build(cls, images: Sequence[np.ndarray], segs: Sequence[np.ndarray],
              num_classes: int, case_ids: Optional[Sequence[str]] = None,
              directory: Optional[str] = None,
              preprocessor: Optional[DefaultPreprocessor] = None) -> "PreprocessedDataset":
        case_ids = case_ids or [f"case_{i:03d}" for i in range(len(images))]
        preprocessor = preprocessor or DefaultPreprocessor()
        ds = cls(directory=directory)
        for cid, img, seg in zip(case_ids, images, segs):
            ds.cases[cid] = preprocessor.run_case(img, seg, num_classes)
        if directory:
            ds.save(directory)
        return ds

    def save(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        for cid, pc in self.cases.items():
            np.savez(os.path.join(directory, f"{cid}.npz"), data=pc.data, seg=pc.seg)
            props = dict(pc.properties)
            props["class_locations"] = {
                str(k): np.asarray(v).tolist()
                for k, v in props.get("class_locations", {}).items()}
            with open(os.path.join(directory, f"{cid}.json"), "w") as f:
                json.dump(props, f)
        return directory

    @classmethod
    def load(cls, directory: str) -> "PreprocessedDataset":
        ds = cls(directory=directory)
        for fn in sorted(os.listdir(directory)):
            if not fn.endswith(".npz"):
                continue
            cid = fn[:-4]
            with np.load(os.path.join(directory, fn)) as z:
                data, seg = z["data"], z["seg"]
            with open(os.path.join(directory, f"{cid}.json")) as f:
                props = json.load(f)
            props["class_locations"] = {
                int(k): np.asarray(v, np.int32) for k, v in props["class_locations"].items()}
            ds.cases[cid] = PreprocessedCase(data=data, seg=seg, properties=props)
        return ds

    def keys(self) -> List[str]:
        return list(self.cases.keys())

    def subset(self, keys: Sequence[str]) -> "PreprocessedDataset":
        """The cases of one fold (``nnUNetDataset(keys)``)."""
        missing = [k for k in keys if k not in self.cases]
        if missing:
            raise KeyError(f"unknown case ids: {missing}")
        return PreprocessedDataset(cases={k: self.cases[k] for k in keys},
                                   directory=self.directory)

    def __len__(self) -> int:
        return len(self.cases)

    def __getitem__(self, cid: str) -> PreprocessedCase:
        return self.cases[cid]
