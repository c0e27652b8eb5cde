"""Utilities (counterpart of ``ldiffusion_tpu/utils.py``; reference
``utils.py``): Gaussian heatmaps and their top-k peaks (SAM-style prompting
helpers, ``:26-53,106-153``), micro-Dice and mean IoU (``:55-104``), the
image loading helpers (``:296-344``) and the segmentation overlay PNG that
``plot_overlays`` writes."""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
from scipy import ndimage


def generate_gaussian(H: int, W: int, x: float, y: float, sigma: float) -> np.ndarray:
    """Gaussian heatmap centred at (x, y) (reference ``utils.py:49-53``)."""
    xx, yy = np.meshgrid(np.arange(W), np.arange(H))
    return np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * sigma ** 2))


def generate_multi_class_heatmaps(masks: np.ndarray, num_classes: int,
                                  sigma: float = 5.0) -> np.ndarray:
    """Per-class Gaussian heatmaps at connected-component centres (reference
    ``utils.py:26-47``): masks (B, H, W) ints → (B, num_classes, H, W)."""
    B, H, W = masks.shape
    heatmaps = np.zeros((B, num_classes, H, W), np.float32)
    for b in range(B):
        for cls in range(num_classes):
            labeled, num = ndimage.label((masks[b] == cls).astype(np.uint8))
            for region in range(1, num + 1):
                region_mask = labeled == region
                if not region_mask.any():
                    continue
                y, x = ndimage.center_of_mass(region_mask)
                if np.isnan(x) or np.isnan(y):
                    continue
                heatmaps[b, cls] += generate_gaussian(H, W, x, y, sigma)
                heatmaps[b, cls] = np.clip(heatmaps[b, cls], 0, 1)
    return heatmaps


def extract_topk_points(heatmaps: np.ndarray, k: int = 5, ignore_class: int = 0,
                        score_threshold: float = 0.5):
    """Top-k peak (x, y) points and their class labels per batch element
    (reference ``utils.py:106-153``); heatmaps (B, C, H, W)."""
    B, C, H, W = heatmaps.shape
    coords_list: List[np.ndarray] = []
    labels_list: List[np.ndarray] = []
    class_range = [c for c in range(C) if c != ignore_class]
    for b in range(B):
        scores, coords, labels = [], [], []
        for cls in class_range:
            flat = heatmaps[b, cls].reshape(-1)
            idx = np.argpartition(flat, -k)[-k:]
            idx = idx[np.argsort(flat[idx])[::-1]]
            vals = flat[idx]
            if vals.max() < score_threshold:
                continue
            ys, xs = idx // W, idx % W
            scores.append(vals)
            coords.append(np.stack([xs, ys], axis=1))
            labels.append(np.full(k, cls, np.int64))
        if not scores:
            coords_list.append(np.zeros((0, 2), np.int64))
            labels_list.append(np.zeros((0,), np.int64))
            continue
        all_scores = np.concatenate(scores)
        order = np.argsort(all_scores)[::-1][:min(k, all_scores.size)]
        coords_list.append(np.concatenate(coords)[order])
        labels_list.append(np.concatenate(labels)[order])
    return coords_list, labels_list


def micro_dice(predicted, true, num_classes: int = 7):
    """(per-class scores, mean) with the empty-class = 1 convention (reference
    ``utils.py:55-82``). ``predicted``: labels (B, H, W) or logits, either
    (B, H, W, C) or (B, C, H, W)."""
    import torch

    from ldiffusion_tpu_torch.losses.dice import micro_dice as _micro_dice

    pred = np.asarray(predicted)
    if pred.ndim == 4 and not (pred.shape[1] == num_classes and pred.shape[-1] != num_classes):
        pred = np.moveaxis(pred, -1, 1)  # NHWC → NCHW
    scores, mean = _micro_dice(torch.from_numpy(np.ascontiguousarray(pred)),
                               torch.from_numpy(np.asarray(true)), num_classes)
    return scores.numpy(), float(mean)


def mean_iou_and_per_class(pred, target, num_classes: int):
    """Mean IoU over the classes present in either map, and a per-class dict
    with None for the absent (reference ``utils.py:84-104``)."""
    pred = np.asarray(pred)
    if pred.ndim == 4:
        pred = np.argmax(pred, axis=1 if pred.shape[1] == num_classes else -1)
    target = np.asarray(target)
    ious = []
    iou_dict: Dict[int, Optional[float]] = {}
    for cls in range(num_classes):
        p, t = pred == cls, target == cls
        union = np.logical_or(p, t).sum()
        if union == 0:
            iou_dict[cls] = None
            continue
        iou = float(np.logical_and(p, t).sum() / union)
        ious.append(iou)
        iou_dict[cls] = iou
    return (sum(ious) / len(ious) if ious else 1.0), iou_dict


def load_image_to_numpy(img_input) -> np.ndarray:
    """A path, PIL image or (H, W[, C]) array → (C, H, W) float32 (reference
    ``utils.py:296-312``)."""
    from PIL import Image

    if isinstance(img_input, str):
        img = Image.open(img_input).convert("RGB")
    elif hasattr(img_input, "convert"):
        img = img_input.convert("RGB")
    elif isinstance(img_input, np.ndarray):
        arr = img_input[..., None] if img_input.ndim == 2 else img_input
        return np.transpose(arr, (2, 0, 1)).astype(np.float32)
    else:
        raise TypeError(f"Unsupported input type: {type(img_input)}")
    return np.transpose(np.asarray(img, np.float32), (2, 0, 1))


def prepare_image_for_predictor(arr: np.ndarray) -> np.ndarray:
    """→ (1, 3, H, W) (reference ``utils.py:315-344``)."""
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = arr.transpose(2, 0, 1)
    elif arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=0)
    if arr.shape[0] != 3:
        raise ValueError(f"Unexpected image shape after conversion: {arr.shape}")
    return arr[np.newaxis]


# overlay colours (the idea of nnU-Net's overlay_plots.py colour cycle);
# index 0, the background, is not painted
OVERLAY_COLORS = np.array([
    [0, 0, 0], [255, 64, 64], [64, 160, 255], [64, 224, 96], [255, 192, 64],
    [192, 96, 255], [64, 224, 224], [255, 128, 192], [160, 160, 64],
    [128, 96, 64], [224, 64, 160], [96, 128, 255],
], np.uint8)


def save_segmentation_overlay(image: np.ndarray, seg: np.ndarray, path: str,
                              alpha: float = 0.6) -> None:
    """Blend a class map over an RGB image and write a PNG (nnU-Net's
    ``overlay_plots.py:generate_overlay``): image (H, W, 3) float in [0, 1]
    or uint8, seg (H, W) class ids."""
    from PIL import Image

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    colors = OVERLAY_COLORS[np.asarray(seg) % len(OVERLAY_COLORS)]
    fg = (np.asarray(seg) > 0)[..., None]
    out = np.where(fg, (alpha * colors + (1 - alpha) * img).astype(np.uint8), img)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(out).save(path)
