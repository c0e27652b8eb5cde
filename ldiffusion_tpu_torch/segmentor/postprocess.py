"""Connected-component postprocessing (counterpart of
``ldiffusion_tpu/segmentor/postprocess.py``; reference
``remove_connected_components.py``): decide on the validation predictions
which keep-largest-component steps raise the mean foreground Dice
(``determine_postprocessing``, the whole foreground first, then each class),
save them as ``postprocessing.json``, and apply them at inference, to one
mask or to a folder of PNG masks (``apply_postprocessing_to_folder``)."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np
from scipy import ndimage

from ldiffusion_tpu_torch.evaluate import confusion_matrix, metrics_from_cm


def remove_all_but_largest_component(seg: np.ndarray, labels) -> np.ndarray:
    """Keep only the largest connected component of the given labels (merged
    as one region); other pixels of those labels become background (0)."""
    labels = [labels] if np.isscalar(labels) else list(labels)
    mask = np.isin(seg, labels)
    if not mask.any():
        return seg
    comp, n = ndimage.label(mask)
    if n <= 1:
        return seg
    sizes = ndimage.sum_labels(np.ones_like(comp), comp, index=range(1, n + 1))
    keep = int(np.argmax(sizes)) + 1
    out = seg.copy()
    out[mask & (comp != keep)] = 0
    return out


def _mean_fg_dice(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray],
                  num_classes: int, ignore_label=None) -> float:
    """Mean foreground Dice of one confusion matrix over every case, without
    the ground truth's ``ignore_label`` pixels."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    for p, g in zip(preds, gts):
        if ignore_label is not None:
            keep = np.asarray(g) != ignore_label
            p, g = np.asarray(p)[keep], np.asarray(g)[keep]
        cm += confusion_matrix(p, g, num_classes)
    return float(np.mean(metrics_from_cm(cm)["dice_per_class"][1:]))


def determine_postprocessing(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray],
                             num_classes: int, ignore_label=None) -> List[Dict]:
    """The keep-largest-component steps that improve the mean foreground Dice
    (``ldiffusion_tpu/segmentor/postprocess.py:57-82``), scored without the
    ground truth's ``ignore_label`` pixels."""
    steps: List[Dict] = []
    cur = [p.copy() for p in preds]
    base = _mean_fg_dice(cur, gts, num_classes, ignore_label)
    fg_labels = list(range(1, num_classes))
    cand = [remove_all_but_largest_component(p, fg_labels) for p in cur]
    score = _mean_fg_dice(cand, gts, num_classes, ignore_label)
    if score > base:
        steps.append({"fn": "remove_all_but_largest_component", "labels": fg_labels})
        cur, base = cand, score
    for c in range(1, num_classes):
        cand = [remove_all_but_largest_component(p, c) for p in cur]
        score = _mean_fg_dice(cand, gts, num_classes, ignore_label)
        if score > base:
            steps.append({"fn": "remove_all_but_largest_component", "labels": [c]})
            cur, base = cand, score
    return steps


def save_postprocessing(steps: Sequence[Dict], path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(list(steps), f, indent=2)


def apply_postprocessing(seg: np.ndarray, steps: Sequence[Dict]) -> np.ndarray:
    for s in steps:
        if s["fn"] != "remove_all_but_largest_component":
            raise ValueError(f"unknown postprocessing step {s!r}")
        seg = remove_all_but_largest_component(seg, s["labels"])
    return seg


def load_postprocessing(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)


def apply_postprocessing_to_folder(input_dir: str, output_dir: str, steps_path: str):
    """Apply the steps of ``steps_path`` to every PNG mask of ``input_dir``,
    written under the same names in ``output_dir`` (reference
    ``remove_connected_components.py:300-345``)."""
    from PIL import Image

    steps = load_postprocessing(steps_path)
    os.makedirs(output_dir, exist_ok=True)
    for fn in sorted(os.listdir(input_dir)):
        if not fn.lower().endswith(".png"):
            continue
        with Image.open(os.path.join(input_dir, fn)) as im:
            seg = np.asarray(im)
        out = apply_postprocessing(seg.copy(), steps)
        Image.fromarray(out.astype(np.uint8)).save(os.path.join(output_dir, fn))
