"""Segmentation metrics, the labels regime (counterpart of
``ldiffusion_tpu/evaluate.py:26-60, 264-335``): a confusion matrix per
image, Dice/IoU/pixel accuracy/FWIoU from it, and the nnU-Net-format
validation ``summary.json`` (reference ``evaluate_predictions.py:77-264``).
The folder-report CLI, the regions regime and the instance metrics (PQ, AJI)
wait (ROADMAP queue 1, *The cell path* and *Long tail*)."""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
from PIL import Image

from ldiffusion_tpu_torch.data.labels import convert_labels


def confusion_matrix(pred: np.ndarray, gt: np.ndarray, num_classes: int) -> np.ndarray:
    """(num_classes, num_classes) counts; rows are the reference, columns the
    prediction."""
    idx = gt.astype(np.int64) * num_classes + pred.astype(np.int64)
    cm = np.bincount(idx.reshape(-1), minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


def metrics_from_cm(cm: np.ndarray) -> Dict:
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    support = cm.sum(1)
    # micro dice with the empty-class = 1 convention (reference utils.py:55-82)
    denom = 2 * tp + fp + fn
    dice = np.where(denom > 0, 2 * tp / np.maximum(denom, 1e-8), 1.0)
    union = tp + fp + fn
    iou = np.where(union > 0, tp / np.maximum(union, 1e-8), np.nan)
    present = union > 0
    mean_iou = float(np.nanmean(iou)) if present.any() else 1.0
    pixel_acc = float(tp.sum() / max(cm.sum(), 1))
    freq = support / max(cm.sum(), 1)
    fwiou = float(np.nansum(freq[present] * iou[present]))
    return {"dice_per_class": dice, "mean_dice": float(dice.mean()), "iou_per_class": iou,
            "mean_iou": mean_iou, "pixel_accuracy": pixel_acc, "fwiou": fwiou}


def _load_mask(path: str, level: Optional[str]) -> np.ndarray:
    with Image.open(path) as f:
        arr = np.asarray(f.convert("L"), np.uint8)
    return convert_labels(arr, level) if level else arr


def compute_metrics_on_folder(pred_dir: str, gt_dir: str, num_classes: int,
                              level: Optional[str] = None,
                              output_file: Optional[str] = None) -> Dict:
    """Per-case TP/FP/FN/TN → Dice and IoU per label, their means over the
    cases (NaN-aware), and ``foreground_mean``; written to ``output_file``.
    PNGs are paired by sorted name; ``level`` converts PUMA pixel codes."""
    preds = sorted(f for f in os.listdir(pred_dir) if f.lower().endswith(".png"))
    gts = sorted(f for f in os.listdir(gt_dir) if f.lower().endswith(".png"))
    if len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predictions vs {len(gts)} references")
    metric_per_case = []
    for pf, gf in zip(preds, gts):
        pred = _load_mask(os.path.join(pred_dir, pf), level)
        gt = _load_mask(os.path.join(gt_dir, gf), level)
        cm = confusion_matrix(np.clip(pred, 0, num_classes - 1),
                              np.clip(gt, 0, num_classes - 1), num_classes)
        tp = np.diag(cm).astype(float)
        fp = cm.sum(0) - tp
        fn = cm.sum(1) - tp
        tn = cm.sum() - tp - fp - fn
        metrics = {}
        for c in range(num_classes):
            denom = 2 * tp[c] + fp[c] + fn[c]
            metrics[str(c)] = {
                "Dice": float(2 * tp[c] / denom) if denom > 0 else float("nan"),
                "IoU": float(tp[c] / (tp[c] + fp[c] + fn[c]))
                if (tp[c] + fp[c] + fn[c]) > 0 else float("nan"),
                "TP": float(tp[c]), "FP": float(fp[c]),
                "FN": float(fn[c]), "TN": float(tn[c]),
                "n_pred": float(tp[c] + fp[c]), "n_ref": float(tp[c] + fn[c]),
            }
        metric_per_case.append({"prediction_file": pf, "reference_file": gf,
                                "metrics": metrics})
    mean: Dict[str, Dict[str, float]] = {}
    for c in range(num_classes):
        mean[str(c)] = {}
        for key in ("Dice", "IoU"):
            vals = [m["metrics"][str(c)][key] for m in metric_per_case]
            vals = [v for v in vals if not np.isnan(v)]
            mean[str(c)][key] = float(np.mean(vals)) if vals else float("nan")
    fg_dice = [mean[str(c)]["Dice"] for c in range(1, num_classes)
               if not np.isnan(mean[str(c)]["Dice"])]
    summary = {
        "metric_per_case": metric_per_case,
        "mean": mean,
        "foreground_mean": {"Dice": float(np.mean(fg_dice)) if fg_dice else float("nan")},
    }
    if output_file:
        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        with open(output_file, "w") as f:
            json.dump(summary, f, indent=2)
    return summary
