"""Segmentation metrics (counterpart of ``ldiffusion_tpu/evaluate.py``,
labels regime): a confusion matrix per image, Dice/IoU/pixel
accuracy/FWIoU from it, the folder report and its CLI (reference
``evaluate.py:1-139``), the instance metrics PQ and AJI, and the
nnU-Net-format validation ``summary.json`` (reference
``evaluate_predictions.py:77-264``), label- or region-keyed with the ground
truth's ignore pixels left out (``ldiffusion_tpu/evaluate.py:257-382``).

    python -m ldiffusion_tpu_torch.evaluate --pred-dir P --gt-dir G --num-classes 11 --level cell
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

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


MASK_ENDINGS = (".png", ".npy")


def read_mask(path: str) -> np.ndarray:
    """A mask file: a PNG as uint8, a ``.npy`` volume as int64
    (``ldiffusion_tpu/evaluate.py:62-70``)."""
    if path.lower().endswith(".npy"):
        return np.load(path).astype(np.int64)
    with Image.open(path) as f:
        return np.asarray(f.convert("L"), np.uint8)


def _load_mask(path: str, level: Optional[str]) -> np.ndarray:
    arr = read_mask(path)
    return convert_labels(arr, level) if level else arr


def evaluate(pred_dir: str, gt_dir: str, num_classes: int, level: Optional[str] = "tissue",
             output_dir: str = "eval_report") -> Dict:
    """The folder report (reference ``evaluate.py:48-126``): PNGs paired by
    sorted name; ground truth in the PUMA pixel code (converted with
    ``level``), predictions as class ids; a prediction of another size is resized to the ground truth's with NEAREST.
    Per-image and mean Dice/IoU/pixel accuracy/FWIoU, pooled per-class
    metrics, written to ``output_dir/metrics_<timestamp>.txt``."""
    preds = sorted(f for f in os.listdir(pred_dir) if f.lower().endswith(".png"))
    gts = sorted(f for f in os.listdir(gt_dir) if f.lower().endswith(".png"))
    if len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predictions vs {len(gts)} references")
    per_image: List[Dict] = []
    total_cm = np.zeros((num_classes, num_classes), np.int64)
    for pf, gf in zip(preds, gts):
        pred = _load_mask(os.path.join(pred_dir, pf), None)
        gt = _load_mask(os.path.join(gt_dir, gf), level)
        if pred.shape != gt.shape:
            pred = np.asarray(
                Image.fromarray(pred).resize((gt.shape[1], gt.shape[0]), Image.NEAREST))
        cm = confusion_matrix(np.clip(pred, 0, num_classes - 1),
                              np.clip(gt, 0, num_classes - 1), num_classes)
        total_cm += cm
        per_image.append({"file": pf, **metrics_from_cm(cm)})
    mean = {
        "mean_dice": float(np.mean([m["mean_dice"] for m in per_image])),
        "mean_iou": float(np.mean([m["mean_iou"] for m in per_image])),
        "mean_pixel_accuracy": float(np.mean([m["pixel_accuracy"] for m in per_image])),
        "mean_fwiou": float(np.mean([m["fwiou"] for m in per_image])),
    }
    pooled = metrics_from_cm(total_cm)
    report = {"per_image": per_image, "mean": mean, "pooled": pooled,
              "num_images": len(per_image)}
    os.makedirs(output_dir, exist_ok=True)
    path = os.path.join(output_dir, f"metrics_{time.strftime('%Y%m%d_%H%M%S')}.txt")
    with open(path, "w") as f:
        f.write(f"Evaluation report ({len(per_image)} images)\n")
        f.write(f"pred: {pred_dir}\ngt:   {gt_dir}\n\n")
        for k, v in mean.items():
            f.write(f"{k}: {v:.4f}\n")
        f.write("\nPer-class (pooled):\n")
        for c in range(num_classes):
            iou = pooled["iou_per_class"][c]
            f.write(f"  class {c}: dice={pooled['dice_per_class'][c]:.4f} "
                    f"iou={'n/a' if np.isnan(iou) else f'{iou:.4f}'}\n")
        f.write("\nPer-image:\n")
        for m in per_image:
            f.write(f"  {m['file']}: dice={m['mean_dice']:.4f} iou={m['mean_iou']:.4f} "
                    f"pa={m['pixel_accuracy']:.4f} fwiou={m['fwiou']:.4f}\n")
    report["report_path"] = path
    return report


def _region_mask(seg: np.ndarray, region_or_label) -> np.ndarray:
    """reference ``evaluate_predictions.py:region_or_label_to_mask``."""
    if isinstance(region_or_label, (tuple, list)):
        return np.isin(seg, np.asarray(region_or_label))
    return seg == region_or_label


def _entry(tp, fp, fn, tn) -> Dict:
    denom = 2 * tp + fp + fn
    return {"Dice": float(2 * tp / denom) if denom > 0 else float("nan"),
            "IoU": float(tp / (tp + fp + fn)) if (tp + fp + fn) > 0 else float("nan"),
            "TP": float(tp), "FP": float(fp), "FN": float(fn), "TN": float(tn),
            "n_pred": float(tp + fp), "n_ref": float(tp + fn)}


def _summary(metric_per_case, keys, fg_keys, output_file) -> Dict:
    """Case means of Dice and IoU per key (NaN-aware) and the foreground mean."""
    mean: Dict[str, Dict[str, float]] = {}
    for k in keys:
        mean[k] = {}
        for key in ("Dice", "IoU"):
            vals = [m["metrics"][k][key] for m in metric_per_case]
            vals = [v for v in vals if not np.isnan(v)]
            mean[k][key] = float(np.mean(vals)) if vals else float("nan")
    fg = [mean[k]["Dice"] for k in fg_keys if not np.isnan(mean[k]["Dice"])]
    summary = {"metric_per_case": metric_per_case, "mean": mean,
               "foreground_mean": {"Dice": float(np.mean(fg)) if fg else float("nan")}}
    if output_file:
        os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
        with open(output_file, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


def compute_metrics_on_folder(pred_dir: str, gt_dir: str, num_classes: int,
                              level: Optional[str] = None,
                              output_file: Optional[str] = None,
                              regions_or_labels=None,
                              ignore_label: Optional[int] = None) -> Dict:
    """Per-case TP/FP/FN/TN → Dice and IoU per label, their means over the
    cases (NaN-aware), and ``foreground_mean``; written to ``output_file``.
    PNGs and ``.npy`` volumes are paired by sorted name; ``level`` converts
    PUMA pixel codes.
    ``regions_or_labels`` (label ints and/or region tuples) scores each entry
    by membership masks, keyed ``str(entry)``, without the ground truth's
    ``ignore_label`` pixels; otherwise every class of a confusion matrix."""
    preds = sorted(f for f in os.listdir(pred_dir) if f.lower().endswith(MASK_ENDINGS))
    gts = sorted(f for f in os.listdir(gt_dir) if f.lower().endswith(MASK_ENDINGS))
    if len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predictions vs {len(gts)} references")
    if regions_or_labels is not None:
        metric_per_case = []
        for pf, gf in zip(preds, gts):
            pred = _load_mask(os.path.join(pred_dir, pf), level)
            gt = _load_mask(os.path.join(gt_dir, gf), level)
            use = np.ones(gt.shape, bool) if ignore_label is None else gt != ignore_label
            metrics = {}
            for r in regions_or_labels:
                mr, mp = _region_mask(gt, r), _region_mask(pred, r)
                metrics[str(r)] = _entry(np.sum(mr & mp & use), np.sum(~mr & mp & use),
                                         np.sum(mr & ~mp & use), np.sum(~mr & ~mp & use))
            metric_per_case.append({"prediction_file": pf, "reference_file": gf,
                                    "metrics": metrics})
        keys = [str(r) for r in regions_or_labels]
        return _summary(metric_per_case, keys, keys, output_file)
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
        metrics = {str(c): _entry(tp[c], fp[c], fn[c], tn[c]) for c in range(num_classes)}
        metric_per_case.append({"prediction_file": pf, "reference_file": gf,
                                "metrics": metrics})
    keys = [str(c) for c in range(num_classes)]
    return _summary(metric_per_case, keys, keys[1:], output_file)


# ---------------------------------------------------------------------------
# instance metrics (PQ, AJI)
# ---------------------------------------------------------------------------

def _pairwise_intersections(pred: np.ndarray, gt: np.ndarray):
    """(inter (n_gt, n_pred) pixel overlaps, pred areas, gt areas, pred ids,
    gt ids) of two instance maps (0 = background), from one bincount over
    the joint densified ids."""
    pred_ids = np.unique(pred)
    pred_ids = pred_ids[pred_ids != 0]
    gt_ids = np.unique(gt)
    gt_ids = gt_ids[gt_ids != 0]
    pred_map = np.zeros(int(pred.max()) + 1, np.int64)
    pred_map[pred_ids] = np.arange(1, len(pred_ids) + 1)
    gt_map = np.zeros(int(gt.max()) + 1, np.int64)
    gt_map[gt_ids] = np.arange(1, len(gt_ids) + 1)
    p = pred_map[pred.astype(np.int64)]
    g = gt_map[gt.astype(np.int64)]
    n_pred, n_gt = len(pred_ids), len(gt_ids)
    counts = np.bincount(g.reshape(-1) * (n_pred + 1) + p.reshape(-1),
                         minlength=(n_gt + 1) * (n_pred + 1))
    table = counts.reshape(n_gt + 1, n_pred + 1)
    return table[1:, 1:], table[:, 1:].sum(axis=0), table[1:, :].sum(axis=1), pred_ids, gt_ids


def panoptic_quality(pred: np.ndarray, gt: np.ndarray) -> Dict:
    """Panoptic Quality (Kirillov et al. 2019): PQ = SQ · RQ, with the raw
    counts. Matches at IoU > 0.5 are unique, so no assignment is solved."""
    inter, pred_areas, gt_areas, _, _ = _pairwise_intersections(pred, gt)
    n_gt, n_pred = inter.shape
    if n_gt == 0 and n_pred == 0:
        return {"pq": 1.0, "sq": 1.0, "rq": 1.0, "tp": 0, "fp": 0, "fn": 0, "iou_sum": 0.0}
    union = gt_areas[:, None] + pred_areas[None, :] - inter
    iou = inter / np.maximum(union, 1)
    matched = iou > 0.5
    tp = int(matched.sum())
    fp = int(n_pred - matched.any(axis=0).sum())
    fn = int(n_gt - matched.any(axis=1).sum())
    iou_sum = float(iou[matched].sum())
    denom = tp + 0.5 * fp + 0.5 * fn
    return {"pq": float(iou_sum / denom) if denom > 0 else 0.0,
            "sq": float(iou_sum / tp) if tp > 0 else 0.0,
            "rq": float(tp / denom) if denom > 0 else 0.0,
            "tp": tp, "fp": fp, "fn": fn, "iou_sum": iou_sum}


def aggregated_jaccard_index(pred: np.ndarray, gt: np.ndarray) -> float:
    """AJI (Kumar et al. 2017): each ground-truth instance claims its best-IoU
    prediction; aggregate intersection over aggregate union, unclaimed
    predictions added to the union. A prediction may be claimed by several
    ground-truth instances, as in the MoNuSeg / HoVer-Net implementation."""
    inter, pred_areas, gt_areas, _, _ = _pairwise_intersections(pred, gt)
    n_gt, n_pred = inter.shape
    if n_gt == 0:
        return 1.0 if n_pred == 0 else 0.0
    union = gt_areas[:, None] + pred_areas[None, :] - inter
    iou = inter / np.maximum(union, 1)
    used = np.zeros(n_pred, bool)
    c = u = 0.0
    for i in range(n_gt):
        j = int(np.argmax(iou[i])) if n_pred else -1
        if n_pred and inter[i, j] > 0:
            c += inter[i, j]
            u += union[i, j]
            used[j] = True
        else:
            u += gt_areas[i]
    u += pred_areas[~used].sum()
    return float(c / u) if u > 0 else 0.0


def evaluate_instances(preds, gts) -> Dict:
    """PQ pooled over the images (TP/FP/FN/IoU sums, as COCO panoptic) and
    the mean AJI."""
    tp = fp = fn = 0
    iou_sum = 0.0
    ajis = []
    for p, g in zip(preds, gts):
        m = panoptic_quality(p, g)
        tp, fp, fn = tp + m["tp"], fp + m["fp"], fn + m["fn"]
        iou_sum += m["iou_sum"]
        ajis.append(aggregated_jaccard_index(p, g))
    denom = tp + 0.5 * fp + 0.5 * fn
    return {"pq": float(iou_sum / denom) if denom > 0 else 1.0,
            "sq": float(iou_sum / tp) if tp > 0 else 0.0,
            "rq": float(tp / denom) if denom > 0 else 0.0,
            "tp": tp, "fp": fp, "fn": fn,
            "mean_aji": float(np.mean(ajis)) if ajis else 1.0}


def main(argv=None):
    p = argparse.ArgumentParser(description="Offline segmentation metrics "
                                            "(Dice/IoU/mPA/FWIoU)")
    p.add_argument("--pred-dir", required=True)
    p.add_argument("--gt-dir", required=True)
    p.add_argument("--num-classes", type=int, required=True)
    p.add_argument("--level", default="tissue", choices=["tissue", "cell"])
    p.add_argument("--output-dir", default="eval_report")
    args = p.parse_args(argv)
    report = evaluate(args.pred_dir, args.gt_dir, args.num_classes, args.level,
                      output_dir=args.output_dir)
    print(f"mean dice {report['mean']['mean_dice']:.4f}  "
          f"mean IoU {report['mean']['mean_iou']:.4f}  "
          f"mPA {report['mean']['mean_pixel_accuracy']:.4f}  "
          f"FWIoU {report['mean']['mean_fwiou']:.4f}")
    print(f"report: {report['report_path']}")


if __name__ == "__main__":
    main()
