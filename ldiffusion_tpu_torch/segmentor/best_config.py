"""Choosing the best configuration, and ensembling predictions (counterpart
of ``ldiffusion_tpu/segmentor/best_config.py``; reference
``evaluation/find_best_configuration.py``, ``ensembling/ensemble.py``):
score each trained configuration by the foreground-mean Dice of its
cross-validation predictions, score each pair's ensemble (the mean of their
probabilities), pick the winner, decide its postprocessing, and write
``inference_information.json``. The folds' sliding windows run on the card
unless the caller asks for the CPU (``device``)."""
from __future__ import annotations

import glob
import itertools
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ldiffusion_tpu_torch.evaluate import _region_mask, confusion_matrix, metrics_from_cm
from ldiffusion_tpu_torch.segmentor.postprocess import determine_postprocessing


def ensemble_probabilities(prob_list: Sequence[np.ndarray]) -> np.ndarray:
    """The mean of the models' probability maps (reference ``ensemble.py:206``)."""
    return np.mean(np.stack(prob_list), axis=0)


def _fg_dice(preds: Sequence[np.ndarray], gts: Sequence[np.ndarray], num_classes: int,
             label_manager=None) -> float:
    """Foreground-mean Dice over every case: with a label manager, per label
    or region by set membership without the ignore label's pixels (reference
    ``evaluate_predictions.py:77-120``); else from one pooled confusion matrix."""
    if len(preds) != len(gts):
        raise ValueError(f"{len(preds)} predictions for {len(gts)} ground truths")
    if label_manager is not None:
        ig = label_manager.ignore_label
        dices = []
        for r in label_manager.labels_or_regions_for_eval:
            tp = fp = fn = 0.0
            for p, g in zip(preds, gts):
                use = np.ones(g.shape, bool) if ig is None else g != ig
                mr, mp = _region_mask(g, r), _region_mask(p, r)
                tp += float(np.sum(mr & mp & use))
                fp += float(np.sum(~mr & mp & use))
                fn += float(np.sum(mr & ~mp & use))
            if 2 * tp + fp + fn > 0:
                dices.append(2 * tp / (2 * tp + fp + fn))
        return float(np.mean(dices)) if dices else float("nan")
    cm = np.zeros((num_classes, num_classes), np.int64)
    for p, g in zip(preds, gts):
        cm += confusion_matrix(p, g, num_classes)
    return float(np.mean(metrics_from_cm(cm)["dice_per_class"][1:]))


def find_best_configuration(config_probs: Dict[str, List[np.ndarray]], gts: Sequence[np.ndarray],
                            num_classes: int, allow_ensembling: bool = True,
                            output_json: Optional[str] = None, label_manager=None) -> Dict:
    """``config_probs``: {configuration: per-case (*spatial, C) probabilities}.
    With a ``label_manager`` the maps become segmentations by the regime's
    rule (regions painted in order) and score with region- and ignore-aware
    Dice. Returns the inference information (written to ``output_json``
    when given): the best configuration, every score, whether it is an
    ensemble and of which members, and its postprocessing."""
    results: Dict[str, float] = {}
    seg_cache: Dict[str, List[np.ndarray]] = {}

    def segs_of(probs):
        if label_manager is not None:
            return [label_manager.convert_probabilities_to_segmentation(p) for p in probs]
        return [np.argmax(p, axis=-1).astype(np.uint8) for p in probs]

    for name, probs in config_probs.items():
        if len(probs) != len(gts):
            raise ValueError(f"config {name}: {len(probs)} cases vs {len(gts)} GTs")
        seg_cache[name] = segs_of(probs)
        results[name] = _fg_dice(seg_cache[name], gts, num_classes, label_manager)
    if allow_ensembling and len(config_probs) > 1:
        for a, b in itertools.combinations(sorted(config_probs), 2):
            name = f"ensemble___{a}___{b}"
            seg_cache[name] = segs_of([ensemble_probabilities([pa, pb]) for pa, pb in
                                       zip(config_probs[a], config_probs[b])])
            results[name] = _fg_dice(seg_cache[name], gts, num_classes, label_manager)

    best = max(results, key=results.get)
    # the postprocessing's confusion matrix covers every value of the
    # (painted) predictions and ground truths
    n_pp = num_classes
    if label_manager is not None:
        vals = list(label_manager.all_labels)
        if label_manager.has_ignore_label:
            vals.append(label_manager.ignore_label)
        n_pp = max(vals) + 1
    ensembled = best.startswith("ensemble___")
    info = {
        "best_configuration": best,
        "all_results": results,
        "ensembling_used": ensembled,
        "members": best.split("___")[1:] if ensembled else [best],
        "postprocessing": determine_postprocessing(seg_cache[best], list(gts), n_pp),
        "score": results[best],
    }
    if output_json:
        os.makedirs(os.path.dirname(output_json) or ".", exist_ok=True)
        with open(output_json, "w") as f:
            json.dump(info, f, indent=2)
    return info


def collect_fold_cv_predictions(plan, dataset_dir: str, pp_dataset, use_mirroring: bool = True,
                                mirror_axes=None, label_manager=None, device=None):
    """One configuration's cross-validation probabilities: each ``fold_<f>``
    checkpoint predicts its own validation split of ``splits_final.json``
    (both in ``dataset_dir``) from the preprocessed store, which is
    normalised already (``normalize=False``). Returns (case keys,
    probabilities, ground truths), one entry per validation case of a
    trained fold."""
    from ldiffusion_tpu_torch.segmentor.predictor import (
        SlidingWindowPredictor,
        find_fold_checkpoints,
    )
    from ldiffusion_tpu_torch.segmentor.splits import load_or_create_splits

    splits = load_or_create_splits(os.path.join(dataset_dir, "splits_final.json"),
                                   pp_dataset.keys())
    keys, probs, gts = [], [], []
    for d in sorted(glob.glob(os.path.join(dataset_dir, "fold_*"))):
        fold = int(os.path.basename(d).split("_")[1])
        if fold >= len(splits):
            continue
        try:
            ckpt = find_fold_checkpoints(dataset_dir, folds=[fold])[0]
        except FileNotFoundError:
            continue
        # the regime's nonlinearity (sigmoid for regions) feeds the painted scoring
        predictor = SlidingWindowPredictor.from_checkpoints(
            plan, [ckpt], use_mirroring=use_mirroring, mirror_axes=mirror_axes,
            label_manager=label_manager, device=device)
        for k in splits[fold]["val"]:
            case = pp_dataset[k]
            keys.append(k)
            probs.append(predictor.predict_probabilities(np.asarray(case.data, np.float32),
                                                         normalize=False))
            gts.append(np.maximum(case.seg, 0))
    return keys, probs, gts


def find_best_configuration_from_folds(configs, pp_dataset, num_classes: int,
                                       allow_ensembling: bool = True,
                                       output_json: Optional[str] = None,
                                       use_mirroring: bool = True, mirror_axes=None,
                                       label_manager=None, device=None) -> Dict:
    """``find_best_configuration`` over the configurations' cross-validation
    predictions. ``configs``: {name: (plan, results folder with fold_*
    checkpoints and splits_final.json)}; every configuration must cover the
    same cases."""
    config_probs: Dict[str, List] = {}
    gts = None
    for name, (plan, dataset_dir) in configs.items():
        keys, probs, fold_gts = collect_fold_cv_predictions(
            plan, dataset_dir, pp_dataset, use_mirroring=use_mirroring,
            mirror_axes=mirror_axes, label_manager=label_manager, device=device)
        order = np.argsort(keys)
        config_probs[name] = [probs[i] for i in order]
        g = [fold_gts[i] for i in order]
        if gts is not None and not (len(gts) == len(g) and all(
                np.array_equal(a, b) for a, b in zip(gts, g))):
            raise ValueError("configurations disagree on CV case coverage")
        gts = g
    return find_best_configuration(config_probs, gts, num_classes,
                                   allow_ensembling=allow_ensembling, output_json=output_json,
                                   label_manager=label_manager)
