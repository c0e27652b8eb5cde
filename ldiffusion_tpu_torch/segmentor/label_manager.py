"""Label semantics: plain labels, label regions, the ignore label
(counterpart of ``ldiffusion_tpu/segmentor/label_manager.py``; reference
``label_handling.py:21-322``). A dataset.json ``labels`` dict maps names to
ints (plain: softmax over the labels) or to int tuples (regions: one sigmoid
head a region, painted in ``regions_class_order``); an ``ignore`` label is
left out of losses and metrics. numpy, float64 nonlinearities, as in the JAX
package, so both give the same masks from the same logits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

LabelValue = Union[int, Tuple[int, ...], List[int]]


@dataclasses.dataclass
class LabelManager:
    label_dict: Dict[str, LabelValue]
    regions_class_order: Optional[Sequence[int]] = None

    def __post_init__(self):
        self._ignore = None
        for name, v in self.label_dict.items():
            if name.lower() == "ignore":
                if not isinstance(v, int):
                    raise ValueError("the ignore label must be a plain int")
                self._ignore = int(v)
        self._regions: List[Tuple[int, ...]] = []
        self._plain: List[int] = []
        for name, v in self.label_dict.items():
            if name.lower() == "ignore":
                continue
            if isinstance(v, (tuple, list)):
                self._regions.append(tuple(int(x) for x in v))
            else:
                self._plain.append(int(v))
        if self.has_regions:
            if self.regions_class_order is None:
                raise ValueError("regions need regions_class_order")

    # ------------------------------------------------------------------
    @property
    def has_regions(self) -> bool:
        return len(self._regions) > 0

    @property
    def has_ignore_label(self) -> bool:
        return self._ignore is not None

    @property
    def ignore_label(self) -> Optional[int]:
        return self._ignore

    @property
    def all_labels(self) -> List[int]:
        if self.has_regions:
            vals = set()
            for r in self._regions:
                vals.update(r)
            return sorted(vals)
        return sorted(self._plain)

    @property
    def foreground_labels(self) -> List[int]:
        return [l for l in self.all_labels if l != 0]

    @property
    def num_segmentation_heads(self) -> int:
        """Output channels of the network: regions → one sigmoid channel per
        region; plain → softmax over labels."""
        if self.has_regions:
            return len(self._regions)
        return len(self._plain)

    @property
    def regions(self) -> List[Tuple[int, ...]]:
        return list(self._regions)

    @property
    def foreground_regions(self) -> List[Tuple[int, ...]]:
        """Region tuples for evaluation (reference ``label_handling.py``
        ``foreground_regions`` — used by ``compute_metrics_on_folder2``)."""
        return list(self._regions)

    @property
    def labels_or_regions_for_eval(self):
        """What the validation summary scores per entry: region tuples for
        the regions regime, foreground label ints otherwise (reference
        ``evaluate_predictions.py:compute_metrics_on_folder2``)."""
        return self.foreground_regions if self.has_regions \
            else self.foreground_labels

    # ------------------------------------------------------------------
    def apply_inference_nonlin(self, logits: np.ndarray) -> np.ndarray:
        """(H, W, C) logits → probabilities (sigmoid for regions, softmax
        otherwise; reference ``:128-142``)."""
        x = logits.astype(np.float64)
        if self.has_regions:
            return 1.0 / (1.0 + np.exp(-x))
        x = x - x.max(axis=-1, keepdims=True)
        e = np.exp(x)
        return e / e.sum(axis=-1, keepdims=True)

    def convert_probabilities_to_segmentation(self, probs: np.ndarray) -> np.ndarray:
        """reference ``:143-176``: regions paint in regions_class_order where
        prob > 0.5; plain take argmax mapped through label values."""
        if self.has_regions:
            seg = np.zeros(probs.shape[:-1], np.uint8)
            for i, cls in enumerate(self.regions_class_order):
                seg[probs[..., i] > 0.5] = cls
            return seg
        labels = np.asarray(sorted(self._plain), np.uint8)
        return labels[np.argmax(probs, axis=-1)]

    def convert_logits_to_segmentation(self, logits: np.ndarray) -> np.ndarray:
        return self.convert_probabilities_to_segmentation(
            self.apply_inference_nonlin(logits))

    # ------------------------------------------------------------------
    def seg_to_training_target(self, seg: np.ndarray):
        """Plain: identity (+ ignore → loss mask). Regions: (H, W, R) binary
        region maps (reference one-hot conversion ``:248-281``).
        Returns (target, loss_mask or None)."""
        loss_mask = None
        if self.has_ignore_label:
            loss_mask = (seg != self._ignore).astype(np.float32)
        if not self.has_regions:
            tgt = seg.copy()
            if self.has_ignore_label:
                tgt[seg == self._ignore] = 0
            return tgt, loss_mask
        maps = np.stack([np.isin(seg, r).astype(np.float32) for r in self._regions],
                        axis=-1)
        return maps, loss_mask


def label_manager_from_dataset_json(dataset_json: Dict) -> LabelManager:
    return LabelManager(dataset_json["labels"],
                        dataset_json.get("regions_class_order"))
