"""The segmentor's training plan (counterpart of
``ldiffusion_tpu/segmentor/planner.py``): ``SegPlan``, read from and written
to the same ``plans.json``, and ``plan_experiment`` (fingerprint → plan,
reference ``default_experiment_planner.py:371-500``) for the default planner.

The constants are the JAX package's, including the 8 GiB activation budget
priced in bf16, so both packages write the same ``plans.json`` for the same
fingerprint. Planning against the H100's memory would be a feature the JAX
package lacks."""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, Tuple

import numpy as np

from ldiffusion_tpu_torch.models.dynunet import RESENC_M_BLOCKS, DynUNetConfig

MAX_FEATURES_2D = 512
BASE_FEATURES = 32
MIN_EDGE = 4          # stop pooling when an axis would drop below 4
MAX_POOLS = 6
HBM_BUDGET_BYTES = 8 * 1024 ** 3
BF16_BYTES = 2
TRAIN_ACT_FACTOR = 6.0  # fwd + bwd activations + workspace fudge
MIN_BATCH = 2
DATASET_COVERAGE_CAP = 0.05  # batch*patch ≤ 5% of dataset pixels


@dataclasses.dataclass(frozen=True)
class SegPlan:
    patch_size: Tuple[int, int]
    batch_size: int
    features_per_stage: Tuple[int, ...]
    strides: Tuple[int, ...]
    n_conv_per_stage: int
    num_classes: int
    in_channels: int
    normalization: str
    intensity_properties: Dict
    median_shape: Tuple[int, int]
    batch_dice: bool
    deep_supervision: bool = True
    block_type: str = "plain"
    n_blocks_per_stage: Tuple[int, ...] = ()
    remat_decoder: bool = False

    def network_config(self) -> DynUNetConfig:
        """``remat_decoder`` is the JAX package's memory knob; the port has
        no counterpart and ignores it."""
        return DynUNetConfig(in_channels=self.in_channels, num_classes=self.num_classes,
                             features_per_stage=self.features_per_stage,
                             strides=self.strides, n_conv_per_stage=self.n_conv_per_stage,
                             deep_supervision=self.deep_supervision,
                             block_type=self.block_type,
                             n_blocks_per_stage=tuple(self.n_blocks_per_stage))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "SegPlan":
        with open(path) as f:
            d = json.load(f)
        for k in ("patch_size", "features_per_stage", "strides", "median_shape",
                  "n_blocks_per_stage"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)


def _topology(patch: Tuple[int, int]):
    """Pool each axis while its edge stays ≥ MIN_EDGE after halving, at most
    MAX_POOLS times; shrink the patch to a multiple of the total pooling."""
    n_pools = min(MAX_POOLS, max(0, int(math.floor(math.log2(min(patch) / MIN_EDGE)))))
    n_stages = n_pools + 1
    factor = 2 ** n_pools
    patch = tuple(max(factor, (p // factor) * factor) for p in patch)
    features = tuple(min(MAX_FEATURES_2D, BASE_FEATURES * (2 ** i)) for i in range(n_stages))
    strides = (1,) + (2,) * n_pools
    return features, strides, patch


def _activation_elements(patch, features, strides, in_ch: int, num_classes: int,
                         n_conv: int = 2) -> float:
    """Activation elements of one sample through encoder and decoder."""
    total = 0.0
    h, w = patch
    spatial = []
    for f, s in zip(features, strides):
        h, w = h // s, w // s
        spatial.append((h, w))
        total += n_conv * h * w * f
    for i in range(len(features) - 2, -1, -1):
        h, w = spatial[i]
        total += (n_conv + 1) * h * w * features[i]
        total += h * w * num_classes
    total += patch[0] * patch[1] * in_ch
    return total


def _estimate_bytes(patch, features, strides, in_ch, num_classes) -> float:
    return _activation_elements(patch, features, strides, in_ch, num_classes) \
        * BF16_BYTES * TRAIN_ACT_FACTOR


def plan_experiment(fingerprint: Dict, num_classes: int,
                    planner: str = "default") -> SegPlan:
    """``ldiffusion_tpu/segmentor/planner.py:136-193``: the patch starts at
    the median cropped shape, halves its largest axis until one sample fits
    half the budget, and the batch fills the budget, capped at 5% of the
    dataset's pixels (at least 2). ``planner="resenc"``: the same rules with
    2.3× the activations, and the residual encoder with the ResEnc-M
    schedule."""
    if planner not in ("default", "resenc"):
        raise ValueError(f"planner={planner!r}: use 'default' or 'resenc'")
    resenc = planner == "resenc"
    act_scale = 2.3 if resenc else 1.0
    shapes = np.asarray(fingerprint["shapes_after_crop"], np.int64)
    median_shape = tuple(int(x) for x in np.median(shapes, axis=0))
    in_ch = int(fingerprint.get("num_channels", 3))

    features, strides, patch = _topology(tuple(median_shape))
    while act_scale * _estimate_bytes(patch, features, strides, in_ch, num_classes) \
            > HBM_BUDGET_BYTES / MIN_BATCH and min(patch) > 2 * MIN_EDGE:
        axis = int(np.argmax(patch))
        new_patch = list(patch)
        new_patch[axis] = max(MIN_EDGE, new_patch[axis] // 2)
        features, strides, patch = _topology(tuple(new_patch))

    per_sample = act_scale * _estimate_bytes(patch, features, strides, in_ch, num_classes)
    batch = max(MIN_BATCH, int(HBM_BUDGET_BYTES / per_sample))
    total_px = float(np.sum(shapes[:, 0] * shapes[:, 1]))
    cap = max(MIN_BATCH, int(round(DATASET_COVERAGE_CAP * total_px /
                                   float(patch[0] * patch[1]))))
    batch = min(batch, cap)
    return SegPlan(
        patch_size=patch, batch_size=batch, features_per_stage=features, strides=strides,
        n_conv_per_stage=2, num_classes=num_classes, in_channels=in_ch,
        normalization="zscore_image",
        intensity_properties=fingerprint.get("foreground_intensity_properties_per_channel", {}),
        median_shape=median_shape, batch_dice=True,
        block_type="residual" if resenc else "plain",
        n_blocks_per_stage=tuple(RESENC_M_BLOCKS[:len(features)]) if resenc else ())
