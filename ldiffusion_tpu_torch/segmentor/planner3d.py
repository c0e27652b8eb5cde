"""3D experiment planning: 3d_fullres / 3d_lowres / 3d_cascade_fullres (the
port's copy of ``ldiffusion_tpu/segmentor/planner3d.py:45-327``; reference
``default_experiment_planner.py:371-500``). The fullres target spacing is the
median spacing (the thin axis at its 10th percentile when anisotropic); the
patch starts at the median resampled shape and halves its largest axis until
one sample fits half the budget; an axis pools while it stays >= 4 after
halving and its spacing is within 2x of the finest, and a thin axis keeps
kernel 1 until then; ``3d_lowres`` + ``3d_cascade_fullres`` are added when the
fullres patch covers less than a quarter of the median volume, and then
fullres trains with batch dice. ``-overwrite_target_spacing`` replaces the
fullres spacing. The constants are the JAX package's (its 8 GiB activation
budget priced in bf16), so both packages write the same plans."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ldiffusion_tpu_torch.models.dynunet import RESENC_M_BLOCKS
from ldiffusion_tpu_torch.models.dynunet3d import DynUNet3DConfig

MAX_FEATURES_3D = 320          # reference: unet_max_num_features 3d
BASE_FEATURES = 32
MIN_EDGE = 4
MAX_POOLS = 5
HBM_BUDGET_BYTES = 8 * 1024 ** 3
MIN_BATCH = 2
ANISO_THRESHOLD = 3.0
LOWRES_PATCH_COVERAGE = 0.25   # reference :430 — lowres until patch covers
                               # >= 1/4 of the median volume (approximation of
                               # the iterative 1.01-spacing loop)


@dataclasses.dataclass(frozen=True)
class SegPlan3D:
    patch_size: Tuple[int, int, int]
    batch_size: int
    spacing: Tuple[float, float, float]
    features_per_stage: Tuple[int, ...]
    strides: Tuple[Tuple[int, int, int], ...]
    kernel_sizes: Tuple[Tuple[int, int, int], ...]
    n_conv_per_stage: int
    num_classes: int
    in_channels: int
    normalization: str
    median_shape: Tuple[int, int, int]
    batch_dice: bool
    deep_supervision: bool = True
    block_type: str = "plain"
    n_blocks_per_stage: Tuple[int, ...] = ()
    # cascade: name of the previous stage whose segmentation is appended as
    # one-hot input channels (reference plans "previous_stage")
    previous_stage: Optional[str] = None
    next_stage: Optional[str] = None

    def network_config(self) -> DynUNet3DConfig:
        # cascade input widens by the FOREGROUND labels only (reference
        # label_handling.py:296-297 determine_num_input_channels appends
        # len(foreground_labels) channels — background is not one-hotted)
        extra = self.num_classes - 1 if self.previous_stage else 0
        return DynUNet3DConfig(
            in_channels=self.in_channels + extra,
            num_classes=self.num_classes,
            features_per_stage=self.features_per_stage,
            strides=self.strides,
            kernel_sizes=self.kernel_sizes,
            n_conv_per_stage=self.n_conv_per_stage,
            deep_supervision=self.deep_supervision,
            block_type=self.block_type,
            n_blocks_per_stage=tuple(self.n_blocks_per_stage),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "SegPlan3D":
        with open(path) as f:
            d = json.load(f)
        for k in ("patch_size", "spacing", "features_per_stage", "median_shape",
                  "n_blocks_per_stage"):
            if k in d:
                d[k] = tuple(d[k])
        for k in ("strides", "kernel_sizes"):
            d[k] = tuple(tuple(s) for s in d[k])
        return cls(**d)


def _topology_3d(patch, spacing):
    """Per-axis pooling/kernels (``network_topology.py``
    get_pool_and_conv_props semantics): an axis pools while halving keeps it
    >= MIN_EDGE AND its current spacing is within 2x of the finest current
    spacing; thin axes (spacing > 2x finest) keep kernel 1 until pooling of
    the fine axes equalizes the spacings."""
    patch = list(patch)
    spacing = list(float(s) for s in spacing)
    strides = [(1, 1, 1)]
    kernels = [tuple(3 if spacing[a] <= 2 * min(spacing) else 1
                     for a in range(3))]
    for _ in range(MAX_POOLS):
        stride = [1, 1, 1]
        for a in range(3):
            if patch[a] // 2 >= MIN_EDGE and spacing[a] <= 2 * min(spacing):
                stride[a] = 2
        if all(s == 1 for s in stride):
            break
        for a in range(3):
            if stride[a] == 2:
                patch[a] //= 2
                spacing[a] *= 2
        strides.append(tuple(stride))
        kernels.append(tuple(3 if spacing[a] <= 2 * min(spacing) else 1
                             for a in range(3)))
    # shrink patch to divisibility by the cumulative pooling per axis
    total = [int(np.prod([s[a] for s in strides])) for a in range(3)]
    out_patch = []
    for a in range(3):
        p = int(patch[a] * total[a])
        out_patch.append(max(MIN_EDGE * total[a], p))
    n = len(strides)
    features = tuple(min(MAX_FEATURES_3D, BASE_FEATURES * 2 ** i) for i in range(n))
    return features, tuple(strides), tuple(kernels), tuple(out_patch)


def _estimate_bytes_3d(patch, features, strides, in_ch, num_classes,
                       n_conv=2) -> float:
    """bf16 activation elements through encoder+decoder (fwd+bwd factor)."""
    elems = float(np.prod(patch)) * in_ch
    shape = list(patch)
    total = 0.0
    for f, st in zip(features, strides):
        for a in range(3):
            shape[a] = max(1, shape[a] // st[a])
        total += 2 * n_conv * float(np.prod(shape)) * f   # enc + dec mirror
    total += float(np.prod(patch)) * num_classes * 2
    return (elems + total) * 2 * 6.0  # bf16, fwd+bwd+workspace factor


def _median_fingerprint_3d(fingerprint: Dict):
    shapes = np.asarray(fingerprint["shapes_after_crop"], np.int64)
    spacings = np.asarray(fingerprint.get(
        "spacings", [[1.0, 1.0, 1.0]] * len(shapes)), np.float64)
    median_shape = tuple(int(x) for x in np.median(shapes, axis=0))
    target = np.median(spacings, axis=0)
    # anisotropic-axis correction: 10th-percentile spacing on the thin axis
    # (reference determine_fullres_target_spacing, :302-330)
    worst = int(np.argmax(target))
    if target[worst] > ANISO_THRESHOLD * np.min(target):
        target[worst] = np.percentile(spacings[:, worst], 10)
    return median_shape, tuple(float(t) for t in target), shapes, spacings


def plan_experiment_3d(fingerprint: Dict, num_classes: int,
                       hbm_budget: int = HBM_BUDGET_BYTES,
                       max_batch: Optional[int] = None,
                       planner: str = "default",
                       spacing_override=None,
                       previous_stage: Optional[str] = None) -> SegPlan3D:
    """One 3D configuration (fullres when spacing_override is None)."""
    resenc = planner == "resenc"
    act_scale = 2.3 if resenc else 1.0
    median_shape, target, shapes, spacings = _median_fingerprint_3d(fingerprint)
    in_ch = int(fingerprint.get("num_channels", 1))
    vox_scale = 1.0  # dataset-voxel rescale for the 5% batch cap below
    if spacing_override is not None:
        scale = np.asarray(target) / np.asarray(spacing_override)
        median_shape = tuple(max(MIN_EDGE, int(round(m * s)))
                             for m, s in zip(median_shape, scale))
        target = tuple(float(s) for s in spacing_override)
        # the dataset voxel count shrinks with the coarser spacing; without
        # this the 3d_lowres batch cap is computed against fullres voxels
        # (the reference recomputes dataset voxels at the new spacing)
        vox_scale = float(np.prod(scale))

    patch = tuple(min(m, 256) for m in median_shape)
    features, strides, kernels, patch = _topology_3d(patch, target)
    while act_scale * _estimate_bytes_3d(patch, features, strides, in_ch,
                                         num_classes) > hbm_budget / MIN_BATCH \
            and max(patch) > 2 * MIN_EDGE:
        axis = int(np.argmax(patch))
        new_patch = list(patch)
        new_patch[axis] = max(MIN_EDGE, new_patch[axis] // 2)
        features, strides, kernels, patch = _topology_3d(tuple(new_patch), target)

    per_sample = act_scale * _estimate_bytes_3d(patch, features, strides,
                                                in_ch, num_classes)
    batch = max(MIN_BATCH, int(hbm_budget / per_sample))
    total_vox = float(np.sum(np.prod(shapes, axis=1))) * vox_scale
    cap = max(MIN_BATCH, int(round(0.05 * total_vox / float(np.prod(patch)))))
    batch = min(batch, cap)
    if max_batch:
        batch = min(batch, max_batch)

    return SegPlan3D(
        patch_size=tuple(patch), batch_size=batch, spacing=target,
        features_per_stage=features, strides=strides, kernel_sizes=kernels,
        n_conv_per_stage=2, num_classes=num_classes, in_channels=in_ch,
        normalization=fingerprint.get("normalization", "zscore"),
        median_shape=tuple(median_shape),
        # reference :437-441: fullres batch_dice=True ONLY when a 3d_lowres
        # stage exists; standalone 3d configs use sample dice.
        # plan_all_configurations flips the flag when it emits the lowres pair
        batch_dice=False,
        block_type="residual" if resenc else "plain",
        n_blocks_per_stage=tuple(RESENC_M_BLOCKS[:len(features)]) if resenc else (),
        previous_stage=previous_stage,
    )


def plan_all_configurations(fingerprint: Dict, num_classes: int,
                            hbm_budget: int = HBM_BUDGET_BYTES,
                            planner: str = "default",
                            target_spacing=None) -> Dict[str, SegPlan3D]:
    """All 3D configs for a dataset (reference ``plan_experiment`` emitting
    ``3d_fullres`` always and ``3d_lowres``+``3d_cascade_fullres`` when the
    fullres patch covers < 1/4 of the median volume).

    ``target_spacing``: the ``-overwrite_target_spacing`` override (reference
    ``plan_and_preprocess_entrypoints.py:54-62`` →
    ``determine_fullres_target_spacing`` short-circuit): replaces the
    fingerprint-derived fullres spacing; the lowres spacing is then derived
    from it, and the cascade shares the fullres plan, exactly as in the
    reference."""
    fullres = plan_experiment_3d(fingerprint, num_classes, hbm_budget,
                                 planner=planner,
                                 spacing_override=target_spacing)
    configs = {"3d_fullres": fullres}
    median_vol = float(np.prod(fullres.median_shape))
    patch_vol = float(np.prod(fullres.patch_size))
    if patch_vol < LOWRES_PATCH_COVERAGE * median_vol:
        # scale spacing uniformly so the lowres median shape ~ the patch
        # coverage target (closed form of the reference's 1.01^k loop)
        factor = (LOWRES_PATCH_COVERAGE * median_vol / patch_vol) ** (1 / 3)
        lowres_spacing = tuple(s * factor for s in fullres.spacing)
        lowres = plan_experiment_3d(fingerprint, num_classes, hbm_budget,
                                    planner=planner,
                                    spacing_override=lowres_spacing)
        # reference :437-441: when lowres exists, fullres trains with batch
        # dice and lowres with sample dice
        fullres = dataclasses.replace(fullres, batch_dice=True)
        configs["3d_fullres"] = fullres
        lowres = dataclasses.replace(lowres, next_stage="3d_cascade_fullres",
                                     batch_dice=False)
        cascade = dataclasses.replace(fullres, previous_stage="3d_lowres")
        configs["3d_lowres"] = lowres
        configs["3d_cascade_fullres"] = cascade
    return configs


def plan_and_preprocess_3d(volumes, labels, num_classes: int,
                           spacings=None, planner: str = "default",
                           hbm_budget: int = HBM_BUDGET_BYTES,
                           plans_path: Optional[str] = None,
                           preprocess: bool = True,
                           target_spacing=None,
                           preprocessor=None,
                           configurations=None,
                           fingerprint: Optional[Dict] = None):
    """The 3D plan-and-preprocess entry point (reference
    ``experiment_planning/plan_and_preprocess_api.py:18-138``):
    fingerprint → all 3D configurations → per-config preprocessed datasets
    (+ optional nnUNetPlans.json). Returns (configs, {name: dataset}).
    ``preprocess=False`` plans only (the --no_pp flag) and returns empty
    datasets.

    ``configurations``: preprocess only these configuration names (the
    reference ``-c`` flag, ``plan_and_preprocess_entrypoints.py:80-84``);
    requested names that do not exist for this dataset are skipped, as
    upstream. All configurations are still PLANNED (the plans file is
    whole either way); only the preprocessing fan-out is filtered.
    ``fingerprint``: a precomputed/cached fingerprint dict (the ``--clean``
    cache contract — callers pass the loaded ``dataset_fingerprint.json``
    to skip re-extraction).

    volumes: list of (Z, H, W, C) float arrays; labels: list of (Z, H, W).
    """
    from ldiffusion_tpu_torch.segmentor.fingerprint import extract_fingerprint_3d
    from ldiffusion_tpu_torch.segmentor.preprocess import DefaultPreprocessor, PreprocessedDataset

    fp = (fingerprint if fingerprint is not None
          else extract_fingerprint_3d(volumes, labels, spacings=spacings))
    configs = plan_all_configurations(fp, num_classes, hbm_budget,
                                      planner=planner,
                                      target_spacing=target_spacing)
    spacings = spacings or [(1.0, 1.0, 1.0)] * len(volumes)
    if preprocessor is None:
        preprocessor = DefaultPreprocessor()
    if configurations is not None:
        for c in configurations:
            if c not in configs and c != "2d":
                print(f"configuration {c} not found for this dataset — "
                      f"skipping (available: {sorted(configs)})")
    datasets = {}
    for name, plan in configs.items():
        if not preprocess:
            break
        if plan.previous_stage is not None:
            continue  # cascade stage consumes the lowres stage's output
        if configurations is not None and name not in configurations:
            continue  # reference -c: preprocess only the requested subset
        cases = {}
        for i, (vol, lab) in enumerate(zip(volumes, labels)):
            cases[f"case_{i:03d}"] = preprocessor.run_case_3d(
                vol, lab, num_classes, spacing=spacings[i],
                target_spacing=plan.spacing)
        datasets[name] = PreprocessedDataset(cases=cases)
    if plans_path:
        from ldiffusion_tpu_torch.segmentor.plans_file import save_plans_file

        save_plans_file(plans_path, configs)
    return configs, datasets
