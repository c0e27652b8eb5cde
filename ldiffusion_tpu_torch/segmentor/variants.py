"""Trainer variants (counterpart of ``ldiffusion_tpu/segmentor/variants.py``;
reference ``training/nnUNetTrainer/variants/**``): each of the reference's
trainer class names is a recipe, data rather than a subclass
(SegmentorTrainConfig and AugmentConfig overrides, the loss, the learning-rate
schedule, the optimizer, the norm layer, the sampling mode).
``get_variant(name)`` accepts exactly ``KNOWN_VARIANT_NAMES`` and raises on
any other name, as the reference fails on an unknown trainer
(``run_training.py:32-68``): a typo never trains the default recipe.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional, Tuple

from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.data.augment import AugmentConfig


@dataclasses.dataclass(frozen=True)
class TrainerVariant:
    name: str
    config: SegmentorTrainConfig
    augment: AugmentConfig
    loss: str = "dc_and_ce"          # dc_and_ce | dice | ce | topk10 |
                                     # dc_and_topk10 | dc_and_focal
    lr_schedule: str = "poly"        # poly | cosine | constant
    optimizer: str = "sgd"           # sgd | adam | adan
    mirror_tta: bool = True
    # network norm layer (reference nnUNetTrainerBN swaps InstanceNorm for
    # BatchNorm, variants/network_architecture/nnUNetTrainerBN.py)
    norm: str = "instance"           # instance | batch
    # per-sample bernoulli fg-oversampling instead of the positional batch
    # rule (reference variants/sampling/nnUNetTrainer_probabilisticOversampling.py)
    probabilistic_oversampling: bool = False
    oversample_fg: Optional[float] = None  # override of config.oversample_fg
    # benchmark trainers: 5 epochs; noDataLoading feeds one synthetic batch
    # (reference variants/benchmarking/*)
    benchmark: bool = False
    no_data_loading: bool = False
    # loss knobs (reference nnUNetTrainerDiceCELoss_noSmooth / Topk10LossLS01)
    dice_smooth: float = 1e-5
    label_smoothing: float = 0.0
    # spatial-transform resampling order 0 (reference nnUNetTrainerDAOrd0:
    # order_resampling_data=0; *Segord0/_DASegOrd0: order_resampling_seg=0 —
    # seg already resamples nearest here, so only the data order is a knob)
    spatial_order0_data: bool = False
    # dimension-dependent mirror restriction (reference
    # nnUNetTrainer_onlyMirror01: axes (0, 1) for 3D but (0,) for 2D —
    # the trainer applies this override when the plan is 2D)
    mirror_axes_2d: Optional[Tuple[int, ...]] = None


_NO_DA = AugmentConfig(p_rotation=0, p_scaling=0, p_noise=0, p_blur=0,
                       p_brightness=0, p_contrast=0, p_lowres=0,
                       p_gamma_invert=0, p_gamma=0, p_mirror=0)

# DA5: the "more aggressive DA" recipe (reference
# variants/data_augmentation/nnUNetTrainerDA5.py:106-264, full transform
# list): spatial p_rot 0.4 / p_scale 0.2 w/ scale (0.7, 1.43), rot90 +
# transpose p 0.5 (square patches), OneOf(median (2,8) | blur (0.3, 1.5))
# p 0.2, noise p 0.1, ADDITIVE brightness N(0, 0.5) p 0.1,
# OneOf(contrast (0.5, 2) preserve-range T|F) p 0.2, lowres p 0.15, gamma
# (0.7, 1.5) BOTH inverted p 0.1 each, mirror, blank rectangles p 0.4,
# brightness-gradient-additive p 0.3, local gamma p 0.3, sharpening p 0.2.
_DA5 = AugmentConfig(p_rotation=0.4, p_scaling=0.2, scale_range=(0.7, 1.43),
                     # DA5 feeds its TRUE scale range into the initial-patch
                     # formula (nnUNetTrainerDA5.py:82-84), unlike the base
                     # trainer's legacy (0.85, 1.25)
                     initial_scale_range=(0.7, 1.43),
                     p_rot90=0.5, p_transpose=0.5,
                     p_median=0.2, p_noise=0.1,
                     p_blur=0.2, blur_sigma=(0.3, 1.5),
                     p_brightness=0.1, brightness_additive_sigma=0.5,
                     p_contrast=0.2, contrast_range=(0.5, 2.0),
                     contrast_clip_half=True,
                     p_lowres=0.15, lowres_zoom=(0.25, 1.0),
                     p_gamma_invert=0.1, p_gamma=0.1, gamma2_invert=True,
                     p_mirror=0.5,
                     p_blank_rect=0.4, p_brightness_gradient=0.3,
                     p_local_gamma=0.3, p_sharpen=0.2)


# The full reference variant-class matrix
# (training/nnUNetTrainer/variants/**) plus the base trainer names.
KNOWN_VARIANT_NAMES = (
    "default",
    "nnUNetTrainer",
    # benchmarking
    "nnUNetTrainerBenchmark_5epochs",
    "nnUNetTrainerBenchmark_5epochs_noDataLoading",
    # data augmentation
    "nnUNetTrainerDA5",
    "nnUNetTrainerDA5ord0",
    "nnUNetTrainerDA5Segord0",
    "nnUNetTrainerDA5_10epochs",
    "nnUNetTrainerDAOrd0",
    "nnUNetTrainer_DASegOrd0",
    "nnUNetTrainerNoDA",
    "nnUNetTrainerNoMirroring",
    "nnUNetTrainer_onlyMirror01",
    # loss
    "nnUNetTrainerCELoss",
    "nnUNetTrainerCELoss_5epochs",
    "nnUNetTrainerDiceLoss",
    "nnUNetTrainerDiceCELoss_noSmooth",
    "nnUNetTrainerTopk10Loss",
    "nnUNetTrainerTopk10LossLS01",
    "nnUNetTrainerDiceTopK10Loss",
    # lr schedule
    "nnUNetTrainerCosAnneal",
    # network architecture
    "nnUNetTrainerBN",
    # optimizer
    "nnUNetTrainerAdam",
    "nnUNetTrainerAdam1en3",
    "nnUNetTrainerAdam3en4",
    "nnUNetTrainerVanillaAdam",
    "nnUNetTrainerVanillaAdam1en3",
    "nnUNetTrainerVanillaAdam3en4",
    "nnUNetTrainerAdan",
    "nnUNetTrainerAdan1en1",
    "nnUNetTrainerAdan1en3",
    "nnUNetTrainerAdan3en4",
    "nnUNetTrainerAdanCosAnneal",
    # sampling
    "nnUNetTrainer_probabilisticOversampling",
    "nnUNetTrainer_probabilisticOversampling_033",
    "nnUNetTrainer_probabilisticOversampling_010",
    # deep supervision
    "nnUNetTrainerNoDeepSupervision",
    # training length
    "nnUNetTrainer_1epoch",
    "nnUNetTrainer_5epochs",
    "nnUNetTrainer_10epochs",
    "nnUNetTrainer_20epochs",
    "nnUNetTrainer_50epochs",
    "nnUNetTrainer_100epochs",
    "nnUNetTrainer_250epochs",
    "nnUNetTrainer_2000epochs",
    "nnUNetTrainer_4000epochs",
    "nnUNetTrainer_8000epochs",
    "nnUNetTrainer_250epochs_NoMirroring",
    "nnUNetTrainer_2000epochs_NoMirroring",
    "nnUNetTrainer_4000epochs_NoMirroring",
    "nnUNetTrainer_8000epochs_NoMirroring",
)


def get_variant(name: str = "default",
                base: Optional[SegmentorTrainConfig] = None) -> TrainerVariant:
    if name not in KNOWN_VARIANT_NAMES:
        raise ValueError(
            f"unknown trainer variant {name!r} — the reference fails on "
            f"unknown trainer names (run_training.py:32-68) and so do we. "
            f"Known: {', '.join(KNOWN_VARIANT_NAMES)}")
    base = base or SegmentorTrainConfig()
    aug = AugmentConfig()
    cfg = base
    loss, sched, opt, mirror = "dc_and_ce", "poly", "sgd", True
    kw = {}

    # Xepochs family (reference variants/training_length/*):
    m = re.search(r"_(\d+)epochs?(_NoMirroring)?$", name)
    if m:
        cfg = dataclasses.replace(cfg, num_epochs=int(m.group(1)))
    if "Benchmark" in name:
        cfg = dataclasses.replace(cfg, num_epochs=5)
        kw["benchmark"] = True
        if "noDataLoading" in name:
            kw["no_data_loading"] = True

    # DA family (variants/data_augmentation/*)
    if "DA5" in name:
        aug = _DA5
    if "NoDA" in name:
        aug = _NO_DA
        # reference nnUNetTrainerNoDA.py:37-38 sets mirror_axes=None AND
        # inference_allowed_mirroring_axes=None — no flips in training, so
        # validation/inference must not mirror-TTA either
        mirror = False
    if "NoMirroring" in name:
        aug = dataclasses.replace(aug, p_mirror=0)
        mirror = False
    if "onlyMirror01" in name:
        # reference: mirror axes (0, 1) for 3D, (0,) ONLY for 2D
        # (nnUNetTrainer_onlyMirror01 docstring/dim branch)
        aug = dataclasses.replace(aug, mirror_axes=(0, 1))
        kw["mirror_axes_2d"] = (0,)
    if name in ("nnUNetTrainerDAOrd0", "nnUNetTrainerDA5ord0"):
        # order-0 DATA resampling in the spatial transform (reference
        # nnUNetTrainerDAOrd0: order_resampling_data=0, order_resampling_seg=0)
        kw["spatial_order0_data"] = True
    # nnUNetTrainer_DASegOrd0 / nnUNetTrainerDA5Segord0 set only
    # order_resampling_seg=0 — seg already resamples nearest in this stack,
    # so they are distinct names resolving to their base recipe.

    # loss family (variants/loss/*)
    if "DiceTopK10Loss" in name:
        loss = "dc_and_topk10"
    elif "Topk10Loss" in name:
        loss = "topk10"
        if name.endswith("LS01"):
            kw["label_smoothing"] = 0.1
    elif "DiceCELoss_noSmooth" in name:
        loss = "dc_and_ce"
        kw["dice_smooth"] = 0.0
    elif "DiceLoss" in name:
        loss = "dice"
    elif "CELoss" in name:
        loss = "ce"
    if "Focal" in name:
        loss = "dc_and_focal"

    # schedule / optimizer (variants/lr_schedule, variants/optimizer)
    if "CosAnneal" in name:
        sched = "cosine"
    if "Adam" in name or "Adan" in name:
        # Adam names -> AdamW; Adan names -> the real three-moment Adan
        # (``core/optim.py``, reference variants/optimizer/nnUNetTrainerAdan.py
        # uses adan_pytorch with default betas (0.02, 0.08, 0.01)). The BARE
        # classes keep self.initial_lr = 1e-2; only 1en3/3en4/1en1 override
        # (reference variants/optimizer/nnUNetTrainerAdam.py).
        opt = "adan" if "Adan" in name else "adam"
        if "1en3" in name:
            cfg = dataclasses.replace(cfg, initial_lr=1e-3)
        elif "3en4" in name:
            cfg = dataclasses.replace(cfg, initial_lr=3e-4)
        elif "1en1" in name:
            cfg = dataclasses.replace(cfg, initial_lr=1e-1)
    if "NoDeepSupervision" in name:
        cfg = dataclasses.replace(cfg, deep_supervision=False)

    # network architecture (variants/network_architecture/nnUNetTrainerBN.py)
    if name == "nnUNetTrainerBN":
        kw["norm"] = "batch"

    # sampling (variants/sampling/*)
    if "probabilisticOversampling" in name:
        kw["probabilistic_oversampling"] = True
        if name.endswith("_033"):
            kw["oversample_fg"] = 0.33
        elif name.endswith("_010"):
            kw["oversample_fg"] = 0.10
        else:
            # base class keeps the EFFECTIVE positional percentage
            # (mean over batch positions of the positional rule) — for the
            # default bs=2 / 33% that is exactly 0.5
            kw["oversample_fg"] = None  # computed by the sampler from batch

    return TrainerVariant(name=name, config=cfg, augment=aug, loss=loss,
                          lr_schedule=sched, optimizer=opt, mirror_tta=mirror,
                          **kw)


def lr_at_epoch(variant: TrainerVariant, epoch: int, max_epochs: int) -> float:
    lr0 = variant.config.initial_lr
    if variant.lr_schedule == "poly":
        return lr0 * (1 - epoch / max_epochs) ** 0.9
    if variant.lr_schedule == "cosine":
        return lr0 * 0.5 * (1 + math.cos(math.pi * epoch / max_epochs))
    return lr0


def inference_mirror_config(variant: Optional[TrainerVariant],
                            ndim: int) -> tuple:
    """``(use_mirroring, mirror_axes)`` this variant allows at inference.

    The reference records ``inference_allowed_mirroring_axes`` at training
    time and the predictor honors it (``nnUNetTrainer.py:1161-1167``,
    ``predict_from_raw_data.py:530-545``): NoMirroring and NoDA trained
    without flips → no TTA flips (``nnUNetTrainerNoDA.py:37-38``);
    onlyMirror01 restricts to axis (0,) in 2D / (0, 1) in 3D. Every
    predictor construction site (trainer validation AND the CLI predict
    paths) must route through this so prediction matches validation."""
    if variant is None:
        return True, None
    if not variant.mirror_tta:
        return False, None
    axes = variant.augment.mirror_axes
    if ndim == 2 and variant.mirror_axes_2d is not None:
        axes = variant.mirror_axes_2d
    return True, tuple(a for a in axes if 0 <= a < ndim)
