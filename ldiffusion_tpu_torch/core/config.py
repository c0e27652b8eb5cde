"""Typed configuration (the port's own copy of what it needs from
``ldiffusion_tpu/core/config.py``: the stage-1 and stage-2 trainers')."""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DiffusionTrainConfig:
    """Stage-1 Laplace warm-up hyperparameters (reference ``ldiffusion.py:121-199``);
    the same fields and defaults as the JAX package's."""

    num_epochs: int = 10              # hardcoded 10 in reference (:122)
    batch_size: int = 1
    num_inference_steps: int = 25     # CLI value; trajectory uses steps/5 (:198)
    learning_rate: float = 1e-5       # AdamW (:171)
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0            # (:187)
    prompt: str = "A pathological slide"  # (:211)
    latent_size: int = 64             # images resized to 64x64 (:200,212)
    image_size: int = 1024
    param_dtype: str = "float32"      # master parameters and AdamW state
    compute_dtype: str = "bfloat16"   # the modules' forward and backward
    remat: bool = True                # recompute each timestep in the backward
    seed: int = 0
    num_classes: Optional[int] = None  # enables per-class anchor floor in InfoNCE


@dataclass(frozen=True)
class SegmentorTrainConfig:
    """Stage-2 nnU-Net-style trainer hyperparameters (reference
    ``nnUNetTrainer.py:140-160``); the same fields and defaults as
    ``ldiffusion_tpu/core/config.py:90-107``."""

    num_epochs: int = 90              # reference: args.num_epochs - 10 (:311)
    iters_per_epoch: int = 250        # (:151)
    val_iters_per_epoch: int = 50     # (:152)
    initial_lr: float = 1e-2          # SGD nesterov (:145)
    weight_decay: float = 3e-5        # (:146)
    momentum: float = 0.99
    oversample_fg: float = 0.33       # (:147)
    grad_clip: float = 12.0           # (:910)
    ema_decay: float = 0.9            # EMA pseudo-dice (logger :49-52)
    save_every: int = 50              # checkpoint_latest cadence (:181)
    compute_dtype: str = "bfloat16"   # the DynUNet's forward and backward
    deep_supervision: bool = True
    seed: int = 12345

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)
