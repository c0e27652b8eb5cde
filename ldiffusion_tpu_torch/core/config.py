"""Typed configuration (the port's own copy of what it needs from
``ldiffusion_tpu/core/config.py``)."""
from __future__ import annotations

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
