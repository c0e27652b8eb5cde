"""Typed configuration (the port's own copy of ``ldiffusion_tpu/core/config.py``):
the stage-1 and stage-2 trainers' hyperparameters and the top-level
``LDiffusionConfig`` with its ``MeshConfig``, the (data, fsdp, tensor)
layout ``core/dist.py:make_mesh`` lays over the processes."""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
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


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: ``data`` shards the batch (-1: every device the
    other axes leave), ``fsdp`` parameters and optimizer state; ``tensor`` is
    reserved (the reference has no tensor parallelism)."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1

    def resolved(self, n_devices: int) -> "MeshConfig":
        data = self.data
        if data == -1:
            denom = self.fsdp * self.tensor
            if n_devices % denom:
                raise ValueError(f"{n_devices} devices do not split into fsdp x tensor {denom}")
            data = n_devices // denom
        if data * self.fsdp * self.tensor != n_devices:
            raise ValueError(f"mesh {data}x{self.fsdp}x{self.tensor} != {n_devices} devices")
        return MeshConfig(data=data, fsdp=self.fsdp, tensor=self.tensor)


@dataclass(frozen=True)
class LDiffusionConfig:
    """Top-level configuration of ``LDiffusionModel``, the JAX package's
    fields and defaults; ``to_json`` / ``from_dict`` as its ``_JsonMixin``
    (``from_dict`` reads the top-level fields, JSON lists as tuples)."""

    diffusion_path: str = ""
    level: str = "tissue"             # "tissue" | "cell"
    num_classes: int = 7
    image_dir: str = ""
    label_dir: str = ""
    train_ratio: float = 0.7          # 70/30 split (reference ldiffusion.py:72,87)
    work_dir: str = "train_save"
    mesh: MeshConfig = field(default_factory=MeshConfig)
    diffusion: DiffusionTrainConfig = field(default_factory=DiffusionTrainConfig)
    segmentor: SegmentorTrainConfig = field(default_factory=SegmentorTrainConfig)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "LDiffusionConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in names:
                continue
            if isinstance(v, list):
                v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            kwargs[k] = v
        return cls(**kwargs)
