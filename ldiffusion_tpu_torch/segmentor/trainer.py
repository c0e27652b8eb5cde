"""nnU-Net-style segmentor trainer (counterpart of
``ldiffusion_tpu/segmentor/trainer.py``; reference ``nnUNetTrainer.py``).

The default recipe: SGD-nesterov (lr 1e-2, momentum 0.99, coupled weight
decay 3e-5) after ``clip_grad_norm_(12)`` (the order of ``:204-212``: clip the
raw gradients, then the optimizer adds wd·θ), PolyLR ``(1 − e/E)^0.9`` set
once an epoch, deep-supervision DC+CE, the EMA(0.9) pseudo-Dice deciding
``checkpoint_best``, ``checkpoint_latest`` every ``save_every`` epochs and at
the end, ``checkpoint_final``, and resuming (``continue_training``).

A trainer variant (``segmentor/variants.py``, the ``-tr`` names) replaces the
recipe's config, augmentation, loss (Dice, CE, TopK10 with or without label
smoothing, Dice+TopK10, Dice+focal, Dice without smoothing), schedule (poly,
cosine), optimizer (SGD, ``core/optim.py:SGDNesterov``; "Adam":
``torch.optim.Adam``, ``capturable`` on a card, with the decay coupled into
the clipped gradient, as the JAX chain ``add_decayed_weights`` →
``adamw(wd=0)``; Adan, ``core/optim.py``), norm (BatchNorm for
nnUNetTrainerBN), sampling (probabilistic oversampling), deep supervision,
data order of the spatial transform and the mirror axes; the Benchmark
recipes time 5 epochs, ``noDataLoading`` on one synthetic batch. A label
manager (``segmentor/label_manager.py``) brings the regions regime (sigmoid
heads trained with Dice + sigmoid focal on region maps, validated per region)
and the ignore label (masked out of losses and metrics), through lookup tables
indexed by label + 1.

One train step (``:330-352``): device augmentation → labels ``max(seg, 0)``
(the crop padding trains as background) → mode-pooled deep-supervision
targets → loss → backward → clip → optimizer. Patches come from
``PatchSampler`` at the enlarged initial size, through the host
rotation/scaling (``HostSpatialAugmenter``) in a prefetch thread.

The train and validation steps are programs, as the JAX trainer's are two
``jax.jit``s (``:319-403``). ``step_fn(data, seg, lr)`` is the train step on
device tensors (the DA draws from the trainer's generator and their
application, ``clamp_min(0)``, the deep-supervision targets, the variant's
loss and the backward, ``clip_grad_norm_``, the optimizer at ``lr``, a 0-d
device tensor as JAX passes ``lr`` through ``_set_lr``); ``_val_counts`` the
validation step (``_val_step``: ``_val_counts`` of this process's rows,
summed over the processes). On one device and over a mesh alike,
``train_step`` and ``val_step`` run them through ``core/graphs.py``'s
``Jit``: per batch shape (and dtype) eager at the first use, a CUDA graph
captured at the second (the generator registered with the train step's,
both in the trainer's pool; over a mesh the collectives inside the graph),
replayed after; the host fills ``lr`` before each replay (the poly schedule
changes it every epoch) and reads each step's outputs with one sync. 2D
and 3D plans take the same step. ``load_checkpoint`` writes the parameters
and the optimizer's buffers in place, so the graphs read what it loaded.

A 3D plan (``SegPlan3D``: 3d_fullres, 3d_lowres, 3d_cascade_fullres,
``:106-173``) builds the ``DynUNet3D`` (its input widened by the cascade's
one-hot channels), the 3D host DA (``HostSpatialAugmenter3D``, dummy-2D for
anisotropic patches) and the volumes' device stack (``augment_batch_3d``,
mirroring and noise); its deep-supervision targets pool over per-axis
strides, batch Dice runs over the batch and every spatial axis, and the
final validation writes ``.npy`` cases. A variant's 2D-only mirror axes
(onlyMirror01: ``(0,)`` in 2D) leave 3D at the variant's own axes.

Precision: the parameters and the optimizer state are float32; with
``compute_dtype="bfloat16"`` the DynUNet computes in bf16 over them (its
``compute_dtype``), with the norms' statistics and the losses in float32.

Checkpoints are the JAX trainer's pickle layout (``save_pytree``):
``params`` in the flax layout (``dynunet_to_flax``), ``batch_stats`` (a
BatchNorm net's running statistics as flax's ``mean``/``var`` collection,
else ``{}``), ``step``, ``epoch``, ``best_ema``, ``logger``, ``plan``; the
JAX package's ``load_pytree`` and predictor read them. ``opt_state`` holds
the port's own optimizer buffers in the flax layout (``momentum``;
``exp_avg``/``exp_avg_sq``; ``m``/``v``/``n``/``prev_grad``) and the
learning rate. ``load_checkpoint`` also resumes from a checkpoint of the
JAX trainer, whose ``opt_state`` is optax's (``InjectStatefulHyperparamsState``
over the chain's states), read through ``core/checkpoint.py``'s stand-ins:
``TraceState.trace`` → SGD's ``momentum_buffer`` (nesterov, no dampening:
the same buffer), ``ScaleByAdamState`` (count, mu, nu) → Adam's ``step``,
``exp_avg``, ``exp_avg_sq``, the JAX ``AdanState`` (count, m, v, n,
prev_grad) → the port's Adan buffers, ``hyperparams["learning_rate"]`` →
each group's ``lr``. A checkpoint of another optimizer family than the
recipe's raises ``NotImplementedError``, as it cannot be resumed in JAX
either.

Over a mesh (``mesh=``, ``core/dist.py``; the JAX trainer's data-parallel
pjit, the reference's DDP): the net is replicated over the batch group
(``replicate_module``: its parameters broadcast once; the optimizer state
replicated), and after the backward ``mean_gradients`` averages the
gradients with one all-reduce, the one pjit inserts; the batch-Dice group
goes to the loss and the BatchNorm group to a ``BN`` net
(``set_norm_group``), so both see the global batch. Every process samples
the global batch (the same seeds), draws the device augmentation for all of
it from the same generator, and keeps its rows (``MeshContext.local_rows``);
the loss and the validation counts are summed over the processes inside the
step (``global_sum``), so one program returns the global values.
``checkpoint_*.pkl``, ``progress.png``, the logs and
``benchmark_result.json`` are written by rank 0. The final validation
predicts the cases ``i % world == rank``, waits for every rank
(``barrier``) and scores them all on rank 0 (``trainer.py:567-703``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ldiffusion_tpu_torch.core.checkpoint import Inert, load_pytree, save_pytree
import torch.distributed as dist

from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.core.dist import MeshContext, is_main_process
from ldiffusion_tpu_torch.core.logging import EpochLogger, TextLogger, dump_debug_json
from ldiffusion_tpu_torch.core.graphs import Jit, TrainProgram
from ldiffusion_tpu_torch.core.optim import Adan, SGDNesterov
from ldiffusion_tpu_torch.data.augment import (
    AugmentConfig,
    HostSpatialAugmenter,
    HostSpatialAugmenter3D,
    apply_augment,
    apply_augment_3d,
    configure_spatial_da,
    draw_augment_params,
    draw_augment_params_3d,
)
from ldiffusion_tpu_torch.data.patches import PatchSampler
from ldiffusion_tpu_torch.data.prefetch import Prefetcher
from ldiffusion_tpu_torch.losses import dice as losses
from ldiffusion_tpu_torch.models.convert import (
    dynunet_batch_stats_to_flax,
    dynunet_from_flax,
    dynunet_to_flax,
)
from ldiffusion_tpu_torch.models.dynunet import DynUNet, set_norm_group
from ldiffusion_tpu_torch.models.dynunet3d import DynUNet3D
from ldiffusion_tpu_torch.models.layers import init_random_
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset
from ldiffusion_tpu_torch.segmentor.variants import inference_mirror_config, lr_at_epoch

# optimizer → the names of its per-parameter buffers in the checkpoint
_OPT_BUFFERS = {"sgd": ("momentum_buffer",), "adam": ("exp_avg", "exp_avg_sq"),
                "adan": ("m", "v", "n", "prev_grad")}
# each recipe's optax state class in a JAX checkpoint; its fields after the
# step count are that optimizer's buffers, in ``_OPT_BUFFERS`` order
_OPTAX_CLASS = {"sgd": "TraceState", "adam": "ScaleByAdamState", "adan": "AdanState"}


def _walk_optax(state):
    """Every node of an optax state read by ``load_pytree``: the stand-ins'
    constructor arguments and tuples, not the parameter trees below them."""
    yield state
    if isinstance(state, Inert):
        children = state.args
    elif isinstance(state, (tuple, list)):
        children = state
    else:
        return
    for child in children:
        yield from _walk_optax(child)


def optax_to_port_state(opt_state: Inert, opt_name: str, path: str) -> dict:
    """The JAX trainer's optax ``opt_state`` as the port's checkpoint
    ``opt_state``: {"learning_rate": the injected rate, buffer key: flax tree}."""
    cls, names = _OPTAX_CLASS[opt_name], _OPT_BUFFERS[opt_name]
    nodes = list(_walk_optax(opt_state))
    found = {n.origin.rsplit(".", 1)[-1] for n in nodes if isinstance(n, Inert)}
    state = next((n for n in nodes if isinstance(n, Inert) and n.origin.endswith("." + cls)),
                 None)
    hyper = next((a for n in nodes if isinstance(n, Inert) for a in n.args
                  if isinstance(a, dict) and "learning_rate" in a), None)
    if state is None or hyper is None:
        raise NotImplementedError(
            f"{path}: the recipe's optimizer is {opt_name!r} ({cls}), the checkpoint's optax "
            f"state holds {sorted(found)}: another optimizer family cannot be resumed")
    fields = state.args[-len(names):]  # after the count, where the state has one
    out = {"learning_rate": float(np.asarray(hyper["learning_rate"]))}
    for name, tree in zip(names, fields):
        out["momentum" if name == "momentum_buffer" else name] = tree
    return out


def poly_lr(initial_lr: float, epoch: int, max_epochs: int, exponent: float = 0.9) -> float:
    """Reference ``polylr.py:4-21``."""
    return initial_lr * (1 - epoch / max_epochs) ** exponent


def _pools(s) -> bool:
    return (max(s) > 1) if isinstance(s, (tuple, list)) else (s > 1)


def downsample_seg(seg, s, num_labels: int):
    """Mode pool of (B, H, W) or (B, D, H, W) int labels over windows of
    ``s`` (an int, or one stride an axis)
    (``ldiffusion_tpu/segmentor/trainer.py:752-769``): -1 votes as its own
    label; ties go to the lowest value, as ``argmax`` takes the first.
    ``num_labels`` covers the largest label value (a region or ignore label
    may exceed the head count)."""
    nd = seg.dim() - 1
    s = tuple(int(v) for v in s) if isinstance(s, (tuple, list)) else (int(s),) * nd
    onehot = losses.one_hot(seg + 1, num_labels + 1).movedim(-1, 1).float()
    pool = F.avg_pool3d if nd == 3 else F.avg_pool2d
    counts = pool(onehot, s, s)
    return (counts.argmax(dim=1) - 1).to(seg.dtype)


def _timed(it, sink: List[float]):
    """Yield from ``it``, appending each item's host seconds to ``sink``."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        sink.append(time.perf_counter() - t0)
        yield item


class SegmentorTrainer:
    def __init__(self, plan: SegPlan, config: SegmentorTrainConfig,
                 output_dir: str = "train_save/segmentor",
                 augment: Optional[AugmentConfig] = None, variant=None, label_manager=None,
                 device=None, mesh: Optional[MeshContext] = None):
        """``variant``: a ``TrainerVariant`` (its config and augmentation
        replace ``config`` and a missing ``augment``); ``label_manager``: the
        dataset's ``LabelManager`` (regions, ignore label); ``mesh``: the
        processes to train over (None, or a mesh without a process group:
        this process alone, on ``device``)."""
        self.mesh = mesh if mesh is not None and mesh.distributed else None
        if self.mesh is not None:
            if plan.batch_size % self.mesh.batch_shards:
                raise ValueError(f"batch {plan.batch_size} does not split over "
                                 f"{self.mesh.batch_shards} processes")
            device = self.mesh.device
        self.is_3d = len(plan.patch_size) == 3
        if label_manager is not None and label_manager.has_regions and \
                plan.num_classes != label_manager.num_segmentation_heads:
            raise ValueError(f"the plan has {plan.num_classes} heads, the regions "
                             f"{label_manager.num_segmentation_heads}")
        self.variant = variant
        self.label_manager = label_manager
        if variant is not None:
            config = variant.config
            augment = augment or variant.augment
            if variant.mirror_axes_2d is not None and not self.is_3d:  # onlyMirror01 in 2D
                augment = dataclasses.replace(augment, mirror_axes=variant.mirror_axes_2d)
        self.plan = plan
        self.cfg = config
        self.output_dir = output_dir
        self.device = resolve_device(device)
        self.augment_cfg = augment or AugmentConfig()
        # rotation/scaling run on the host, from patches sampled at the
        # enlarged initial size (trainer.py:103-149)
        self.host_spatial = None
        self.train_patch_size = tuple(plan.patch_size)
        if self.augment_cfg.p_rotation > 0 or self.augment_cfg.p_scaling > 0:
            spatial = configure_spatial_da(plan.patch_size,
                                           self.augment_cfg.initial_scale_range)
            self.train_patch_size = spatial.initial_patch_size
            order = 0 if getattr(variant, "spatial_order0_data", False) else 1
            if self.is_3d:
                if not spatial.do_dummy_2d:
                    self.augment_cfg = dataclasses.replace(
                        self.augment_cfg, rotation_max_3d=spatial.rotation_max[0])
                self.host_spatial = HostSpatialAugmenter3D(
                    self.augment_cfg, seed=config.seed + 17, data_order=order,
                    out_size=plan.patch_size, dummy_2d=spatial.do_dummy_2d)
            else:
                self.augment_cfg = dataclasses.replace(self.augment_cfg,
                                                       rotation_max=spatial.rotation_max[0])
                self.host_spatial = HostSpatialAugmenter(self.augment_cfg, seed=config.seed + 17,
                                                         data_order=order,
                                                         out_size=plan.patch_size)
            self.augment_cfg = dataclasses.replace(self.augment_cfg, p_rotation=0.0,
                                                   p_scaling=0.0)
        self.log = TextLogger(os.path.join(output_dir, "training_log.txt"))
        self.epoch_log = EpochLogger(config.ema_decay)
        self.current_epoch = 0
        self.best_ema: Optional[float] = None
        self.disable_checkpointing = False  # --disable_checkpointing

        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.net_config = plan.network_config()
        if getattr(variant, "norm", "instance") == "batch":
            if self.is_3d:
                raise ValueError("nnUNetTrainerBN is 2D only (as in the JAX package)")
            self.net_config = dataclasses.replace(self.net_config, norm="batch")
        net = DynUNet3D(self.net_config) if self.is_3d else DynUNet(self.net_config)
        init_random_(net, torch.Generator().manual_seed(config.seed))
        self.net = net.to(self.device, memory_format=torch.channels_last_3d if self.is_3d
                          else torch.channels_last)
        self.net.compute_dtype = self.compute_dtype
        self.group = None  # the batch-Dice and BatchNorm group
        if self.mesh is not None:
            self.group = self.mesh.batch_group
            set_norm_group(self.net, self.group)
            self.mesh.replicate_module(self.net)
        self.opt_name = getattr(variant, "optimizer", "sgd")
        params = self.net.parameters()
        on_card = self.device.type == "cuda"
        if self.opt_name == "adan":  # decoupled decay inside the step
            self.opt = Adan(params, lr=config.initial_lr, weight_decay=config.weight_decay)
        elif self.opt_name == "adam":  # L2 coupled into the clipped gradient
            self.opt = torch.optim.Adam(params, lr=config.initial_lr,
                                        weight_decay=config.weight_decay, capturable=on_card)
        else:
            self.opt = SGDNesterov(params, lr=config.initial_lr, momentum=config.momentum,
                                   weight_decay=config.weight_decay)
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        # one train and one validation program per batch shape (module docstring)
        pool = torch.cuda.graph_pool_handle() if on_card else None
        self.train_program = Jit(self.step_fn, self.device, pool,
                                 generators=[self.generator], program_type=TrainProgram,
                                 name="seg_train_step")
        self.val_program = Jit(self._val_step, self.device, pool, name="seg_val_step")
        self._make_luts()
        # measurements: host seconds a train iteration (ending in the loss
        # read), of patch sampling + host spatial DA a batch, a validation
        # case, a checkpoint write (outside the epoch_time stamp, as in JAX)
        self.iter_seconds: List[float] = []
        self.host_batch_seconds: List[float] = []
        self.val_case_seconds: List[float] = []
        self.checkpoint_seconds: List[float] = []
        dump_debug_json(os.path.join(output_dir, "debug.json"),
                        {"plan": plan.to_json(), "config": config.to_json()})

    def _make_luts(self):
        """Lookup tables indexed by label + 1 (``trainer.py:227-246``; row 0,
        the -1 padding, is unreachable after ``max(seg, 0)``): the loss mask
        (0 at the ignore label) and the regions' binary maps."""
        self.region_lut = self.mask_lut = None
        self.n_labels = self.plan.num_classes  # the mode pool's label count
        lm = self.label_manager
        if lm is None:
            return
        labels = list(lm.all_labels) + ([lm.ignore_label] if lm.has_ignore_label else [])
        max_l = max(labels)
        self.n_labels = max_l + 1
        mask = torch.ones(max_l + 2)
        if lm.has_ignore_label:
            mask[lm.ignore_label + 1] = 0.0
        self.mask_lut = mask.to(self.device)
        if lm.has_regions:
            lut = torch.zeros(max_l + 2, lm.num_segmentation_heads)
            for ri, region in enumerate(lm.regions):
                for lbl in region:
                    lut[lbl + 1, ri] = 1.0
            self.region_lut = lut.to(self.device)

    # ------------------------------------------------------------------
    def _to_device(self, data, seg):
        """(B, *spatial, C) / (B, *spatial) host batch → (B, C, *spatial)
        float32 and (B, *spatial) int64 on the device."""
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device, non_blocking=True)
        seg = torch.as_tensor(seg).to(self.device, non_blocking=True).long()
        return data.movedim(-1, 1), seg

    def ds_targets(self, seg, n: int):
        """The deep-supervision targets of the first ``n`` heads."""
        out, cur = [seg], seg
        for s in self.plan.strides[1:]:
            if len(out) >= n:
                break
            if _pools(s):
                cur = downsample_seg(cur, s, self.n_labels)
                out.append(cur)
        return out

    def _regime(self, seg):
        """(targets, loss mask or None): region maps (B, R, *spatial) for the
        regions regime, else labels with the ignore label set to 0."""
        if self.mask_lut is None:
            return seg, None
        idx = (seg + 1).clamp(0, self.mask_lut.shape[0] - 1)
        mask = self.mask_lut[idx]
        if self.region_lut is not None:
            return self.region_lut[idx].movedim(-1, 1), mask
        return torch.where(mask > 0, seg, torch.zeros_like(seg)), mask

    def _one_loss(self, logits, seg):
        """The variant's loss of one head (``trainer.py:265-317``)."""
        bd, g = self.plan.batch_dice, self.group
        tgt, mask = self._regime(seg)
        if self.region_lut is not None:
            return losses.dc_and_focal_sigmoid_loss(logits, tgt, loss_mask=mask, batch_dice=bd,
                                                    group=g)
        v = self.variant
        name = getattr(v, "loss", "dc_and_ce")
        smooth = getattr(v, "dice_smooth", losses.SMOOTH)
        if name == "dice":
            return losses.soft_dice_loss(logits, tgt, mask, bd, smooth, group=g)
        if name == "ce":
            return losses.robust_cross_entropy(logits, tgt, mask)
        if name == "topk10":
            return losses.topk_cross_entropy(logits, tgt, label_smoothing=v.label_smoothing,
                                             loss_mask=mask)
        if name == "dc_and_topk10":
            return losses.dc_and_topk10_loss(logits, tgt, mask, bd, smooth, group=g)
        if name == "dc_and_focal":
            return losses.dc_and_focal_loss(logits, tgt, mask, bd, group=g)
        return losses.dc_and_ce_loss(logits, tgt, mask, bd, smooth, group=g)

    def loss_and_grads(self, data, seg):
        """Forward + backward on an augmented (B, C, *spatial) batch and its
        (B, *spatial) labels; leaves the raw gradients on the parameters,
        averaged over the processes over a mesh (and updates a BatchNorm
        net's running statistics). Returns this process's loss, detached."""
        self.opt.zero_grad(set_to_none=True)
        seg = seg.clamp_min(0)  # RemoveLabelTransform(-1, 0)
        outputs = self.net(data, train=True)
        if not isinstance(outputs, list):
            outputs = [outputs]
        loss = losses.deep_supervision_loss(outputs, self.ds_targets(seg, len(outputs)),
                                            self._one_loss)
        loss.backward()
        if self.mesh is not None:
            self.mesh.mean_gradients(self.net.parameters())
        return loss.detach()

    def _set_lr(self, lr: float):
        for group in self.opt.param_groups:
            group["lr"] = lr

    def _update(self, lr=None):
        """clip_grad_norm_ then the optimizer step, at ``lr`` (a 0-d device
        tensor standing in for the groups' rate during the step: a captured
        step reads it at every replay) or at the groups' own. Returns the
        norm before clipping."""
        norm = torch.nn.utils.clip_grad_norm_(self.net.parameters(), self.cfg.grad_clip)
        kept = self.opt.param_groups[0]["lr"]
        if lr is not None:
            self._set_lr(lr)
        try:
            self.opt.step()
        finally:
            self._set_lr(kept)
        return norm

    def apply_update(self, lr: Optional[float] = None):
        """clip_grad_norm_ then the optimizer step at ``lr`` (the groups' rate
        from now on), as a step of its own (counted in ``step``). Returns the
        norm before clipping."""
        if lr is not None:
            self._set_lr(lr)
        norm = self._update()
        self.step += 1
        return norm

    def step_fn(self, data, seg, lr):
        """One whole train step on device tensors, what the program captures:
        the device DA (``augment``), ``loss_and_grads``, ``_update`` at
        ``lr``. data (B, C, *spatial) float32 and seg (B, *spatial) int64 of
        the global batch; lr a 0-d float32 tensor. Returns (loss, gradient
        norm) of the global batch, 0-d device tensors (over a mesh the loss
        summed over the processes, ``global_sum``, inside the step)."""
        data, seg = self.augment(data, seg)
        loss = self.loss_and_grads(data, seg)
        norm = self._update(lr)
        if self.mesh is not None:
            loss = self.global_sum(loss)[0].float() / self.mesh.batch_shards
        return loss, norm

    def local_rows(self, x):
        """This process's rows of a global batch (all of it in one process)."""
        return x if self.mesh is None else self.mesh.local_rows(x)

    def global_sum(self, *values):
        """Each device tensor summed over the batch group in float64 (itself
        in one process): one all-reduce of one flat buffer, made on the
        device (nothing copied from the host: a captured step holds it)."""
        if self.mesh is None:
            return values
        flat = torch.cat([v.to(torch.float64).reshape(-1) for v in values])
        dist.all_reduce(flat, group=self.group)
        return [part.view(v.shape) for v, part in
                zip(values, flat.split([v.numel() for v in values]))]

    def augment(self, data, seg):
        """The device DA, drawn for the global batch (``data`` holds all of
        it) and applied to this process's rows: the draws are the same
        whatever the number of processes."""
        cfg = self.augment_cfg
        draw = draw_augment_params_3d if self.is_3d else draw_augment_params
        params = draw(data.shape, cfg, self.generator, data.device)
        b = data.shape[0]
        params = {k: self.local_rows(v) if v.dim() and v.shape[0] == b else v
                  for k, v in params.items()}
        data, seg = self.local_rows(data), self.local_rows(seg)
        if self.is_3d:
            return apply_augment_3d(data, seg, params)
        return apply_augment(data, seg, params, cfg)

    def train_step(self, data, seg, lr: Optional[float] = None):
        """One step on a host batch (the global batch; each process trains
        its rows) at ``lr`` (the groups' rate from now on; None keeps it),
        through the batch shape's program (module docstring). Returns the
        global batch's loss, a 0-d device tensor (a program's: read it
        before the next step)."""
        if lr is not None:
            self._set_lr(float(lr))
        data, seg = self._to_device(data, seg)
        rate = torch.full((), self.opt.param_groups[0]["lr"], dtype=torch.float32,
                          device=self.device)
        loss, _ = self.train_program(data, seg, rate)
        self.step += 1
        return loss

    @torch.no_grad()
    def val_step(self, data, seg):
        """(loss, tp, fp, fn per head) of the full-resolution head over the
        global batch of a host batch (each process its rows, the counts
        summed); the regions regime thresholds the sigmoid at 0.5 and puts a
        zero background column in front. Through the batch shape's program:
        read the outputs before the next step."""
        return self.val_program(*self._to_device(data, seg))

    def _val_step(self, data, seg):
        """The validation step of a global batch on device tensors (what its
        program captures): ``_val_counts`` of this process's rows, the loss
        and the counts summed over the processes."""
        loss, *counts = self._val_counts(self.local_rows(data), self.local_rows(seg))
        if self.mesh is None:
            return (loss, *counts)
        loss, *counts = self.global_sum(loss, *counts)
        return (loss.float() / self.mesh.batch_shards, *counts)

    def _val_counts(self, data, seg):
        """The validation step on device tensors (what its program
        captures); the counts are sums of one-hot products, as the JAX step
        takes them (``torch.bincount`` reads its input's maximum on the
        host)."""
        seg = seg.clamp_min(0)
        logits = self.net(data)
        bd = self.plan.batch_dice
        tgt, mask = self._regime(seg)
        if self.region_lut is not None:
            loss = losses.dc_and_focal_sigmoid_loss(logits, tgt, loss_mask=mask, batch_dice=bd,
                                                    group=self.group)
            m = mask.unsqueeze(1)
            ph = (torch.sigmoid(logits.float()) > 0.5).float() * m
            th = tgt * m
            axes = (0, *range(2, logits.dim()))
            zero = torch.zeros(1, device=logits.device)
            return (loss, *(torch.cat([zero, v.sum(dim=axes)])
                            for v in (ph * th, ph * (1 - th), (1 - ph) * th)))
        loss = losses.dc_and_ce_loss(logits, tgt, mask, bd, group=self.group)
        c = self.plan.num_classes
        ph, th = (losses.one_hot(t, c).long() for t in (logits.argmax(dim=1), tgt))
        if mask is not None:
            keep = (mask > 0).long().unsqueeze(-1)
            ph, th = ph * keep, th * keep
        axes = tuple(range(ph.dim() - 1))
        tp = (ph * th).sum(dim=axes)
        return loss, tp, ph.sum(dim=axes) - tp, th.sum(dim=axes) - tp

    # ------------------------------------------------------------------
    def _iterators(self, train_ds, val_ds):
        """(train, val) batch iterators: the samplers (positional or
        probabilistic oversampling) through the host spatial DA in a prefetch
        thread, or for ``noDataLoading`` one synthetic batch forever."""
        cfg, v = self.cfg, self.variant
        if getattr(v, "no_data_loading", False):
            rng = np.random.default_rng(cfg.seed)
            shape = (self.plan.batch_size, *self.plan.patch_size)
            batch = (rng.random((*shape, self.net_config.in_channels), np.float32),
                     rng.integers(0, max(2, self.plan.num_classes), shape).astype(np.int32))
            return iter(lambda: batch, None), iter(lambda: batch, None)
        probabilistic = bool(getattr(v, "probabilistic_oversampling", False))
        oversample = cfg.oversample_fg
        if getattr(v, "oversample_fg", None) is not None:
            oversample = v.oversample_fg
        elif probabilistic:
            oversample = PatchSampler.effective_oversample_percent(self.plan.batch_size,
                                                                   cfg.oversample_fg)
        base = iter(PatchSampler(train_ds, self.train_patch_size, self.plan.batch_size,
                                 oversample, seed=cfg.seed,
                                 probabilistic_oversampling=probabilistic))
        if self.host_spatial is not None:
            base = (self.host_spatial(d, s) for d, s in base)
        return (Prefetcher(_timed(base, self.host_batch_seconds)),
                Prefetcher(iter(PatchSampler(val_ds, self.plan.patch_size,
                                             self.plan.batch_size, oversample,
                                             seed=cfg.seed + 1,
                                             probabilistic_oversampling=probabilistic))))

    def run_training(self, train_ds: PreprocessedDataset, val_ds: PreprocessedDataset,
                     num_epochs: Optional[int] = None, continue_training: bool = False):
        cfg = self.cfg
        num_epochs = num_epochs or cfg.num_epochs
        if continue_training:
            for name in ("checkpoint_latest.pkl", "checkpoint_best.pkl",
                         "checkpoint_final.pkl"):
                path = os.path.join(self.output_dir, name)
                if os.path.exists(path):
                    self.load_checkpoint(path)
                    self.log(f"resumed from {name} at epoch {self.current_epoch}")
                    break
        train_iter, val_iter = self._iterators(train_ds, val_ds)
        os.makedirs(self.output_dir, exist_ok=True)
        try:
            for epoch in range(self.current_epoch, num_epochs):
                self._epoch(epoch, num_epochs, train_iter, val_iter)
        finally:
            for it in (train_iter, val_iter):
                if isinstance(it, Prefetcher):
                    it.close()
        if not self.disable_checkpointing:
            self.save_checkpoint(os.path.join(self.output_dir, "checkpoint_final.pkl"))
        self._write_benchmark_result()
        self.log_timing("training")

    def log_timing(self, what: str):
        """One ``timing <what> {json}`` line in ``training_log.txt``: the host
        seconds of each iteration, batch (sampling + spatial DA), validation
        case and checkpoint write, the device's peak allocated bytes, and the
        host crop/resample calls by route, for callers that run the CLI in
        a subprocess."""
        from ldiffusion_tpu_torch import native

        cuda = self.device.type == "cuda"
        self.log(f"timing {what} " + json.dumps({
            "iteration_s": self.iter_seconds, "host_batch_s": self.host_batch_seconds,
            "validation_case_s": self.val_case_seconds,
            "checkpoint_s": self.checkpoint_seconds,
            "max_memory_allocated": torch.cuda.max_memory_allocated(self.device) if cuda
            else None,
            "native_routes": native.launches_by_route}), also_print=False)

    def _epoch(self, epoch, num_epochs, train_iter, val_iter):
        cfg = self.cfg
        t0 = time.time()
        lr = lr_at_epoch(self.variant, epoch, num_epochs) if self.variant is not None \
            else poly_lr(cfg.initial_lr, epoch, num_epochs)
        self.epoch_log.log("lr", lr, epoch)
        self.net.train()
        tl = 0.0
        for _ in range(cfg.iters_per_epoch):
            data, seg = next(train_iter)
            t_it = time.perf_counter()
            tl += float(self.train_step(data, seg, lr))
            self.iter_seconds.append(time.perf_counter() - t_it)
        self.epoch_log.log("train_loss", tl / cfg.iters_per_epoch, epoch)

        self.net.eval()
        vl = 0.0
        n_heads = self.plan.num_classes + (1 if self.region_lut is not None else 0)
        tp, fp, fn = np.zeros(n_heads), np.zeros(n_heads), np.zeros(n_heads)
        for _ in range(cfg.val_iters_per_epoch):
            l, tpi, fpi, fni = self.val_step(*next(val_iter))
            read = torch.cat([l.reshape(1).double(), tpi.double(), fpi.double(),
                              fni.double()]).cpu().numpy()  # one host read a step
            vl += read[0]
            tp += read[1:1 + n_heads]
            fp += read[1 + n_heads:1 + 2 * n_heads]
            fn += read[1 + 2 * n_heads:]
        self.epoch_log.log("val_loss", vl / cfg.val_iters_per_epoch, epoch)
        dice_pc = 2 * tp[1:] / np.maximum(2 * tp[1:] + fp[1:] + fn[1:], 1e-8)
        mean_fg = float(np.mean(dice_pc))
        self.epoch_log.log("mean_fg_dice", mean_fg, epoch)
        ema = self.epoch_log.get("ema_fg_dice", epoch)
        self.epoch_log.log("epoch_time", time.time() - t0, epoch)
        self.log(f"Epoch {epoch}: loss {tl / cfg.iters_per_epoch:.4f} "
                 f"val {vl / cfg.val_iters_per_epoch:.4f} "
                 f"pseudo-dice {mean_fg:.4f} (EMA {ema:.4f}) "
                 f"lr {lr:.5f} [{time.time() - t0:.1f}s]")

        self.current_epoch = epoch + 1
        if self.best_ema is None or ema > self.best_ema:
            self.best_ema = ema
            if not self.disable_checkpointing:
                self.save_checkpoint(os.path.join(self.output_dir, "checkpoint_best.pkl"))
        if not self.disable_checkpointing and \
                ((epoch + 1) % cfg.save_every == 0 or epoch == num_epochs - 1):
            self.save_checkpoint(os.path.join(self.output_dir, "checkpoint_latest.pkl"))
        if is_main_process():
            self.epoch_log.plot_progress(os.path.join(self.output_dir, "progress.png"))

    def _write_benchmark_result(self):
        """``benchmark_result.json`` (reference ``nnUNetTrainerBenchmark_5epochs.py``):
        the fastest and mean epoch time and the environment."""
        times = [t for t in self.epoch_log.data.get("epoch_time", []) if t == t]
        if not times or not is_main_process():
            return
        cuda = self.device.type == "cuda"
        result = {
            "fastest_epoch_s": min(times),
            "mean_epoch_s": sum(times) / len(times),
            "num_epochs": len(times),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device": torch.cuda.get_device_name(self.device) if cuda else str(self.device),
            "num_devices": torch.cuda.device_count() if cuda else 1,
            "batch_size": self.plan.batch_size,
            "patch_size": list(self.plan.patch_size),
        }
        with open(os.path.join(self.output_dir, "benchmark_result.json"), "w") as f:
            json.dump(result, f, indent=2)

    # ------------------------------------------------------------------
    def perform_actual_validation(self, val_images, val_labels, save_npz: bool = False,
                                  normalize: bool = True):
        """Sliding-window prediction of every validation case (the variant's
        mirror TTA, the label regime's mask), PNGs beside the labels' in
        ``validation_gt/``, ``summary.json`` (region-keyed, ignore pixels
        left out, under a label manager) and the ``postprocessing.json``
        decision (``trainer.py:567-703``): each process predicts the cases
        ``i % world == rank``, and rank 0 scores them all after a barrier.
        val_images: (H, W, C) arrays; val_labels: (H, W) ints; for a 3D plan
        (Z, H, W, C) and (Z, H, W), the cases written as ``.npy``.
        ``save_npz`` (``--npz``): each case's
        probabilities too, ``case_NNN.npz``, from the same logits.
        ``normalize=False`` for cases of the preprocessed store, which are
        z-scored already."""
        from PIL import Image

        from ldiffusion_tpu_torch.segmentor.export import save_probabilities_npz
        from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor

        lm = self.label_manager
        out_dir = os.path.join(self.output_dir, "validation")
        os.makedirs(out_dir, exist_ok=True)
        gt_out = os.path.join(self.output_dir, "validation_gt")
        os.makedirs(gt_out, exist_ok=True)
        nd = len(self.plan.patch_size)
        use_mirroring, mirror_axes = inference_mirror_config(self.variant, nd)
        predictor = SlidingWindowPredictor(self.plan, [self.net.state_dict()],
                                           dtype=self.compute_dtype, device=self.device,
                                           label_manager=lm, use_mirroring=use_mirroring,
                                           mirror_axes=mirror_axes)
        rank, world = (self.mesh.rank, self.mesh.world) if self.mesh is not None else (0, 1)
        for i, (img, lab) in enumerate(zip(val_images, val_labels)):
            if i % world != rank:
                continue  # the cases interleave over the processes
            t0 = time.perf_counter()
            img = np.asarray(img, np.float32)
            if save_npz:  # one prediction: the logits feed both the npz and the mask
                logits = predictor.predict_logits(img, normalize=normalize)
                save_probabilities_npz(logits, os.path.join(out_dir, f"case_{i:03d}.npz"),
                                       label_manager=lm)
                seg = (lm.convert_logits_to_segmentation(logits) if lm is not None
                       else np.argmax(logits, axis=-1).astype(np.uint8))
            else:
                seg = predictor.predict(img, normalize=normalize)
            self.val_case_seconds.append(time.perf_counter() - t0)
            if self.is_3d:
                np.save(os.path.join(out_dir, f"case_{i:03d}.npy"), seg)
                np.save(os.path.join(gt_out, f"case_{i:03d}.npy"), np.asarray(lab, np.int16))
            else:
                Image.fromarray(seg).save(os.path.join(out_dir, f"case_{i:03d}.png"))
                Image.fromarray(np.asarray(lab, np.uint8)).save(
                    os.path.join(gt_out, f"case_{i:03d}.png"))
        # every rank's cases are written before rank 0 scores the folder
        self.barrier("final_validation_cases_written")
        summary_path = os.path.join(out_dir, "summary.json")
        if rank == 0:
            summary = self._score_validation(out_dir, gt_out, summary_path)
        self.barrier("final_validation_summary_written")
        if rank != 0:
            with open(summary_path) as f:
                summary = json.load(f)
        self.log(f"final validation foreground dice: {summary['foreground_mean']['Dice']:.4f}")
        self.log_timing("validation")
        return summary

    def barrier(self, name: str):
        """Every process of the mesh waits here (nothing in one process)."""
        if self.mesh is not None:
            self.mesh.barrier(name)

    def _score_validation(self, out_dir, gt_out, summary_path):
        """``summary.json`` and the ``postprocessing.json`` decision over every
        case in the folder (rank 0)."""
        from ldiffusion_tpu_torch.evaluate import compute_metrics_on_folder, read_mask
        from ldiffusion_tpu_torch.segmentor.postprocess import (
            determine_postprocessing,
            save_postprocessing,
        )

        lm = self.label_manager
        summary = compute_metrics_on_folder(
            out_dir, gt_out, self.plan.num_classes, output_file=summary_path,
            regions_or_labels=lm.labels_or_regions_for_eval if lm is not None else None,
            ignore_label=lm.ignore_label if lm is not None else None)
        ending = ".npy" if self.is_3d else ".png"
        files = sorted(f for f in os.listdir(out_dir) if f.endswith(ending))
        preds = [read_mask(os.path.join(out_dir, f)) for f in files]
        gts = [read_mask(os.path.join(gt_out, f)) for f in files]
        if preds:
            # painted region labels and the ignore label can exceed the head count
            n_pp, ignore = self.plan.num_classes, None
            if lm is not None:
                n_pp = self.n_labels
                ignore = lm.ignore_label
            steps = determine_postprocessing(preds, gts, n_pp, ignore_label=ignore)
            save_postprocessing(steps, os.path.join(self.output_dir, "postprocessing.json"))
        return summary

    # ------------------------------------------------------------------
    def _opt_buffers(self, name: str):
        """{parameter name: the optimizer's ``name`` buffer} (zeros before the
        first step)."""
        out = {}
        for pname, p in self.net.named_parameters():
            buf = self.opt.state.get(p, {}).get(name)
            out[pname] = torch.zeros_like(p) if buf is None else buf
        return out

    def _momentum_state(self):
        """{parameter name: SGD momentum buffer}."""
        return self._opt_buffers("momentum_buffer")

    def save_checkpoint(self, path: str):
        t0 = time.perf_counter()
        sd = self.net.state_dict()
        opt_state = {"learning_rate": float(self.opt.param_groups[0]["lr"])}
        for name in _OPT_BUFFERS[self.opt_name]:
            key = "momentum" if name == "momentum_buffer" else name
            opt_state[key] = dynunet_to_flax(self._opt_buffers(name), self.net_config)
        save_pytree(path, {
            "params": dynunet_to_flax(sd, self.net_config),
            "opt_state": opt_state,
            "step": np.asarray(self.step, np.int32),
            "batch_stats": dynunet_batch_stats_to_flax(sd, self.net_config),
            "epoch": self.current_epoch,
            "best_ema": self.best_ema,
            "logger": self.epoch_log.state_dict(),
            "plan": self.plan.to_json(),
        })
        self.checkpoint_seconds.append(time.perf_counter() - t0)

    def load_pretrained(self, path: str):
        """``-pretrained_weights`` (reference ``load_pretrained_weights.py``):
        the parameters whose flax path and shape match, from either package's
        checkpoint, into the fresh net; the optimizer, epoch, logger and
        running statistics stay as they are. Returns the transferred paths."""
        from ldiffusion_tpu_torch.segmentor.pretrained import transfer_pretrained_weights

        ck = load_pytree(path)
        src = ck["params"] if isinstance(ck, dict) and "params" in ck else ck
        sd = self.net.state_dict()
        new, transferred, _ = transfer_pretrained_weights(
            dynunet_to_flax(sd, self.net_config), src)
        if not transferred:
            raise ValueError(f"no shape-matched tensors in {path}")
        sd.update(dynunet_from_flax(new, self.net_config,
                                    dynunet_batch_stats_to_flax(sd, self.net_config)))
        self.net.load_state_dict(sd)
        self.log(f"pretrained weights: transferred {len(transferred)} tensors from {path}")
        return transferred

    def _put_state(self, p, name: str, value):
        """Write the optimizer's ``name`` buffer of ``p`` in place where it
        exists (a captured step reads it), else make it: on ``p``'s device,
        but for the count of an Adam that is not ``capturable``, which torch
        keeps on the host."""
        st = self.opt.state[p]
        if name in st:
            st[name].copy_(value)
            return
        host = name == "step" and not self.opt.param_groups[0].get("capturable", True)
        st[name] = value.to("cpu" if host else p.device)

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint of this trainer or of the JAX trainer
        (its optax state mapped onto this optimizer's buffers), the
        parameters and buffers written in place."""
        ck = load_pytree(path)
        opt_state = ck.get("opt_state")
        if isinstance(opt_state, Inert):
            opt_state = optax_to_port_state(opt_state, self.opt_name, path)
        names = _OPT_BUFFERS[self.opt_name]
        keys = ["momentum" if n == "momentum_buffer" else n for n in names]
        if not (isinstance(opt_state, dict) and all(k in opt_state for k in keys)):
            raise NotImplementedError(
                f"{path}: the recipe's optimizer is {self.opt_name!r}, the checkpoint holds "
                f"the buffers {sorted(opt_state) if isinstance(opt_state, dict) else opt_state}: "
                "another optimizer family cannot be resumed")
        self.net.load_state_dict(dynunet_from_flax(ck["params"], self.net_config,
                                                   ck.get("batch_stats")))
        for name, key in zip(names, keys):
            bufs = dynunet_from_flax(opt_state[key], self.net_config)
            for pname, p in self.net.named_parameters():
                self._put_state(p, name, bufs[pname])
        if self.opt_name != "sgd":
            for p in self.net.parameters():
                self._put_state(p, "step", torch.tensor(float(ck["step"])))
        self._set_lr(float(opt_state["learning_rate"]))
        self.step = int(ck["step"])
        self.current_epoch = ck["epoch"]
        self.best_ema = ck["best_ema"]
        self.epoch_log.load_state_dict(ck["logger"])
