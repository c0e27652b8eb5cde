"""nnU-Net-style segmentor trainer, the default path (counterpart of
``ldiffusion_tpu/segmentor/trainer.py``; reference ``nnUNetTrainer.py``).

SGD-nesterov (lr 1e-2, momentum 0.99, coupled weight decay 3e-5) after
``clip_grad_norm_(12)`` (the order of ``:204-212``: clip the raw gradients,
then the optimizer adds wd·θ), PolyLR ``(1 − e/E)^0.9`` set once an epoch,
deep-supervision DC+CE, the EMA(0.9) pseudo-Dice deciding
``checkpoint_best``, ``checkpoint_latest`` every ``save_every`` epochs and at
the end, ``checkpoint_final``, and resuming (``continue_training``).

One train step (``:330-352``): device augmentation → labels ``max(seg, 0)``
(the crop padding trains as background) → mode-pooled deep-supervision
targets → loss → backward → clip → SGD. Patches come from ``PatchSampler``
at the enlarged initial size, through the host rotation/scaling
(``HostSpatialAugmenter``) in a prefetch thread.

Precision: the parameters and the momentum are float32; with
``compute_dtype="bfloat16"`` the DynUNet computes in bf16 over them (its
``compute_dtype``), with the norms' statistics and the losses in float32.

Checkpoints are the JAX trainer's pickle layout (``save_pytree``):
``params`` in the flax layout (``dynunet_to_flax``), ``step``,
``batch_stats`` ``{}``, ``epoch``, ``best_ema``, ``logger``, ``plan``; the
JAX package's ``load_pytree`` and predictor read them. ``opt_state`` holds
the port's own momentum buffers in the flax layout, so only the port
resumes from them.

Not ported (they raise ``NotImplementedError``, ROADMAP queue 1,
*Long tail*): trainer variants, label managers (regions, ignore label), the
BatchNorm, residual and 3D networks, ``load_pretrained``, the npz export of
validation probabilities, multi-process validation (*Distribution*).
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

from ldiffusion_tpu_torch.core.checkpoint import load_pytree, save_pytree
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.core.logging import EpochLogger, TextLogger, dump_debug_json
from ldiffusion_tpu_torch.data.augment import (
    AugmentConfig,
    HostSpatialAugmenter,
    augment_batch,
    check_supported,
    configure_spatial_da,
)
from ldiffusion_tpu_torch.data.patches import PatchSampler
from ldiffusion_tpu_torch.data.prefetch import Prefetcher
from ldiffusion_tpu_torch.losses.dice import dc_and_ce_loss, deep_supervision_loss
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax, dynunet_to_flax
from ldiffusion_tpu_torch.models.dynunet import DynUNet
from ldiffusion_tpu_torch.models.layers import init_random_
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset

_LATER = "is not ported yet (ROADMAP queue 1, *Long tail*)"


def poly_lr(initial_lr: float, epoch: int, max_epochs: int, exponent: float = 0.9) -> float:
    """Reference ``polylr.py:4-21``."""
    return initial_lr * (1 - epoch / max_epochs) ** exponent


def _pools(s) -> bool:
    return (max(s) > 1) if isinstance(s, (tuple, list)) else (s > 1)


def downsample_seg(seg, s, num_labels: int):
    """Mode pool of (B, H, W) int labels over s×s windows
    (``ldiffusion_tpu/segmentor/trainer.py:752-769``): -1 votes as its own
    label; ties go to the lowest value, as ``argmax`` takes the first."""
    if isinstance(s, (tuple, list)):
        s = tuple(int(v) for v in s)
    onehot = F.one_hot((seg + 1).long(), num_labels + 1).permute(0, 3, 1, 2).float()
    counts = F.avg_pool2d(onehot, s, s)
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
                 device=None):
        if variant is not None:
            raise NotImplementedError(f"trainer variants {_LATER}")
        if label_manager is not None:
            raise NotImplementedError(f"label managers (regions, ignore label) {_LATER}")
        if len(plan.patch_size) != 2:
            raise NotImplementedError(f"3D plans {_LATER}")
        self.plan = plan
        self.cfg = config
        self.output_dir = output_dir
        self.device = resolve_device(device)
        self.augment_cfg = augment or AugmentConfig()
        check_supported(self.augment_cfg)
        # rotation/scaling run on the host, from patches sampled at the
        # enlarged initial size (trainer.py:103-149)
        self.host_spatial = None
        self.train_patch_size = tuple(plan.patch_size)
        if self.augment_cfg.p_rotation > 0 or self.augment_cfg.p_scaling > 0:
            spatial = configure_spatial_da(plan.patch_size,
                                           self.augment_cfg.initial_scale_range)
            self.train_patch_size = spatial.initial_patch_size
            self.augment_cfg = dataclasses.replace(self.augment_cfg,
                                                   rotation_max=spatial.rotation_max[0])
            self.host_spatial = HostSpatialAugmenter(self.augment_cfg, seed=config.seed + 17,
                                                     out_size=plan.patch_size)
            self.augment_cfg = dataclasses.replace(self.augment_cfg, p_rotation=0.0,
                                                   p_scaling=0.0)
        self.log = TextLogger(os.path.join(output_dir, "training_log.txt"))
        self.epoch_log = EpochLogger(config.ema_decay)
        self.current_epoch = 0
        self.best_ema: Optional[float] = None

        self.compute_dtype = getattr(torch, config.compute_dtype)
        self.net_config = plan.network_config()
        net = init_random_(DynUNet(self.net_config), torch.Generator().manual_seed(config.seed))
        self.net = net.to(self.device, memory_format=torch.channels_last)
        self.net.compute_dtype = self.compute_dtype
        self.opt = torch.optim.SGD(self.net.parameters(), lr=config.initial_lr,
                                   momentum=config.momentum, nesterov=True,
                                   weight_decay=config.weight_decay)
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        # measurements: host seconds a train iteration (ending in the loss
        # read), of patch sampling + host spatial DA a batch, a validation
        # case, a checkpoint write (outside the epoch_time stamp, as in JAX)
        self.iter_seconds: List[float] = []
        self.host_batch_seconds: List[float] = []
        self.val_case_seconds: List[float] = []
        self.checkpoint_seconds: List[float] = []
        dump_debug_json(os.path.join(output_dir, "debug.json"),
                        {"plan": plan.to_json(), "config": config.to_json()})

    # ------------------------------------------------------------------
    def _to_device(self, data, seg):
        """(B, H, W, C) / (B, H, W) host batch → (B, C, H, W) float32 and
        (B, H, W) int64 on the device."""
        data = torch.as_tensor(data, dtype=torch.float32).to(self.device, non_blocking=True)
        seg = torch.as_tensor(seg).to(self.device, non_blocking=True).long()
        return data.permute(0, 3, 1, 2), seg

    def ds_targets(self, seg, n: int):
        """The deep-supervision targets of the first ``n`` heads."""
        out, cur = [seg], seg
        for s in self.plan.strides[1:]:
            if len(out) >= n:
                break
            if _pools(s):
                cur = downsample_seg(cur, s, self.plan.num_classes)
                out.append(cur)
        return out

    def _one_loss(self, logits, seg):
        return dc_and_ce_loss(logits, seg, batch_dice=self.plan.batch_dice)

    def loss_and_grads(self, data, seg):
        """Forward + backward on an augmented (B, C, H, W) batch and its
        (B, H, W) labels; leaves the raw gradients on the parameters.
        Returns the loss, detached."""
        self.opt.zero_grad(set_to_none=True)
        seg = seg.clamp_min(0)  # RemoveLabelTransform(-1, 0)
        outputs = self.net(data, train=True)
        if not isinstance(outputs, list):
            outputs = [outputs]
        loss = deep_supervision_loss(outputs, self.ds_targets(seg, len(outputs)),
                                     self._one_loss)
        loss.backward()
        return loss.detach()

    def apply_update(self, lr: Optional[float] = None):
        """clip_grad_norm_ then the SGD step. Returns the norm before clipping."""
        if lr is not None:
            for group in self.opt.param_groups:
                group["lr"] = lr
        norm = torch.nn.utils.clip_grad_norm_(self.net.parameters(), self.cfg.grad_clip)
        self.opt.step()
        self.step += 1
        return norm

    def train_step(self, data, seg, lr: Optional[float] = None):
        """One step on a host batch: device DA, loss, backward, update."""
        data, seg = self._to_device(data, seg)
        data, seg = augment_batch(data, seg, self.augment_cfg, self.generator)
        loss = self.loss_and_grads(data, seg)
        self.apply_update(lr)
        return loss

    @torch.no_grad()
    def val_step(self, data, seg):
        """(loss, tp, fp, fn per class) of the full-resolution head."""
        data, seg = self._to_device(data, seg)
        seg = seg.clamp_min(0)
        logits = self.net(data)
        loss = self._one_loss(logits, seg)
        c = self.plan.num_classes
        cm = torch.bincount((seg * c + logits.argmax(dim=1)).reshape(-1),
                            minlength=c * c).reshape(c, c)
        tp = torch.diagonal(cm)
        return loss, tp, cm.sum(0) - tp, cm.sum(1) - tp

    # ------------------------------------------------------------------
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
        base = iter(PatchSampler(train_ds, self.train_patch_size, self.plan.batch_size,
                                 cfg.oversample_fg, seed=cfg.seed))
        if self.host_spatial is not None:
            base = (self.host_spatial(d, s) for d, s in base)
        train_iter = Prefetcher(_timed(base, self.host_batch_seconds))
        val_iter = Prefetcher(iter(PatchSampler(val_ds, self.plan.patch_size,
                                                self.plan.batch_size, cfg.oversample_fg,
                                                seed=cfg.seed + 1)))
        os.makedirs(self.output_dir, exist_ok=True)
        try:
            for epoch in range(self.current_epoch, num_epochs):
                self._epoch(epoch, num_epochs, train_iter, val_iter)
        finally:
            train_iter.close()
            val_iter.close()
        self.save_checkpoint(os.path.join(self.output_dir, "checkpoint_final.pkl"))
        self._write_benchmark_result()

    def _epoch(self, epoch, num_epochs, train_iter, val_iter):
        cfg = self.cfg
        t0 = time.time()
        lr = poly_lr(cfg.initial_lr, epoch, num_epochs)
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
        c = self.plan.num_classes
        tp, fp, fn = np.zeros(c), np.zeros(c), np.zeros(c)
        for _ in range(cfg.val_iters_per_epoch):
            l, tpi, fpi, fni = self.val_step(*next(val_iter))
            vl += float(l)
            tp += tpi.cpu().numpy()
            fp += fpi.cpu().numpy()
            fn += fni.cpu().numpy()
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
            self.save_checkpoint(os.path.join(self.output_dir, "checkpoint_best.pkl"))
        if (epoch + 1) % cfg.save_every == 0 or epoch == num_epochs - 1:
            self.save_checkpoint(os.path.join(self.output_dir, "checkpoint_latest.pkl"))
        self.epoch_log.plot_progress(os.path.join(self.output_dir, "progress.png"))

    def _write_benchmark_result(self):
        """``benchmark_result.json`` (reference ``nnUNetTrainerBenchmark_5epochs.py``):
        the fastest and mean epoch time and the environment."""
        times = [t for t in self.epoch_log.data.get("epoch_time", []) if t == t]
        if not times:
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
    def perform_actual_validation(self, val_images, val_labels, save_npz: bool = False):
        """Sliding-window prediction of every validation case (mirror TTA,
        z-score normalisation), PNGs beside the labels' in
        ``validation_gt/``, ``summary.json`` and the ``postprocessing.json``
        decision (``trainer.py:567-703``, one process). val_images: (H, W, C)
        arrays, diffusion-transformed; val_labels: (H, W) ints."""
        from PIL import Image

        from ldiffusion_tpu_torch.evaluate import compute_metrics_on_folder
        from ldiffusion_tpu_torch.segmentor.postprocess import (
            determine_postprocessing,
            save_postprocessing,
        )
        from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor

        if save_npz:
            raise NotImplementedError(f"the npz export of validation probabilities {_LATER}")
        out_dir = os.path.join(self.output_dir, "validation")
        os.makedirs(out_dir, exist_ok=True)
        gt_out = os.path.join(self.output_dir, "validation_gt")
        os.makedirs(gt_out, exist_ok=True)
        predictor = SlidingWindowPredictor(self.plan, [self.net.state_dict()],
                                           dtype=self.compute_dtype, device=self.device)
        for i, (img, lab) in enumerate(zip(val_images, val_labels)):
            t0 = time.perf_counter()
            seg = predictor.predict(np.asarray(img, np.float32))
            self.val_case_seconds.append(time.perf_counter() - t0)
            Image.fromarray(seg).save(os.path.join(out_dir, f"case_{i:03d}.png"))
            Image.fromarray(np.asarray(lab, np.uint8)).save(
                os.path.join(gt_out, f"case_{i:03d}.png"))
        summary = compute_metrics_on_folder(out_dir, gt_out, self.plan.num_classes,
                                            output_file=os.path.join(out_dir, "summary.json"))
        preds, gts = [], []
        for f in sorted(os.listdir(out_dir)):
            if f.endswith(".png"):
                with Image.open(os.path.join(out_dir, f)) as p, \
                        Image.open(os.path.join(gt_out, f)) as g:
                    preds.append(np.asarray(p))
                    gts.append(np.asarray(g))
        if preds:
            steps = determine_postprocessing(preds, gts, self.plan.num_classes)
            save_postprocessing(steps, os.path.join(self.output_dir, "postprocessing.json"))
        self.log(f"final validation foreground dice: {summary['foreground_mean']['Dice']:.4f}")
        return summary

    # ------------------------------------------------------------------
    def _momentum_state(self):
        """{parameter name: momentum buffer} (zeros before the first step)."""
        out = {}
        for name, p in self.net.named_parameters():
            buf = self.opt.state.get(p, {}).get("momentum_buffer")
            out[name] = torch.zeros_like(p) if buf is None else buf
        return out

    def save_checkpoint(self, path: str):
        t0 = time.perf_counter()
        save_pytree(path, {
            "params": dynunet_to_flax(self.net.state_dict(), self.net_config),
            "opt_state": {"momentum": dynunet_to_flax(self._momentum_state(), self.net_config),
                          "learning_rate": float(self.opt.param_groups[0]["lr"])},
            "step": np.asarray(self.step, np.int32),
            "batch_stats": {},
            "epoch": self.current_epoch,
            "best_ema": self.best_ema,
            "logger": self.epoch_log.state_dict(),
            "plan": self.plan.to_json(),
        })
        self.checkpoint_seconds.append(time.perf_counter() - t0)

    def load_pretrained(self, path: str):
        raise NotImplementedError(f"load_pretrained {_LATER}")

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint this trainer wrote."""
        ck = load_pytree(path)
        if ck.get("batch_stats"):
            raise NotImplementedError(f"{path}: BatchNorm checkpoints {_LATER}")
        opt_state = ck.get("opt_state")
        if not (isinstance(opt_state, dict) and "momentum" in opt_state):
            raise NotImplementedError(f"{path}: resuming from the JAX package's optax state "
                                      "is not supported; its params load through the "
                                      "predictor")
        self.net.load_state_dict(dynunet_from_flax(ck["params"], self.net_config))
        momentum = dynunet_from_flax(opt_state["momentum"], self.net_config)
        for name, p in self.net.named_parameters():
            self.opt.state[p]["momentum_buffer"] = momentum[name].to(p.device)
        for group in self.opt.param_groups:
            group["lr"] = float(opt_state["learning_rate"])
        self.step = int(ck["step"])
        self.current_epoch = ck["epoch"]
        self.best_ema = ck["best_ema"]
        self.epoch_log.load_state_dict(ck["logger"])
