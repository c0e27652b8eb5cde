"""Stage-1 Laplace warm-up trainer (counterpart of
``ldiffusion_tpu/train/ldiffusion.py``), on one device.

One step = the whole timestep trajectory (``trajectory_features``, each
timestep recomputed in the backward when ``config.remat``), the VGG content
loss + InfoNCE contrastive loss, backward, global gradient clip (1.0), AdamW.

Precision: the UNet and the text projection are trained. Their master copies
and the AdamW state are ``config.param_dtype`` (f32); the modules themselves
run forward and backward in ``config.compute_dtype`` (bf16): each step's
gradients are cast up to the master copies, the update is taken there, and
the modules get the updated values cast down — what flax's
``param_dtype``/``dtype`` split does inside each op. The VAE and the text
tower are frozen, but gradients flow through ``vae.decode`` to the UNet.

torch's ``AdamW`` is optax's ``adamw`` (decoupled decay ``p − lr·wd·p``, eps
added to ``sqrt(v̂)``); ``clip_grad_norm_`` is ``clip_by_global_norm`` with
``1e-6`` added to the norm in the divisor.

Randomness: the Laplace noise and the contrastive indices are drawn from one
``torch.Generator`` seeded with ``config.seed``; ``loss_and_grads`` takes them
as tensors, so a test can hand in the JAX package's draws.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch

from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
from ldiffusion_tpu_torch.core.logging import CSVLogger, TextLogger
from ldiffusion_tpu_torch.diffusion.pipeline import (
    SDComponents,
    trajectory_features,
    trajectory_timesteps,
)
from ldiffusion_tpu_torch.diffusion.schedulers import laplace_noise
from ldiffusion_tpu_torch.losses.infonce import ContrastIndices, InfoNceLoss
from ldiffusion_tpu_torch.models.convert import save_unet_dir


class DiffusionWarmupTrainer:
    def __init__(self, components: SDComponents, config: DiffusionTrainConfig,
                 work_dir: str = "train_save", info_nce: Optional[InfoNceLoss] = None):
        self.c = components
        self.cfg = config
        self.work_dir = work_dir
        self.device = components.device
        self.log = TextLogger()
        self.info_nce = info_nce or InfoNceLoss.create(num_classes=config.num_classes,
                                                       device=self.device)
        self.trajectory_steps = max(1, int(config.num_inference_steps / 5))
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        # trained: UNet + projection; master copies taken before the cast down
        self.trainable = {"unet": components.unet, "proj": components.proj}
        self.names = [(key, name) for key, m in self.trainable.items()
                      for name, _ in m.named_parameters()]
        self.params = [p for m in self.trainable.values() for p in m.parameters()]
        param_dtype = getattr(torch, config.param_dtype)
        self.master = [p.detach().to(param_dtype, copy=True) for p in self.params]
        components.to(dtype=getattr(torch, config.compute_dtype))
        for m in (components.vae, components.text):
            m.requires_grad_(False)
        for p in self.params:
            p.requires_grad_(True)
        self.opt = torch.optim.AdamW(self.master, lr=config.learning_rate,
                                     betas=tuple(config.betas), eps=config.eps,
                                     weight_decay=config.weight_decay)
        self.steps_done = 0
        self.history = []  # train_step's metrics, with its wall-clock "seconds"

    # -- randomness -----------------------------------------------------------
    def draw(self, images, labels):
        """(noise (T, B, H/f, W/f, 4), contrastive indices) for one step."""
        b, h, w, _ = images.shape
        f = self.c.latent_factor
        n_t = len(trajectory_timesteps(self.c, self.trajectory_steps)[0])
        noise = laplace_noise((n_t, b, h // f, w // f, self.c.vae_config.latent_channels),
                              self.generator, device=self.device)
        return noise, self.info_nce.sample(labels, self.generator)

    # -- step -----------------------------------------------------------------
    def _loss_fn(self, images, labels, noise, indices: ContrastIndices):
        del labels  # the contrastive indices already encode them
        traj, final_rgb = trajectory_features(self.c, images, noise, self.trajectory_steps,
                                              remat=self.cfg.remat)
        # reference upsamples the decode 64→1024 and VGG resizes to 224: a pure
        # bilinear chain, so both sides go 64→224 directly (as the JAX package)
        content = self.info_nce.content_loss(images, final_rgb)
        contrast = self.info_nce.contrast(traj, indices)
        return content + contrast, {"content": content.detach(), "contrast": contrast.detach()}

    def loss_and_grads(self, images, labels, noise, indices: ContrastIndices):
        """Forward + backward; leaves the (unclipped) gradients on the master
        copies. Returns (loss, {"content", "contrast"}), detached."""
        for p in self.params:
            p.grad = None
        loss, aux = self._loss_fn(images, labels, noise, indices)
        loss.backward()
        for p, m in zip(self.params, self.master):
            m.grad = torch.zeros_like(m) if p.grad is None else p.grad.to(m.dtype)
            p.grad = None
        return loss.detach(), aux

    def apply_update(self):
        """Clip, AdamW on the master copies, cast them into the modules.
        Returns the gradient norm before clipping."""
        norm = torch.nn.utils.clip_grad_norm_(self.master, self.cfg.grad_clip)
        self.opt.step()
        with torch.no_grad():
            for p, m in zip(self.params, self.master):
                p.copy_(m)
        self.steps_done += 1
        return norm

    def train_step(self, images, labels) -> dict:
        """images (B, H, W, 3) ImageNet-normalised, labels (B, 64, 64) class
        ids; numpy or tensors. Returns float metrics."""
        t0 = time.perf_counter()
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        labels = torch.as_tensor(labels, device=self.device).long()
        noise, indices = self.draw(images, labels)
        loss, aux = self.loss_and_grads(images, labels, noise, indices)
        norm = self.apply_update()
        metrics = {"loss": float(loss), **{k: float(v) for k, v in aux.items()},
                   "grad_norm": float(norm)}
        metrics["seconds"] = time.perf_counter() - t0  # the loss read waits for the device
        self.history.append(metrics)
        return metrics

    # -- loop -----------------------------------------------------------------
    def train(self, train_iter, steps_per_epoch: int, num_epochs: Optional[int] = None,
              save_dir: Optional[str] = None) -> str:
        """train_iter yields (images (B, 64, 64, 3) float32 normalised, labels
        (B, 64, 64) int). CSV log of the epoch loss; saves on a new best epoch
        loss, starting from 100.0 (the reference's). Returns the save dir."""
        num_epochs = num_epochs or self.cfg.num_epochs
        date = time.strftime("%y_%m_%d")
        save_dir = save_dir or os.path.join(self.work_dir, "unet", date)
        csv_log = CSVLogger(os.path.join(self.work_dir, "loss", date, "contrast_loss.csv"))
        best = 100.0
        for epoch in range(num_epochs):
            t0 = time.time()
            total = 0.0
            for _ in range(steps_per_epoch):
                images, labels = next(train_iter)
                total += self.train_step(images, labels)["loss"]
            cur = total / max(1, steps_per_epoch)
            self.log(f"Epoch [{epoch + 1}/{num_epochs}], Loss: {cur:.4f}, "
                     f"Elapsed Time: {time.time() - t0:.1f}s")
            if cur < best:
                best = cur
                self.save(save_dir)
            csv_log.append(epoch + 1, cur)
        return save_dir

    def state_dicts(self):
        """{"unet": ..., "proj": ...} of the master copies."""
        out = {key: {} for key in self.trainable}
        for (key, name), m in zip(self.names, self.master):
            out[key][name] = m
        return out

    def save(self, save_dir: str):
        """The master copies in the JAX trainer's UNet directory layout."""
        sds = self.state_dicts()
        save_unet_dir(save_dir, self.c.unet_config, sds["unet"], sds["proj"])
        self.log(f"saved checkpoint to {save_dir}")
