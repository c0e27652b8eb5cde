"""Stage-1 Laplace warm-up trainer (counterpart of
``ldiffusion_tpu/train/ldiffusion.py``), on one device or over a mesh.

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

One program a step (the JAX ``_make_train_step``: one ``jax.jit`` over the
draws, the trajectory, VGG and InfoNCE, the backward, the clip and AdamW,
the state donated). ``step_fn`` is that step on device tensors: ``draw``,
``loss_and_grads``, ``clip_grad_norm_``, AdamW (``capturable`` on a card:
its step count and bias corrections on the device) and the cast of the
masters into the modules, returning (loss, content, contrast, gradient
norm) as device tensors. On one device and over a mesh alike,
``train_step`` runs it through ``core/graphs.py``'s ``Jit`` of
``TrainProgram``s: a batch shape's first step eagerly, its second captured
as a CUDA graph (the generator registered with it, the memory from the
trainer's pool), replays after; the four values are read with one host
sync a step, as the JAX loop's ``float(metrics["loss"])``. ``load_state``
writes the masters and the AdamW state in place, so the graphs read what it
loaded.

Tracing (``core/tracing.py``, while a ``torch.profiler`` session records):
``train_step`` is the span ``train_step``, with the children
``train_step/inputs`` (the inputs' device copies), the program's own span
and ``train_step/read`` (the host waiting for the step's values). On a card
``step_fn`` records four timing events (``external``: in a captured step
they are event nodes of the graph, which every replay records again): the
step's start, after the losses, after the backward and the gradients' cast
to the masters, after the clip, AdamW and the cast back. After its read,
``train_step`` adds the milliseconds between them to the counters
``train_step.forward_ms``, ``backward_ms`` and ``optimizer_ms``.

Over a mesh (``mesh=``, ``core/dist.py``; the JAX trainer's FSDP over
(data, fsdp), the reference's ZeRO-3): the UNet and the projection go under
FSDP2's ``fully_shard`` (each resnet, transformer and resampler a unit,
then the root; the UNet's parameters contiguous, as FSDP2 needs) with
``MixedPrecisionPolicy(param_dtype=config.compute_dtype, reduce_dtype=f32)``.
Their sharded ``config.param_dtype`` parameters are the master copies (no
second set): the forward gathers them in the compute dtype, the gradients
are reduced in f32, clipped by the global norm and AdamW updates the shards.
Every process takes the global batch and draws the global batch's noise and
indices from the same generator, then keeps its rows (``local_rows``), so the
draws do not depend on the world size; the losses are each process's mean
over as many rows, and the mean of the gradients over the processes is the
global batch's. ``mesh=None``, or a mesh without a process group, is the
one-device path. Over a mesh the captured step holds FSDP2's collectives
(the all-gathers before each unit's forward and backward, the gradients'
reduce-scatters, their side streams forked from and joined back to the
capture stream), the losses' all-reduce (``_global_mean``) and the clip's
norm over the shards, as the JAX step's one ``jax.jit`` over the mesh holds
the all-gathers and reduce-scatters XLA schedules. FSDP2's lazy
initialisation and the first use of each NCCL communicator happen in the
eager first step; the unsharded parameters that FSDP2 frees after each
forward and gathers again in the backward are the graph's memory, from the
trainer's pool.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from ldiffusion_tpu_torch.core import tracing
from ldiffusion_tpu_torch.core.checkpoint import load_pytree, reshard_like, save_pytree
from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
from ldiffusion_tpu_torch.core.dist import MeshContext, is_main_process
from ldiffusion_tpu_torch.core.graphs import Jit, TrainProgram
from ldiffusion_tpu_torch.core.logging import CSVLogger, TextLogger
from ldiffusion_tpu_torch.diffusion.pipeline import (
    SDComponents,
    trajectory_features,
    trajectory_timesteps,
)
from ldiffusion_tpu_torch.diffusion.schedulers import laplace_noise
from ldiffusion_tpu_torch.losses.infonce import ContrastIndices, InfoNceLoss
from ldiffusion_tpu_torch.models.convert import (
    proj_from_flax,
    proj_to_flax,
    save_unet_dir,
    unet_from_flax,
    unet_to_flax,
)
from ldiffusion_tpu_torch.models.layers import cast_keeping_int8_weights


def _full(t: torch.Tensor) -> torch.Tensor:
    """A parameter or state tensor whole, on the host (a DTensor is gathered:
    every rank calls this in the same order)."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()  # a replicated DTensor's is its local tensor: copy it
    return t.detach().to("cpu", copy=True)


def _fsdp_units(unet) -> list:
    """The UNet's FSDP2 units: each resnet, transformer and resampler, the
    modules ``UNet2DCondition.forward`` calls (a unit's parameters are
    gathered by its own forward); the root keeps the rest."""
    return [m for blk in (*unet.down_blocks, unet.mid_block, *unet.up_blocks)
            for name in ("resnets", "attentions", "downsamplers", "upsamplers")
            for m in getattr(blk, name, ())]


class DiffusionWarmupTrainer:
    def __init__(self, components: SDComponents, config: DiffusionTrainConfig,
                 work_dir: str = "train_save", info_nce: Optional[InfoNceLoss] = None,
                 mesh: Optional[MeshContext] = None):
        self.c = components
        self.cfg = config
        self.work_dir = work_dir
        self.mesh = mesh if mesh is not None and mesh.distributed else None
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
        param_dtype = getattr(torch, config.param_dtype)
        compute = getattr(torch, config.compute_dtype)
        # frozen: cast down, the VAE keeping its int8 codes (inference reads them)
        cast_keeping_int8_weights(components.vae, dtype=compute)
        components.text.to(dtype=compute)
        for m in (components.vae, components.text):
            m.requires_grad_(False)
        if self.mesh is None:
            self.params = [p for m in self.trainable.values() for p in m.parameters()]
            self.master = [p.detach().to(param_dtype, copy=True) for p in self.params]
            for m in self.trainable.values():
                m.to(dtype=compute)
        else:
            # FSDP2 shards contiguous parameters only; the activations stay channels_last
            unet = components.unet.to(dtype=param_dtype, memory_format=torch.contiguous_format)
            self.mesh.shard_module(unet, _fsdp_units(unet), param_dtype=compute)
            self.mesh.shard_module(components.proj.to(dtype=param_dtype), param_dtype=compute)
            self.params = [p for m in self.trainable.values() for p in m.parameters()]
            self.master = self.params  # the sharded parameters are the master copies
        for p in self.params:
            p.requires_grad_(True)
        on_card = self.device.type == "cuda"
        self.opt = torch.optim.AdamW(self.master, lr=config.learning_rate,
                                     betas=tuple(config.betas), eps=config.eps,
                                     weight_decay=config.weight_decay, capturable=on_card)
        # one program per batch shape (module docstring)
        self.program = Jit(self.step_fn, self.device,
                           torch.cuda.graph_pool_handle() if on_card else None,
                           generators=[self.generator], program_type=TrainProgram,
                           name="stage1_step")
        # the step's phase marks (module docstring)
        self.phase_events = [torch.cuda.Event(enable_timing=True, external=True)
                             for _ in range(4)] if on_card else None
        self.steps_done = 0
        self.history = []  # train_step's metrics, with its wall-clock "seconds"

    # -- randomness -----------------------------------------------------------
    def draw(self, images, labels):
        """(noise (T, B, H/f, W/f, 4), contrastive indices) for one step of
        the global batch of ``labels`` (``images`` may be this process's
        rows)."""
        b, (h, w) = labels.shape[0], images.shape[1:3]
        f = self.c.latent_factor
        n_t = len(trajectory_timesteps(self.c, self.trajectory_steps)[0])
        noise = laplace_noise((n_t, b, h // f, w // f, self.c.vae_config.latent_channels),
                              self.generator, device=self.device)
        return noise, self.info_nce.sample(labels, self.generator)

    def local(self, images, labels, noise, indices: ContrastIndices):
        """This process's rows of a global batch and of its draws (all of
        them on one device); ``images`` may hold those rows already
        (``iter_batches(rows=...)``)."""
        if self.mesh is None:
            return images, labels, noise, indices
        rows = self.mesh.local_rows
        if images.shape[0] == labels.shape[0]:
            images = rows(images)
        return (images, rows(labels), rows(noise.transpose(0, 1)).transpose(0, 1),
                ContrastIndices(*(rows(t) for t in indices)))

    def _global_mean(self, values):
        """Each process's means → the global batch's (every process holds as
        many rows)."""
        if self.mesh is None:
            return values
        v = torch.stack([x.detach().float() for x in values])
        dist.all_reduce(v, group=self.mesh.batch_group)
        return list(v / self.mesh.batch_shards)

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
        """Forward + backward of the global batch (each process its rows);
        leaves the (unclipped) gradients on the master copies, reduced over
        the processes. Returns the global (loss, {"content", "contrast"}),
        detached."""
        for p in self.params:
            p.grad = None
        loss, aux = self._loss_fn(*self.local(images, labels, noise, indices))
        self._mark(1)
        loss.backward()
        if self.mesh is None:
            for p, m in zip(self.params, self.master):
                m.grad = torch.zeros_like(m) if p.grad is None else p.grad.to(m.dtype)
                p.grad = None
        else:  # optax updates every parameter: an unused one decays with a zero gradient
            for p in self.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        loss, content, contrast = self._global_mean([loss, aux["content"], aux["contrast"]])
        return loss.detach(), {"content": content, "contrast": contrast}

    def _update(self):
        """Clip, AdamW on the master copies, cast them into the modules.
        Returns the gradient norm before clipping."""
        norm = torch.nn.utils.clip_grad_norm_(self.master, self.cfg.grad_clip)
        if hasattr(norm, "full_tensor"):
            norm = norm.full_tensor()
        self.opt.step()
        if self.mesh is None:
            with torch.no_grad():
                for p, m in zip(self.params, self.master):
                    p.copy_(m)
        return norm

    def apply_update(self):
        """``_update`` as a step of its own (counted in ``steps_done``).
        Returns the gradient norm before clipping."""
        norm = self._update()
        self.steps_done += 1
        return norm

    def _mark(self, i: int):
        """Records the step's phase event ``i`` on a card (module docstring)."""
        if self.phase_events is not None:
            self.phase_events[i].record()

    def step_fn(self, images, labels):
        """One whole step on device tensors, what the program captures:
        ``draw``, ``loss_and_grads``, ``_update``, between the phase marks.
        images (B, H, W, 3) float32, labels (B, 64, 64) int64. Returns (loss,
        content, contrast, gradient norm) of the global batch, 0-d device
        tensors."""
        self._mark(0)
        noise, indices = self.draw(images, labels)
        loss, aux = self.loss_and_grads(images, labels, noise, indices)
        self._mark(2)
        norm = self._update()
        self._mark(3)
        return loss, aux["content"], aux["contrast"], norm

    def train_step(self, images, labels) -> dict:
        """images (B, H, W, 3) ImageNet-normalised (or this process's rows of
        them), labels (B, 64, 64) class ids of the global batch; numpy or
        tensors. Through the batch shape's program (module docstring).
        Returns float metrics of the global batch."""
        with tracing.span("train_step"):
            t0 = time.perf_counter()
            with tracing.span("train_step/inputs"):
                images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
                labels = torch.as_tensor(labels, device=self.device).long()
            out = self.program(images, labels)
            with tracing.span("train_step/read"):
                values = torch.stack([v.detach().float() for v in out]).tolist()
            if self.phase_events is not None and tracing.enabled():
                e = self.phase_events
                for i, phase in enumerate(("forward", "backward", "optimizer")):
                    tracing.count(f"train_step.{phase}_ms", e[i].elapsed_time(e[i + 1]))
        self.steps_done += 1
        metrics = dict(zip(("loss", "content", "contrast", "grad_norm"), values))
        metrics["seconds"] = time.perf_counter() - t0  # the read waits for the device
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

    def state_dicts(self, of=None):
        """{"unet": ..., "proj": ...} of the master copies (``of``: a
        function of each, e.g. its AdamW moment); under a mesh each is
        gathered whole on every process."""
        out = {key: {} for key in self.trainable}
        for (key, name), m in zip(self.names, self.master):
            t = m if of is None else of(m)
            out[key][name] = t if self.mesh is None else _full(t)
        return out

    def save(self, save_dir: str):
        """The master copies in the JAX trainer's UNet directory layout,
        gathered on every process and written by rank 0."""
        sds = self.state_dicts()
        if is_main_process():
            save_unet_dir(save_dir, self.c.unet_config, sds["unet"], sds["proj"])
        self.log(f"saved checkpoint to {save_dir}")

    def _flax(self, sds) -> dict:
        return {"unet": unet_to_flax(sds["unet"], self.c.unet_config),
                "proj": proj_to_flax(sds["proj"])}

    def save_state(self, path: str):
        """The master copies and the AdamW state, gathered on every process,
        written by rank 0 in the flax layout (``core/checkpoint.py``:
        ``{"params", "opt_state": {"count", "mu", "nu"}, "step"}``, read by
        either package's ``load_pytree``)."""
        zeros = {id(m): torch.zeros_like(m) for m in self.master if m not in self.opt.state}
        moment = lambda key: lambda m: self.opt.state[m][key] if m in self.opt.state \
            else zeros[id(m)]
        save_pytree(path, {
            "params": self._flax(self.state_dicts()),
            "opt_state": {"count": self.steps_done,
                          "mu": self._flax(self.state_dicts(moment("exp_avg"))),
                          "nu": self._flax(self.state_dicts(moment("exp_avg_sq")))},
            "step": self.steps_done})

    def load_state(self, path: str):
        """Resume from ``save_state``'s file: every tensor re-sharded onto
        this trainer's layout (a DTensor keeps this process's shard), and
        written in place where the trainer holds it already (a captured step
        reads those tensors; the AdamW count on the device when the
        optimizer is ``capturable``)."""
        ck = load_pytree(path)

        def port(tree):
            return {"unet": unet_from_flax(tree["unet"], self.c.unet_config),
                    "proj": proj_from_flax(tree["proj"])}

        params, mu, nu = (port(t) for t in (ck["params"], ck["opt_state"]["mu"],
                                            ck["opt_state"]["nu"]))
        step = int(ck["step"])
        capturable = self.opt.param_groups[0]["capturable"]
        with torch.no_grad():
            for (key, name), m in zip(self.names, self.master):
                m.copy_(reshard_like(m, params[key][name]))
                loaded = {"step": torch.tensor(float(step), device=m.device if capturable
                                               else "cpu"),
                          "exp_avg": reshard_like(m, mu[key][name]),
                          "exp_avg_sq": reshard_like(m, nu[key][name])}
                st = self.opt.state[m]
                for k, v in loaded.items():
                    if k in st:
                        st[k].copy_(v)
                    else:
                        st[k] = v
            if self.mesh is None:
                for p, m in zip(self.params, self.master):
                    p.copy_(m)
        self.steps_done = step
