"""Sliding-window prediction with gaussian blending and mirror TTA, 2D and
3D by the plan's rank (counterpart of
``ldiffusion_tpu/segmentor/predictor.py:30-66, 107-343``).

Pad to at least the patch, tile with step ``tile_step_size`` x patch (evenly
spread starts on each axis), weight each tile's logits by a centred gaussian
(sigma = patch/8, floored at its least nonzero value), average the logits
over every flip combination of the allowed mirror axes (4 in 2D, 8 in 3D by
default; the trainer variant's ``inference_mirror_config`` restricts them),
average the folds' logits. ``network_forwards`` counts the network's inputs
(tiles × flips × folds). The mask: plain argmax, or with a label manager its regime's
conversion (regions paint in ``regions_class_order`` where the logit > 0;
plain labels map the argmax through the label values), on the device with
``torch.where`` and a label table made once. The mirrored copies of a tile
run as one batch (InstanceNorm is per sample and a BatchNorm net evaluates
with its running statistics, so this equals separate passes).

``predict``, ``predict_logits`` and ``seg`` go through ``_run``, the
counterpart of the JAX predictor's ``_run`` / ``_build_predict``
(``:280-318``): z-score and pad, then one program per (padded shape, tile
count, mode, crop) bucket in ``_predict_cache`` tiles, ensembles the folds
and, for a mask, crops and label-maps. On a card a bucket's program runs
eagerly at its first use and is a captured CUDA graph from its second
(``core/graphs.py``; the predictor's programs share one memory pool); on the
CPU it always runs eagerly. ``traced_seg`` is the same path without a
program of its own, for a program that holds more (``api.py``'s fused
tissue inference).

BatchNorm checkpoints (nnUNetTrainerBN, a non-empty ``batch_stats``) build a
BatchNorm DynUNet that evaluates with their running statistics. The JAX
predictor builds its net from the plan alone, so it evaluates such a
checkpoint with InstanceNorm over the BatchNorm affine parameters (ROADMAP
queue 3); the port does not follow it there.
"""
from __future__ import annotations

import dataclasses
import functools
import glob
import itertools
import os
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ldiffusion_tpu_torch.core import tracing
from ldiffusion_tpu_torch.core.checkpoint import load_pytree
from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.core.graphs import Program, weak_method
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
from ldiffusion_tpu_torch.models.dynunet import DynUNet
from ldiffusion_tpu_torch.models.dynunet3d import DynUNet3D
from ldiffusion_tpu_torch.segmentor.planner import SegPlan


def compute_steps(image_size: int, patch_size: int, step_frac: float = 0.5) -> List[int]:
    """Evenly distributed tile starts."""
    if image_size <= patch_size:
        return [0]
    num_steps = int(np.ceil((image_size - patch_size) / (patch_size * step_frac))) + 1
    actual = (image_size - patch_size) / (num_steps - 1)
    return [int(round(i * actual)) for i in range(num_steps)]


def gaussian_importance_map(patch: Tuple[int, ...], sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Centred gaussian weight map, floored at its least nonzero value.

    The same values as scipy's N-D ``gaussian_filter`` of a centred float32
    delta, as the JAX package computes it, but as the outer product of the
    filter's 1D passes: the N-D filter spends over a second of host time at
    a 1024² patch. Pass 1 (axis 0) stores float32; every later pass has one
    nonzero input per output, so it is that float32 value times a float64
    weight, stored as float32."""
    from scipy.ndimage import gaussian_filter1d

    first = np.zeros(patch[0], np.float32)
    first[patch[0] // 2] = 1.0
    g = gaussian_filter1d(first, patch[0] * sigma_scale, mode="constant")
    for p in patch[1:]:
        delta = np.zeros(p, np.float64)
        delta[p // 2] = 1.0
        w = gaussian_filter1d(delta, p * sigma_scale, mode="constant")
        g = (g.astype(np.float64)[..., None] * w).astype(np.float32)
    g = g / g.max()
    g[g == 0] = g[g > 0].min()
    return g


def find_fold_checkpoints(config_dir: str, folds=None,
                          checkpoint_name: Optional[str] = None) -> List[str]:
    """Best (falling back to final) checkpoint of each ``fold_*`` directory,
    or of the ``folds`` given (a missing one is skipped with a warning); a
    flat layout (no fold directories) is searched directly.
    ``checkpoint_name`` (``-chk``) takes that one file name. Raises when
    nothing is found."""
    if folds is None:
        dirs = sorted(d for d in glob.glob(os.path.join(config_dir, "fold_*"))
                      if os.path.isdir(d)) or [config_dir]
    else:
        dirs = [os.path.join(config_dir, f"fold_{f}") for f in folds]
    names = (checkpoint_name,) if checkpoint_name else \
        ("checkpoint_best.pkl", "checkpoint_final.pkl")
    ckpts = []
    for d in dirs:
        for name in names:
            p = os.path.join(d, name)
            if os.path.exists(p):
                ckpts.append(p)
                break
        else:
            if folds is not None:
                print(f"WARNING: no checkpoint in {d} — fold skipped "
                      "(ensembling over the trained folds only)")
    if not ckpts:
        raise FileNotFoundError(f"no {checkpoint_name or 'checkpoint_best/final.pkl'} under "
                                f"{config_dir} (folds={folds if folds is not None else 'all'})")
    return ckpts


def _zscore(image):
    """Per-channel z-score over the spatial axes of (*spatial, C), std floored at 1e-8."""
    axes = tuple(range(image.dim() - 1))
    mean = image.mean(dim=axes, keepdim=True)
    std = image.std(dim=axes, keepdim=True, correction=0)
    return (image - mean) / torch.clamp(std, min=1e-8)


class SlidingWindowPredictor:
    def __init__(self, plan: SegPlan, state_dicts, dtype=torch.bfloat16, device=None,
                 label_manager=None, use_mirroring: bool = True, mirror_axes=None,
                 tile_step_size: float = 0.5):
        """``plan``: a ``SegPlan`` (2D) or a ``SegPlan3D``; ``state_dicts``:
        one DynUNet (DynUNet3D) state dict per fold (logits averaged); a 2D
        one holding running statistics is a BatchNorm net. ``mirror_axes``:
        the spatial axes TTA may flip (None: all)."""
        if not 0 < tile_step_size <= 1:
            raise ValueError(f"tile_step_size={tile_step_size}: use (0, 1]")
        self.plan = plan
        self.device = resolve_device(device)
        self.label_manager = label_manager
        self.tile_step_size = float(tile_step_size)
        nd = len(plan.patch_size)
        allowed = range(nd) if mirror_axes is None else mirror_axes
        axes = tuple(sorted(a + 2 for a in allowed if 0 <= a < nd))  # N, C, *spatial
        self.flips = [()]
        if use_mirroring:
            self.flips += [c for r in range(1, len(axes) + 1)
                           for c in itertools.combinations(axes, r)]
        if isinstance(state_dicts, dict):
            state_dicts = [state_dicts]
        self.nets = []
        layout = torch.channels_last_3d if nd == 3 else torch.channels_last
        for sd in state_dicts:
            cfg = plan.network_config()
            if any(k.endswith("running_mean") for k in sd):
                cfg = dataclasses.replace(cfg, norm="batch")
            with torch.device("meta"):  # no initialisation: the weights come next
                net = DynUNet3D(cfg) if nd == 3 else DynUNet(cfg)
            net.to_empty(device=self.device).load_state_dict(sd)
            self.nets.append(net.to(dtype=dtype, memory_format=layout).eval())
        self.gauss = torch.from_numpy(gaussian_importance_map(tuple(plan.patch_size))).to(
            self.device)
        self.network_forwards = 0
        # the label regime's uint8 codes, on the device once
        lm = label_manager
        codes = None if lm is None else \
            lm.regions_class_order if lm.has_regions else sorted(lm.all_labels)
        self._codes = None if codes is None else \
            torch.tensor(codes, dtype=torch.uint8, device=self.device)
        self._predict_cache = {}  # bucket key → Program
        self._pool = None

    @classmethod
    def from_checkpoints(cls, plan: SegPlan, paths: Sequence[str], **kw):
        """Fold ensembling over the trainers' checkpoints (either package's);
        a non-empty ``batch_stats`` makes the fold a BatchNorm net. Spans
        (``core/tracing.py``): ``predictor/read_checkpoint`` each file (the
        counter ``predictor.checkpoint_bytes`` its size),
        ``predictor/convert`` each fold's conversion, ``predictor/nets``
        the nets built, loaded and cast on the device."""
        sds = []
        for p in paths:
            with tracing.span("predictor/read_checkpoint"):
                ck = load_pytree(p)
            tracing.count("predictor.checkpoint_bytes", os.path.getsize(p))
            with tracing.span("predictor/convert"):
                cfg = plan.network_config()
                if ck.get("batch_stats"):
                    cfg = dataclasses.replace(cfg, norm="batch")
                sds.append(dynunet_from_flax(ck["params"], cfg, ck.get("batch_stats")))
        with tracing.span("predictor/nets"):
            return cls(plan, sds, **kw)

    def graph_pool(self):
        """The memory pool of this predictor's captured programs (and of
        programs that hold its path), made at first use on a card."""
        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _tile_logits(self, net, tile):
        """(1, C, *patch) → (classes, *patch) float32, averaged over the flips."""
        batch = torch.cat([tile.flip(f) if f else tile for f in self.flips])
        out = net(batch)
        self.network_forwards += len(self.flips)
        logits = out[0]
        for i, f in enumerate(self.flips[1:], start=1):
            logits = logits + out[i].flip([a - 1 for a in f])
        return logits / float(len(self.flips))

    def _blended(self, net, image, positions):
        """(C, *spatial) padded image → (classes, *spatial) gaussian-blended logits."""
        patch = self.plan.patch_size
        acc = torch.zeros((self.plan.num_classes, *image.shape[1:]), device=self.device)
        wacc = torch.zeros((1, *image.shape[1:]), device=self.device)
        for start in positions:
            win = (slice(None),) + tuple(slice(s, s + p) for s, p in zip(start, patch))
            acc[win] += self._tile_logits(net, image[win][None]) * self.gauss
            wacc[win] += self.gauss
        return acc / wacc

    def _padded(self, image, normalize: bool):
        """(*spatial, C) float tensor → (float32 on the device, z-scored
        when ``normalize``, zero-padded up to the patch; its spatial shape)."""
        image = image.to(self.device, torch.float32)
        if normalize:
            image = _zscore(image)
        shape = tuple(image.shape[:-1])
        pads = [max(0, p - s) for p, s in zip(self.plan.patch_size, shape)]
        if any(pads):
            image = torch.nn.functional.pad(image, [0, 0] + [v for p in reversed(pads)
                                                             for v in (0, p)])
        return image, shape

    def _positions(self, padded) -> list:
        steps = [compute_steps(n, p, self.tile_step_size)
                 for n, p in zip(padded, self.plan.patch_size)]
        return list(itertools.product(*steps))

    def _ensembled(self, image, positions):
        """Padded (*spatial, C) → fold-averaged blended logits (classes, *spatial)."""
        chw = image.movedim(-1, 0)
        out = self._blended(self.nets[0], chw, positions)
        for net in self.nets[1:]:
            out = out + self._blended(net, chw, positions)
        return out / len(self.nets)

    def _to_seg(self, logits):
        """(classes, *spatial) → (*spatial) uint8 by the label regime, on the device."""
        if self.label_manager is None:
            return logits.argmax(dim=0).to(torch.uint8)
        if self.label_manager.has_regions:  # sigmoid(x) > 0.5 ⇔ x > 0
            seg = torch.zeros(logits.shape[1:], dtype=torch.uint8, device=logits.device)
            for i in range(len(self._codes)):
                seg = torch.where(logits[i] > 0, self._codes[i], seg)
            return seg
        return self._codes[logits.argmax(dim=0)]

    def _bucket(self, positions, mode: str, crop, image):
        """The program of one bucket: padded (*spatial, C) → logits
        (classes, *padded), or the uint8 mask cropped to ``crop``."""
        out = self._ensembled(image, positions)
        if mode == "seg":
            return self._to_seg(out[(slice(None),) + tuple(slice(0, s) for s in crop)])
        return out

    def _run(self, image, normalize: bool, mode: str):
        """Shared pad/tile/dispatch through the bucket's program (module
        docstring). Returns device tensors: logits (classes, *spatial) or
        the (*spatial) uint8 mask, valid until the next program call."""
        with torch.inference_mode():
            image, shape = self._padded(image, normalize)
            padded = tuple(image.shape[:-1])
            positions = self._positions(padded)
            key = (padded, len(positions), mode, shape if mode == "seg" else ())
            program = self._predict_cache.get(key)
            if program is None:
                program = self._predict_cache[key] = Program(
                    functools.partial(weak_method(self._bucket), positions, mode, shape),
                    self.device, self.graph_pool(),
                    counted=[(weakref.proxy(self), "network_forwards")], name="predict_bucket")
            out = program(image)
            if mode == "seg":
                return out
            return out[(slice(None),) + tuple(slice(0, s) for s in shape)]

    def traced_seg(self, image, normalize: bool = True):
        """(*spatial, C) tensor → (*spatial) uint8 mask: z-score, pad, window,
        label map, with no program of its own (the JAX ``traced_seg``), for a
        program that holds more."""
        image, shape = self._padded(image, normalize)
        logits = self._ensembled(image, self._positions(image.shape[:-1]))
        return self._to_seg(logits[(slice(None),) + tuple(slice(0, s) for s in shape)])

    def seg(self, image, normalize: bool = True):
        """(*spatial, C) tensor → (*spatial) uint8 segmentation on the device,
        through the bucket's program (a copy of its output)."""
        return self._run(image, normalize, "seg").clone()

    def predict_logits(self, image: np.ndarray, normalize: bool = True) -> np.ndarray:
        """(*spatial, C) numpy → (*spatial, classes) float32 numpy."""
        out = self._run(torch.from_numpy(np.asarray(image, np.float32)), normalize, "logits")
        return out.movedim(0, -1).cpu().numpy()

    def predict(self, image: np.ndarray, normalize: bool = True) -> np.ndarray:
        """(*spatial, C) numpy → (*spatial) uint8 segmentation."""
        return self._run(torch.from_numpy(np.asarray(image, np.float32)), normalize,
                         "seg").cpu().numpy()

    def predict_probabilities(self, image: np.ndarray, normalize: bool = True) -> np.ndarray:
        """(*spatial, classes) probabilities under the regime's nonlinearity
        (sigmoid for regions, else softmax), on the host as the JAX package
        computes them: the ``--save_probabilities`` payload."""
        from ldiffusion_tpu_torch.segmentor.export import inference_nonlin

        return inference_nonlin(self.predict_logits(image, normalize), self.label_manager)
