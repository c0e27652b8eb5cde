"""Sliding-window prediction with gaussian blending and mirror TTA
(counterpart of ``ldiffusion_tpu/segmentor/predictor.py``, 2D, without a
label manager).

Pad to at least the patch, tile with step 0.5 x patch (evenly spread starts),
weight each tile's logits by a centred gaussian (sigma = patch/8, floored at
its least nonzero value), average the logits over all 4 flip combinations,
average the folds' logits, argmax to a uint8 mask. The four mirrored copies
of a tile run as one batch of 4 (InstanceNorm is per sample, so this equals
four separate passes); the tile loop is a Python loop over device tensors.
"""
from __future__ import annotations

import glob
import itertools
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ldiffusion_tpu_torch.core.checkpoint import load_pytree
from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
from ldiffusion_tpu_torch.models.dynunet import DynUNet
from ldiffusion_tpu_torch.segmentor.planner import SegPlan


def compute_steps(image_size: int, patch_size: int, step_frac: float = 0.5) -> List[int]:
    """Evenly distributed tile starts."""
    if image_size <= patch_size:
        return [0]
    num_steps = int(np.ceil((image_size - patch_size) / (patch_size * step_frac))) + 1
    actual = (image_size - patch_size) / (num_steps - 1)
    return [int(round(i * actual)) for i in range(num_steps)]


def gaussian_importance_map(patch: Tuple[int, int], sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Centred gaussian weight map, floored at its least nonzero value.

    The same values as scipy's 2D ``gaussian_filter`` of a centred float32
    delta, as the JAX package computes it, but as the outer product of the
    filter's two 1D passes: the 2D filter spends over a second of host time
    at a 1024² patch. Pass 1 (axis 0) stores float32; pass 2 (axis 1) has one
    nonzero input per output, so it is that float32 value times a float64
    weight, stored as float32."""
    from scipy.ndimage import gaussian_filter1d

    ph, pw = patch
    rows = np.zeros(ph, np.float32)
    rows[ph // 2] = 1.0
    cols = np.zeros(pw, np.float64)
    cols[pw // 2] = 1.0
    g_h = gaussian_filter1d(rows, ph * sigma_scale, mode="constant")
    g_w = gaussian_filter1d(cols, pw * sigma_scale, mode="constant")
    g = (g_h.astype(np.float64)[:, None] * g_w[None, :]).astype(np.float32)
    g = g / g.max()
    g[g == 0] = g[g > 0].min()
    return g


def find_fold_checkpoints(config_dir: str) -> List[str]:
    """Best (falling back to final) checkpoint of each ``fold_*`` directory;
    a flat layout (no fold directories) is searched directly."""
    dirs = sorted(d for d in glob.glob(os.path.join(config_dir, "fold_*"))
                  if os.path.isdir(d)) or [config_dir]
    ckpts = []
    for d in dirs:
        for name in ("checkpoint_best.pkl", "checkpoint_final.pkl"):
            p = os.path.join(d, name)
            if os.path.exists(p):
                ckpts.append(p)
                break
    if not ckpts:
        raise FileNotFoundError(f"no checkpoint_best/final.pkl under {config_dir}")
    return ckpts


def _zscore(image):
    """Per-channel z-score over the spatial axes of (H, W, C), std floored at 1e-8."""
    mean = image.mean(dim=(0, 1), keepdim=True)
    std = image.std(dim=(0, 1), keepdim=True, correction=0)
    return (image - mean) / torch.clamp(std, min=1e-8)


class SlidingWindowPredictor:
    def __init__(self, plan: SegPlan, state_dicts, dtype=torch.bfloat16, device=None):
        """``state_dicts``: one DynUNet state dict per fold (logits averaged)."""
        if len(plan.patch_size) != 2:
            raise NotImplementedError("the 3D pathway is not ported yet "
                                      "(ROADMAP queue 1, *Long tail*)")
        self.plan = plan
        self.device = resolve_device(device)
        if isinstance(state_dicts, dict):
            state_dicts = [state_dicts]
        self.nets = []
        for sd in state_dicts:
            with torch.device("meta"):  # no initialisation: the weights come next
                net = DynUNet(plan.network_config())
            net.to_empty(device=self.device).load_state_dict(sd)
            self.nets.append(net.to(dtype=dtype, memory_format=torch.channels_last).eval())
        self.gauss = torch.from_numpy(gaussian_importance_map(tuple(plan.patch_size))).to(
            self.device)

    @classmethod
    def from_checkpoints(cls, plan: SegPlan, paths: Sequence[str], **kw):
        """Fold ensembling over the JAX trainer's checkpoints."""
        cfg = plan.network_config()
        sds = []
        for p in paths:
            ck = load_pytree(p)
            if ck.get("batch_stats"):
                raise NotImplementedError(f"{p}: BatchNorm DynUNet checkpoints are not "
                                          "ported yet (ROADMAP queue 1, *Long tail*)")
            sds.append(dynunet_from_flax(ck["params"], cfg))
        return cls(plan, sds, **kw)

    def _tile_logits(self, net, tile):
        """(1, C, ph, pw) → (classes, ph, pw) float32, mirror-averaged."""
        flips = ([], [2], [3], [2, 3])  # none, H, W, both
        batch = torch.cat([tile.flip(f) if f else tile for f in flips])
        out = net(batch)
        logits = out[0]
        for i, f in enumerate(flips[1:], start=1):
            logits = logits + out[i].flip([a - 1 for a in f])
        return logits / float(len(flips))

    def _blended(self, net, image, positions):
        """(C, H, W) padded image → (classes, H, W) gaussian-blended logits."""
        ph, pw = self.plan.patch_size
        _, h, w = image.shape
        acc = torch.zeros((self.plan.num_classes, h, w), device=self.device)
        wacc = torch.zeros((1, h, w), device=self.device)
        for y, x in positions:
            tile = image[None, :, y:y + ph, x:x + pw]
            acc[:, y:y + ph, x:x + pw] += self._tile_logits(net, tile) * self.gauss
            wacc[:, y:y + ph, x:x + pw] += self.gauss
        return acc / wacc

    def logits(self, image, normalize: bool = True):
        """(H, W, C) float tensor on the predictor's device → fold-averaged
        blended logits (classes, H, W)."""
        image = image.to(self.device, torch.float32)
        if normalize:
            image = _zscore(image)
        h, w = image.shape[:2]
        ph, pw = self.plan.patch_size
        chw = image.permute(2, 0, 1)
        pad_h, pad_w = max(0, ph - h), max(0, pw - w)
        if pad_h or pad_w:
            chw = torch.nn.functional.pad(chw, (0, pad_w, 0, pad_h))
        ys, xs = compute_steps(chw.shape[1], ph), compute_steps(chw.shape[2], pw)
        positions = list(itertools.product(ys, xs))
        out = self._blended(self.nets[0], chw, positions)
        for net in self.nets[1:]:
            out = out + self._blended(net, chw, positions)
        return (out / len(self.nets))[:, :h, :w]

    def seg(self, image, normalize: bool = True):
        """(H, W, C) tensor → (H, W) uint8 segmentation, on the device (the
        ``traced_seg`` counterpart: only the mask needs to reach the host)."""
        with torch.inference_mode():
            return self.logits(image, normalize).argmax(dim=0).to(torch.uint8)

    def predict_logits(self, image: np.ndarray, normalize: bool = True) -> np.ndarray:
        """(H, W, C) numpy → (H, W, classes) float32 numpy."""
        with torch.inference_mode():
            out = self.logits(torch.from_numpy(np.asarray(image, np.float32)), normalize)
            return out.permute(1, 2, 0).cpu().numpy()

    def predict(self, image: np.ndarray, normalize: bool = True) -> np.ndarray:
        """(H, W, C) numpy → (H, W) uint8 segmentation."""
        return self.seg(torch.from_numpy(np.asarray(image, np.float32)), normalize).cpu().numpy()
