"""Cell instance proposers (counterpart of ``ldiffusion_tpu/cell/instance.py``;
the reference runs Cellpose ``cyto2``, ``model/conductor.py:156-180``).

* ``DistanceWatershedProposer``: threshold → distance transform → local-maxima
  markers → nearest-marker assignment inside the mask. Host numpy/scipy, a
  copy of the JAX package's.
* ``FlowNetProposer``: a cellpose-style DynUNet predicts (flow_y, flow_x,
  cell probability); ``follow_flows`` moves every pixel along the flow field
  on the device, the rounded endpoints come back as one int32 flat sink index
  and a foreground mask, and the host labels the pixels by the connected
  component of their sink. ``FlowNetTrainer`` trains it from instance masks
  (``masks_to_flows`` targets).

The device work runs as ``core/graphs.py`` programs, the JAX package's
jitted functions: the proposer's net forward (one program per image shape,
the JAX ``_net_fn``), ``follow_flows`` (per (H, W, ``n_iter``, ``method``,
``prob_threshold``)) and ``_device_propose`` (per (H, W, ``n_iter``,
``prob_threshold``)) share the proposer's memory pool; the trainer's step is
a ``TrainProgram`` per batch shape (AdamW ``capturable`` on a card). Each
runs eagerly at its first use, is captured as a CUDA graph at its second and
replays after; on the CPU each call runs the function. The settings are
part of the keys, so a setting changed between two calls takes effect at
the next call.
"""
from __future__ import annotations

import dataclasses
import math
import os
from pathlib import Path
from typing import Optional, Protocol, Tuple

import numpy as np
import torch
from scipy import ndimage

from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.core.graphs import Jit, TrainProgram
from ldiffusion_tpu_torch.models.convert import (
    dynunet_from_flax,
    dynunet_to_flax,
    flatten_tree,
    unflatten_tree,
)
from ldiffusion_tpu_torch.models.dynunet import DynUNet, DynUNetConfig
from ldiffusion_tpu_torch.models.layers import init_random_

# the committed flow-net weights, the port's own copy (byte-equal to the JAX
# package's ``ldiffusion_tpu/artifacts/``)
ARTIFACTS = Path(__file__).resolve().parents[1] / "artifacts"


class InstanceProposer(Protocol):
    def propose(self, image: np.ndarray) -> np.ndarray:
        """image: (H, W, 3) float in [0, 1] → (H, W) int32 instance ids
        (0 = background)."""
        ...


# ---------------------------------------------------------------------------
# classical proposer (host)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DistanceWatershedProposer:
    """Threshold + distance-transform watershed approximation: a Voronoi
    partition of the foreground seeded at distance-transform maxima."""

    threshold: Optional[float] = None   # None: Otsu
    min_distance: int = 5               # marker suppression radius
    min_size: int = 15                  # drop smaller instances

    def propose(self, image: np.ndarray) -> np.ndarray:
        gray = image.mean(axis=-1) if image.ndim == 3 else image
        thr = self.threshold if self.threshold is not None else _otsu(gray)
        # nuclei are dark on H&E-like stains: take the minority phase
        fg = gray < thr
        if fg.mean() > 0.5:
            fg = ~fg
        fg = ndimage.binary_opening(fg, iterations=1)
        if not fg.any():
            return np.zeros(gray.shape, np.int32)
        dist = ndimage.distance_transform_edt(fg)
        footprint = np.ones((2 * self.min_distance + 1,) * 2)
        maxima = (dist == ndimage.maximum_filter(dist, footprint=footprint)) & (dist > 1)
        markers, n = ndimage.label(maxima)
        if n == 0:
            markers, n = ndimage.label(fg)
            return _filter_small(markers.astype(np.int32), self.min_size)
        seeds = np.zeros_like(markers)  # one seed per marker region, at its centroid
        for idx, (cy, cx) in enumerate(
                ndimage.center_of_mass(maxima, markers, range(1, n + 1)), start=1):
            seeds[int(round(cy)), int(round(cx))] = idx
        _, (iy, ix) = ndimage.distance_transform_edt(seeds == 0, return_indices=True)
        labels = seeds[iy, ix]
        labels[~fg] = 0
        return _filter_small(labels.astype(np.int32), self.min_size)


def _otsu(gray: np.ndarray) -> float:
    hist, edges = np.histogram(gray.reshape(-1), bins=128)
    centers = (edges[:-1] + edges[1:]) / 2
    total = hist.sum()
    w0 = np.cumsum(hist)
    w1 = total - w0
    m0 = np.cumsum(hist * centers) / np.maximum(w0, 1)
    m1 = (np.sum(hist * centers) - np.cumsum(hist * centers)) / np.maximum(w1, 1)
    between = w0 * w1 * (m0 - m1) ** 2
    return float(centers[int(np.argmax(between))])


def _filter_small(labels: np.ndarray, min_size: int) -> np.ndarray:
    """Zero instances under ``min_size`` pixels, then renumber densely."""
    ids, counts = np.unique(labels, return_counts=True)
    kill = ids[(counts < min_size) & (ids != 0)]
    if kill.size:
        labels[np.isin(labels, kill)] = 0
    ids = np.unique(labels)
    remap = np.zeros(labels.max() + 1, np.int32)
    remap[ids] = np.arange(len(ids))
    return remap[labels]


# ---------------------------------------------------------------------------
# flow-field proposer
# ---------------------------------------------------------------------------

def masks_to_flows(masks: np.ndarray) -> np.ndarray:
    """Instance masks → (H, W, 3) [flow_y, flow_x, cellprob] targets: unit
    vectors toward each instance's median centre."""
    h, w = masks.shape
    flows = np.zeros((h, w, 3), np.float32)
    for i in np.unique(masks):
        if i == 0:
            continue
        ys, xs = np.nonzero(masks == i)
        cy, cx = np.median(ys), np.median(xs)
        dy, dx = cy - ys, cx - xs
        norm = np.sqrt(dy ** 2 + dx ** 2) + 1e-6
        flows[ys, xs, 0] = dy / norm
        flows[ys, xs, 1] = dx / norm
        flows[ys, xs, 2] = 1.0
    return flows


def _bilinear(field, y, x):
    """Vector-valued bilinear sample of an (H, W, 2) field at (y, x): four
    pair gathers. The coordinates are in range (both callers clip), so only
    the +1 taps are clamped."""
    h, w = field.shape[:2]
    y0f, x0f = torch.floor(y), torch.floor(x)
    wy, wx = (y - y0f)[..., None], (x - x0f)[..., None]
    y0, x0 = y0f.long(), x0f.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    return (field[y0, x0] * (1 - wy) * (1 - wx) + field[y0, x1] * (1 - wy) * wx
            + field[y1, x0] * wy * (1 - wx) + field[y1, x1] * wy * wx)


def follow_flows(flows, cellprob, n_iter: int = 200, prob_threshold: float = 0.5,
                 method: str = "squaring"):
    """Move every pixel along the flow field; flows: (H, W, 2) [dy, dx] float32,
    cellprob: (H, W). Returns the final (y, x) positions (H, W, 2); pixels
    with cellprob ≤ ``prob_threshold`` keep their own.

    ``"squaring"`` (default): the field is static, so the k-step Euler map
    composed with itself is the 2k-step map up to the bilinear regridding:
    k0 Euler steps then d self-compositions, d = ceil(log2(n_iter / 8)),
    k0 = ceil(n_iter / 2^d), cover k0·2^d ≥ n_iter steps in O(log n_iter)
    gather passes. ``"euler"``: step by step, the oracle; taken whenever
    n_iter ≤ 8."""
    h, w = cellprob.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=flows.device),
                            torch.arange(w, dtype=torch.float32, device=flows.device),
                            indexing="ij")
    pos0 = torch.stack([yy, xx], dim=-1)

    def euler(pos):
        pos = pos + _bilinear(flows, pos[..., 0], pos[..., 1])
        return torch.stack([pos[..., 0].clamp(0, h - 1), pos[..., 1].clamp(0, w - 1)], dim=-1)

    pos = pos0
    if method == "euler" or n_iter <= 8:
        for _ in range(n_iter):
            pos = euler(pos)
    elif method == "squaring":
        d = max(1, math.ceil(math.log2(n_iter / 8)))
        k0 = -(-n_iter // (1 << d))
        for _ in range(k0):
            pos = euler(pos)
        for _ in range(d):  # φ∘φ: the map resampled at its own endpoints
            pos = _bilinear(pos, pos[..., 0], pos[..., 1])
    else:
        raise ValueError(f"method={method!r}: choose squaring or euler")
    return torch.where((cellprob > prob_threshold)[..., None], pos, pos0)


def cluster_endpoints(pos: np.ndarray, cellprob: np.ndarray, prob_threshold: float = 0.5,
                      min_size: int = 15) -> np.ndarray:
    """Round the converged positions to pixels and label the foreground pixels
    by the connected component of their sink."""
    h, w = cellprob.shape
    fg = cellprob > prob_threshold
    py = np.clip(np.round(pos[..., 0]).astype(np.int64), 0, h - 1)
    px = np.clip(np.round(pos[..., 1]).astype(np.int64), 0, w - 1)
    return cluster_endpoints_packed(py * w + px, fg, min_size)


def cluster_endpoints_packed(sink_flat: np.ndarray, fg: np.ndarray,
                             min_size: int = 15) -> np.ndarray:
    """``cluster_endpoints`` on rounded flat sink indices (row-major
    ``py * W + px``)."""
    h, w = fg.shape
    sink_flat = np.asarray(sink_flat, np.int64)
    sinks = np.zeros(h * w, bool)
    sinks[sink_flat[fg]] = True
    sinks = ndimage.binary_dilation(sinks.reshape(h, w), iterations=1)
    sink_labels, _ = ndimage.label(sinks)
    labels = np.zeros((h, w), np.int32)
    labels[fg] = sink_labels.ravel()[sink_flat[fg]]
    return _filter_small(labels, min_size)


def flownet_config(features: Tuple[int, ...]) -> DynUNetConfig:
    return DynUNetConfig(in_channels=3, num_classes=3, features_per_stage=tuple(features),
                         strides=(1,) + (2,) * (len(features) - 1), deep_supervision=False)


@dataclasses.dataclass
class FlowNetProposer:
    """DynUNet → flows (the net regresses 5× flows) and sigmoid cell
    probability → ``follow_flows`` → clustering. ``n_iter`` and
    ``prob_threshold`` are read at every call, so changing them takes effect
    at the next ``propose``. The device side runs through the proposer's
    programs (module docstring): a device tensor it returns holds until the
    next call of one of them."""

    net: DynUNet
    n_iter: int = 200
    prob_threshold: float = 0.5
    min_size: int = 15

    def __post_init__(self):
        dev = self.device
        pool = torch.cuda.graph_pool_handle() if dev.type == "cuda" else None
        self.programs = {name: Jit(fn, dev, pool, name=f"flownet_{name}")
                         for name, fn in (("net", self._net_out), ("follow_flows", self._follow),
                                          ("propose", self._propose_out))}

    @classmethod
    def create(cls, features=(32, 64, 128, 256), device=None, **kw) -> "FlowNetProposer":
        """Random weights drawn from seed 0, on ``device`` (None → the GPU,
        raises when there is none)."""
        net = init_random_(DynUNet(flownet_config(features)), torch.Generator().manual_seed(0))
        return cls(net=net.to(resolve_device(device)).eval(), **kw)

    @property
    def device(self) -> torch.device:
        return self.net.seg_0.weight.device

    def save(self, path: str) -> None:
        """The JAX package's npz: the flax tree flattened with "/" and the
        feature schedule under ``__features__``."""
        cfg = self.net.config
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, __features__=np.asarray(cfg.features_per_stage),
                            **flatten_tree(dynunet_to_flax(self.net.state_dict(), cfg)))

    @classmethod
    def load(cls, path: str, device=None, **kw) -> "FlowNetProposer":
        with np.load(path) as z:
            features = tuple(int(f) for f in z["__features__"])
            params = unflatten_tree({k: z[k] for k in z.files if k != "__features__"})
        net = DynUNet(flownet_config(features))
        net.load_state_dict(dynunet_from_flax(params, net.config))
        return cls(net=net.to(resolve_device(device)).eval(), **kw)

    @classmethod
    def load_pretrained(cls, domain: str = "synthetic", device=None,
                        **kw) -> "FlowNetProposer":
        """The committed weights, ``ARTIFACTS/flownet_{domain}.npz``
        (``"synthetic"``: raw synthetic instances; ``"transformed"``: one-step
        diffusion-transformed ones, the domain the cell path feeds)."""
        if domain not in ("synthetic", "transformed"):
            raise ValueError(f"domain={domain!r}: choose synthetic or transformed")
        path = ARTIFACTS / f"flownet_{domain}.npz"
        if not path.exists():
            raise FileNotFoundError(f"the flow-net artifact {path} is missing: it ships "
                                    "in ldiffusion_tpu_torch/artifacts/")
        return cls.load(str(path), device=device, **kw)

    def _net_out(self, x):
        """(H, W, 3) float32 on the device → the net's (H, W, 3) output."""
        return self.net(x.permute(2, 0, 1)[None])[0].permute(1, 2, 0)

    def _forward(self, image):
        """(H, W, 3) image → the net's (H, W, 3) output, float32, through the
        image shape's program."""
        return self.programs["net"](torch.as_tensor(image, dtype=torch.float32))

    def predict_flows(self, image) -> np.ndarray:
        return self._forward(image).cpu().numpy()

    def _follow(self, flows, cellprob, *, n_iter, method, prob_threshold):
        return follow_flows(flows, cellprob, n_iter, prob_threshold, method)

    def follow(self, flows, cellprob, method: str = "squaring"):
        """``follow_flows`` at this proposer's ``n_iter`` and
        ``prob_threshold`` through the program of (H, W, ``n_iter``,
        ``method``, ``prob_threshold``), as the JAX ``follow_flows`` is
        jitted with ``n_iter`` and ``method`` static."""
        return self.programs["follow_flows"](flows, cellprob, n_iter=self.n_iter, method=method,
                                             prob_threshold=float(self.prob_threshold))

    def device_flows_and_pos(self, image):
        """(positions (H, W, 2), cellprob (H, W)) on the device: the explicit
        route ``propose`` is held against (two programs)."""
        with torch.inference_mode():
            out = self._forward(image)
            flows, cellprob = out[..., :2] / 5.0, torch.sigmoid(out[..., 2])
            return self.follow(flows, cellprob), cellprob

    def _propose_out(self, x, *, n_iter, prob_threshold):
        out = self._net_out(x)
        flows, cellprob = out[..., :2] / 5.0, torch.sigmoid(out[..., 2])
        pos = follow_flows(flows, cellprob, n_iter, prob_threshold)
        h, w = cellprob.shape
        py = torch.round(pos[..., 0]).clamp(0, h - 1).to(torch.int32)
        px = torch.round(pos[..., 1]).clamp(0, w - 1).to(torch.int32)
        return py * w + px, cellprob > prob_threshold

    def _device_propose(self, image):
        """The device side of ``propose`` as one program of (H, W,
        ``n_iter``, ``prob_threshold``): net → sigmoid → ``follow_flows`` →
        (rounded flat sink index int32, foreground mask)."""
        h, w = image.shape[:2]
        if h * w >= 2 ** 31:
            raise ValueError(f"a {h}x{w} image overflows the int32 flat sink index")
        return self.programs["propose"](torch.as_tensor(image, dtype=torch.float32),
                                        n_iter=self.n_iter,
                                        prob_threshold=float(self.prob_threshold))

    def propose(self, image) -> np.ndarray:
        sink_flat, fg = self._device_propose(image)
        return cluster_endpoints_packed(sink_flat.cpu().numpy(), fg.cpu().numpy(),
                                        self.min_size)

    def loss_fn(self, images, flow_targets):
        """images, flow_targets: (B, H, W, 3) tensors. The cellpose objective:
        L2 on the 5× flows + BCE on the cell probability logit."""
        out = self.net(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        flow_l2 = torch.mean((out[..., :2] - flow_targets[..., :2] * 5.0) ** 2)
        logits, tgt = out[..., 2], flow_targets[..., 2]
        return flow_l2 + optax_sigmoid_bce(logits, tgt).mean()


def optax_sigmoid_bce(logits, targets):
    """Elementwise sigmoid binary cross-entropy on logits, in the stable form
    of ``optax.sigmoid_binary_cross_entropy``: max(z, 0) − z·t + log1p(e^−|z|)."""
    return torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


class FlowNetTrainer:
    """AdamW over the flow net: ``lr`` (1e-3), betas (0.9, 0.999), eps 1e-8
    and weight decay 1e-4, optax.adamw's defaults (torch's decay default is
    1e-2). The step is one ``TrainProgram`` per batch shape (the JAX
    trainer's jitted step; a short last batch is its own), AdamW
    ``capturable`` on a card."""

    def __init__(self, proposer: FlowNetProposer, lr: float = 1e-3):
        self.proposer = proposer
        dev = proposer.device
        one_card = dev.type == "cuda"
        self.opt = torch.optim.AdamW(proposer.net.parameters(), lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4, capturable=one_card)
        self.program = Jit(self.step_fn, dev, torch.cuda.graph_pool_handle() if one_card else None,
                           program_type=TrainProgram, name="flownet_step")

    def step_fn(self, images, flow_targets):
        """One AdamW step on device tensors, what the program captures.
        Returns the loss, a 0-d device tensor."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.proposer.loss_fn(images, flow_targets)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def step(self, images, flow_targets) -> float:
        """One step through the batch shape's program; the loss is read
        after it, as the JAX loop reads ``float(loss)``."""
        return float(self.program(images, flow_targets))

    def train(self, images, instance_masks, epochs: int = 10, batch_size: int = 4,
              seed: int = 0):
        """images: (H, W, 3) in [0, 1]; instance_masks: (H, W) int ids. Returns
        the mean loss of each epoch."""
        dev = self.proposer.device
        x = torch.from_numpy(np.stack(images).astype(np.float32)).to(dev)
        y = torch.from_numpy(np.stack([masks_to_flows(m) for m in instance_masks])).to(dev)
        rng = np.random.default_rng(seed)
        losses = []
        for _ in range(epochs):
            order = torch.from_numpy(rng.permutation(x.shape[0])).to(dev)
            total = [self.step(x[order[s:s + batch_size]], y[order[s:s + batch_size]])
                     for s in range(0, x.shape[0], batch_size)]
            losses.append(sum(total) / max(len(total), 1))
        return losses
