"""Cell instance classifier (counterpart of ``ldiffusion_tpu/cell/classifier.py``;
reference ``model/conductor.py:138-233``): instances → 64×64 crops → frozen
ResNet encoder → 3×3 adapter conv (2048 → 256) → global average pool → linear
head → top-1 over classes 1..C−1 (background dropped), painted back per
instance.

The crop and resize run on the device (``roi_resize_64``, batched gathers):
the host sends one image and a box table per ROI. The PIL path
(``extract_instance_patches``) is kept as the oracle. ``CellTrainer`` caches
the frozen encoder's features once per training image and trains only the
adapter and the linear layer, with per-instance cross-entropy against each
instance's majority ground-truth class (the JAX package's working version of
the reference's gradient-less loss).

The device work runs as ``core/graphs.py`` programs, the JAX package's
jitted functions, one per bucket (``classify_patches``: float16 batch →
encoder → head, the JAX ``_make_logits_fn``) or per (image shape, bucket)
(``classify_rois``: crop, resize, normalise, encoder, head, the JAX
``_roi_logits_fn_cached``; ``roi_features``, the JAX
``CellTrainer._roi_feats_fn``), in the classifier's memory pool; the
trainer's head step is a ``TrainProgram`` per bucket (AdamW ``capturable``
on a card). Each runs eagerly at its first use, is captured as a CUDA graph
at its second and replays after; on the CPU each call runs the function. A
program's output holds until the next call of a program of its pool.

The checkpoint (``save``/``load``) is the JAX package's pickle,
``{"head": flax tree, "num_classes"}``, so each package reads the other's.
It does not hold the encoder: each package rebuilds its encoder from a fixed
seed, and a torch generator cannot reproduce the JAX package's
``jax.random.key(0)``, so the two packages' encoders differ unless one is
carried across (``models/convert.py:resnet_from_flax`` / ``resnet_to_flax``).
This package draws its encoder on the CPU from seed 0, so it is the same
on every device.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image
from torch import nn

from ldiffusion_tpu_torch.cell.instance import DistanceWatershedProposer, InstanceProposer
from ldiffusion_tpu_torch.core.checkpoint import load_pytree, save_pytree
from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.core.graphs import Jit, TrainProgram
from ldiffusion_tpu_torch.core.logging import TextLogger
from ldiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
from ldiffusion_tpu_torch.losses.dice import micro_dice
from ldiffusion_tpu_torch.models.convert import CELL_HEAD_ROWS, from_flax, to_flax
from ldiffusion_tpu_torch.models.layers import init_random_
from ldiffusion_tpu_torch.models.resnet import ResNetConfig, ResNetEncoder

PATCH = 64
MIN_BOX = 4  # reference conductor.py:197


def _resize64(patch: np.ndarray) -> np.ndarray:
    img = Image.fromarray((np.clip(patch, 0, 1) * 255).astype(np.uint8))
    return np.asarray(img.resize((PATCH, PATCH), Image.BILINEAR), np.float32) / 255.0


def extract_instance_boxes(instances: np.ndarray):
    """(H, W) instance ids → (ids, boxes (x1, y1, x2, y2) inclusive), from one
    ``ndimage.find_objects`` pass; boxes with a side under ``MIN_BOX`` are
    skipped (reference ``conductor.py:197``)."""
    from scipy import ndimage

    if instances.max() <= 0:
        return [], []
    keep, boxes = [], []
    for i, sl in enumerate(ndimage.find_objects(instances), start=1):
        if sl is None:  # id absent
            continue
        ysl, xsl = sl
        y1, y2, x1, x2 = ysl.start, ysl.stop - 1, xsl.start, xsl.stop - 1
        if y2 - y1 < MIN_BOX or x2 - x1 < MIN_BOX:
            continue
        keep.append(int(i))
        boxes.append((int(x1), int(y1), int(x2), int(y2)))
    return keep, boxes


def roi_resize_64(image, boxes):
    """(H, W, 3) image tensor + (B, 4) float boxes (x1, y1, x2, y2 inclusive,
    integral) → (B, 64, 64, 3) crops in the image's value range.

    Bilinear with PIL's centre convention, src = (dst + 0.5)·scale − 0.5,
    taps clamped to the box (the crop's edges replicate as if it were cut
    out first), no antialias filter and no uint8 quantisation
    (``PARITY.md:88``)."""
    x1, y1, x2, y2 = boxes.unbind(dim=1)
    d = torch.arange(PATCH, dtype=torch.float32, device=image.device) + 0.5
    sy = (y2 - y1 + 1.0) / PATCH
    sx = (x2 - x1 + 1.0) / PATCH
    ys = torch.minimum(torch.maximum(y1[:, None] + d * sy[:, None] - 0.5, y1[:, None]),
                       y2[:, None])
    xs = torch.minimum(torch.maximum(x1[:, None] + d * sx[:, None] - 0.5, x1[:, None]),
                       x2[:, None])
    y0f, x0f = torch.floor(ys), torch.floor(xs)
    wy, wx = ys - y0f, xs - x0f  # (B, 64) each
    y0, x0 = y0f.long(), x0f.long()
    y1i = torch.minimum(y0 + 1, y2.long()[:, None])
    x1i = torch.minimum(x0 + 1, x2.long()[:, None])

    def g(yi, xi):  # (B, 64) rows × (B, 64) columns → (B, 64, 64, 3)
        return image[yi[:, :, None], xi[:, None, :]]

    ry, rx = wy[:, :, None, None], wx[:, None, :, None]
    return (g(y0, x0) * (1 - ry) * (1 - rx) + g(y0, x1i) * (1 - ry) * rx
            + g(y1i, x0) * ry * (1 - rx) + g(y1i, x1i) * ry * rx)


def extract_instance_patches(image: np.ndarray, instances: np.ndarray):
    """The host (PIL) path, the oracle of ``roi_resize_64``: (patches
    (N, 64, 64, 3) ImageNet-normalised, ids, boxes). The per-crop resizes
    run on a thread pool (PIL releases the GIL)."""
    keep, boxes = extract_instance_boxes(instances)
    if not keep:
        return np.zeros((0, PATCH, PATCH, 3), np.float32), [], []

    def crop(b):
        x1, y1, x2, y2 = b
        return (_resize64(image[y1:y2 + 1, x1:x2 + 1]) - IMAGENET_MEAN) / IMAGENET_STD

    if len(boxes) > 8:
        with ThreadPoolExecutor(max_workers=8) as pool:
            patches = list(pool.map(crop, boxes))
    else:
        patches = [crop(b) for b in boxes]
    return np.stack(patches), keep, boxes


class CellHead(nn.Module):
    """3×3 "SAME" adapter conv (the reference's 1×1 on a 2×2 map's
    equivalent) → global average pool → linear."""

    def __init__(self, feat_dim: int, num_classes: int):
        super().__init__()
        self.adapter = nn.Conv2d(feat_dim, 256, 3, padding=1)
        self.classifier = nn.Linear(256, num_classes)

    def forward(self, feats):
        return self.classifier(self.adapter(feats).mean(dim=(2, 3)))


class CellSegClassifier:
    """Frozen encoder + trainable head over instance patches; ``proposer``
    (default ``DistanceWatershedProposer``) finds the instances."""

    def __init__(self, num_classes: int, encoder_cfg: Optional[ResNetConfig] = None,
                 proposer: Optional[InstanceProposer] = None, device=None):
        """``device``: None → the GPU (raises when there is none). The encoder
        (ResNet-152 unless ``encoder_cfg``) and the head are drawn on the CPU
        from one generator seeded with 0: conv weights N(0, 1/fan_in),
        BatchNorm at identity; the adapter U(±1/sqrt(9·2048)) and the linear
        layer U(±1/16), biases 0."""
        self.num_classes = num_classes
        self.encoder_cfg = encoder_cfg or ResNetConfig.resnet152()
        gen = torch.Generator().manual_seed(0)
        with torch.device("meta"):
            encoder = ResNetEncoder(self.encoder_cfg)
            head = CellHead(self.encoder_cfg.out_channels, num_classes)
        encoder.to_empty(device="cpu")
        for m in encoder.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_running_stats()
        init_random_(encoder, gen)
        head.to_empty(device="cpu")
        bound = 1.0 / np.sqrt(self.encoder_cfg.out_channels * 9)
        with torch.no_grad():
            head.adapter.weight.copy_(torch.rand(head.adapter.weight.shape, generator=gen)
                                      * 2 * bound - bound)
            head.classifier.weight.copy_(torch.rand(head.classifier.weight.shape,
                                                    generator=gen) / 8 - 1 / 16)
            head.adapter.bias.zero_()
            head.classifier.bias.zero_()
        device = resolve_device(device)
        self.encoder = encoder.to(device, memory_format=torch.channels_last).eval()
        self.encoder.requires_grad_(False)
        self.head = head.to(device)
        self.proposer = proposer or DistanceWatershedProposer()
        self._norm = (torch.from_numpy(IMAGENET_MEAN).to(device),
                      torch.from_numpy(IMAGENET_STD).to(device))
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        self.programs = {name: Jit(fn, device, pool, name=f"classifier_{name}")
                         for name, fn in (("patch_logits", self._patch_logits),
                                          ("roi_logits", self._roi_logits),
                                          ("roi_features", self._roi_features))}
        self.last_predict: dict = {}  # stage times and counts of the last predict_mask

    @property
    def device(self) -> torch.device:
        return self.head.classifier.weight.device

    # -- forward ------------------------------------------------------------
    def encode(self, patches):
        """(B, 64, 64, 3) normalised patches → frozen features (B, 2048, 2, 2)."""
        x = patches.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            return self.encoder(x)

    def _roi_features(self, image, boxes):
        patches = roi_resize_64(image, boxes)
        return self.encode((patches - self._norm[0]) / self._norm[1])

    def roi_features(self, image, boxes: np.ndarray):
        """(H, W, 3) image in [0, 1] + (bucket, 4) padded boxes → features:
        crop, resize and normalise on the device, through the program of
        (image shape, bucket)."""
        return self.programs["roi_features"](torch.as_tensor(image, dtype=torch.float32),
                                             torch.from_numpy(boxes))

    @staticmethod
    def _top1(logits, n: int) -> np.ndarray:
        probs = torch.softmax(logits.float(), dim=-1)[:, 1:]  # background dropped
        return (probs.argmax(dim=-1) + 1)[:n].cpu().numpy()

    @staticmethod
    def _bucket(n: int) -> int:
        """The padded batch: powers of two (at least 32) up to 512, multiples
        of 512 above."""
        if n <= 512:
            return max(32, 1 << (n - 1).bit_length())
        return -(-n // 512) * 512

    def _patch_logits(self, batch):
        return self.head(self.encode(batch.float()))

    def classify_patches(self, patches: np.ndarray) -> np.ndarray:
        """(N, 64, 64, 3) normalised patches → classes in 1..C−1. The batch is
        zero-padded to its bucket and cast to float16 before the encoder, as
        the JAX package sends it (the encoder computes in float32); the
        bucket's program gives the logits."""
        n = patches.shape[0]
        if n == 0:
            return np.zeros((0,), np.int64)
        batch = np.zeros((self._bucket(n),) + patches.shape[1:], np.float16)
        batch[:n] = patches
        return self._top1(self.programs["patch_logits"](torch.from_numpy(batch)), n)

    def pad_boxes(self, boxes) -> np.ndarray:
        """(N, 4) boxes → (bucket, 4) float32, padded with full-patch boxes
        (their rows are dropped after the argmax)."""
        n = len(boxes)
        bb = np.zeros((self._bucket(n), 4), np.float32)
        bb[:, 2:] = PATCH - 1.0
        bb[:n] = np.asarray(boxes, np.float32)
        return bb

    def _roi_logits(self, image, boxes):
        return self.head(self._roi_features(image, boxes))

    def classify_rois(self, image: np.ndarray, boxes) -> np.ndarray:
        """Classes in 1..C−1 for each (x1, y1, x2, y2) box of ``image``
        ((H, W, 3) in [0, 1]), crops made on the device, in the program of
        (image shape, bucket)."""
        n = len(boxes)
        if n == 0:
            return np.zeros((0,), np.int64)
        logits = self.programs["roi_logits"](torch.as_tensor(image, dtype=torch.float32),
                                             torch.from_numpy(self.pad_boxes(boxes)))
        return self._top1(logits, n)

    def _class_lut(self, instances: np.ndarray, ids, classes) -> np.ndarray:
        """Instance id → class (0 for background and skipped instances)."""
        lut = np.zeros(int(instances.max()) + 1, np.int64)
        lut[np.asarray(ids, np.int64)] = classes
        return lut

    def forward(self, image: np.ndarray) -> dict:
        """(H, W, 3) in [0, 1] → {"out": (1, H, W, C) one-hot painted mask,
        "instances": (H, W) ids} (reference forward, ``:175-233``)."""
        instances = self.proposer.propose(image)
        ids, boxes = extract_instance_boxes(instances)
        out = np.zeros((1,) + image.shape[:2] + (self.num_classes,), np.float32)
        if not ids:
            return {"out": out, "instances": instances}
        cls_map = self._class_lut(instances, ids, self.classify_rois(image, boxes))[instances]
        fg = cls_map > 0
        out[0][fg, cls_map[fg]] = 1.0
        return {"out": out, "instances": instances}

    def predict_mask(self, image: np.ndarray) -> np.ndarray:
        """(H, W) uint8 class map: the argmax of ``forward``'s one-hot, read
        from the id → class table. Records the host seconds of the propose
        and classify stages, the instance count and the bucket in
        ``last_predict``."""
        t0 = time.perf_counter()
        instances = self.proposer.propose(image)
        ids, boxes = extract_instance_boxes(instances)
        t1 = time.perf_counter()
        if not ids:
            self.last_predict = {"propose_s": t1 - t0, "classify_s": 0.0, "instances": 0,
                                 "bucket": 0}
            return np.zeros(image.shape[:2], np.uint8)
        classes = self.classify_rois(image, boxes)
        self.last_predict = {"propose_s": t1 - t0, "classify_s": time.perf_counter() - t1,
                             "instances": len(ids), "bucket": self._bucket(len(ids))}
        return self._class_lut(instances, ids, classes)[instances].astype(np.uint8)

    # -- persistence ---------------------------------------------------------
    def save(self, path: str) -> None:
        save_pytree(path, {"head": to_flax(CELL_HEAD_ROWS, self.head.state_dict()),
                           "num_classes": self.num_classes})

    def load(self, path: str) -> None:
        ck = load_pytree(path)
        if ck["num_classes"] != self.num_classes:
            raise ValueError(f"{path} holds a {ck['num_classes']}-class head, "
                             f"this classifier has {self.num_classes}")
        self.head.load_state_dict(from_flax(CELL_HEAD_ROWS, ck["head"]))


class CellTrainer:
    """AdamW over the adapter and the linear layer (``lr``, 1e-4; betas, eps
    and weight decay 1e-4 as optax.adamw's defaults); per-instance CE; the
    best validation micro-Dice checkpoint (reference
    ``segmentor.py:243-299``). The head step is one ``TrainProgram`` per
    bucket (the JAX trainer's jitted step), AdamW ``capturable`` on a
    card."""

    def __init__(self, model: CellSegClassifier, lr: float = 1e-4):
        self.model = model
        one_card = model.device.type == "cuda"
        self.opt = torch.optim.AdamW(model.head.parameters(), lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=1e-4, capturable=one_card)
        self.program = Jit(self.step_fn, model.device,
                           torch.cuda.graph_pool_handle() if one_card else None,
                           program_type=TrainProgram, name="classifier_head_step")
        self.log = TextLogger()
        self.feature_cache_seconds = 0.0  # host seconds, proposals + encoder features
        self.epoch_seconds = []  # host seconds a training epoch, validation included

    @staticmethod
    def instance_majority_labels(instances: np.ndarray, gt_mask: np.ndarray,
                                 ids: Sequence[int]) -> np.ndarray:
        """The majority ground-truth class of each instance, from one joint
        (instance, class) bincount."""
        n_cls = int(gt_mask.max()) + 1
        joint = np.bincount(
            (instances.astype(np.int64) * n_cls + gt_mask.astype(np.int64)).ravel(),
            minlength=(int(instances.max()) + 1) * n_cls).reshape(-1, n_cls)
        return joint.argmax(axis=1)[np.asarray(ids, np.int64)].astype(np.int32)

    def step_fn(self, feats, labels, valid):
        """One AdamW step on the cached features of one image, what the
        program captures; ``valid`` masks the bucket's pad rows. Returns the
        loss, a 0-d device tensor."""
        self.opt.zero_grad(set_to_none=True)
        logp = torch.log_softmax(self.model.head(feats), dim=-1)
        nll = -logp.gather(1, labels[:, None].long())[:, 0]
        loss = (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def step(self, feats, labels, valid) -> float:
        """One step through the bucket's program; the loss is read after it,
        as the JAX loop reads ``float(loss)``."""
        return float(self.program(feats, labels, valid))

    def cache_features(self, train_pairs):
        """[(features, labels, valid)] of every training image with instances:
        the encoder is frozen, so its features are computed once (a copy of
        the program's output, which the next image's call overwrites)."""
        model, cache = self.model, []
        for img, gt in train_pairs:
            inst = model.proposer.propose(img)
            ids, boxes = extract_instance_boxes(inst)
            if not ids:
                continue
            bb = model.pad_boxes(boxes)
            labels = np.zeros((bb.shape[0],), np.int64)
            labels[:len(ids)] = self.instance_majority_labels(inst, gt, ids)
            valid = np.zeros((bb.shape[0],), np.float32)
            valid[:len(ids)] = 1.0
            cache.append((model.roi_features(img, bb).clone(),
                          torch.from_numpy(labels).to(model.device),
                          torch.from_numpy(valid).to(model.device)))
        return cache

    def train(self, train_pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
              val_pairs: Sequence[Tuple[np.ndarray, np.ndarray]], epochs: int,
              save_dir: str = "train_save/cellclassifier") -> str:
        """pairs: (image (H, W, 3) in [0, 1], class mask (H, W)). Returns the
        checkpoint path, ``save_dir/<yy_mm_dd>/cellclassifier.pkl``."""
        out_dir = os.path.join(save_dir, time.strftime("%y_%m_%d"))
        path = os.path.join(out_dir, "cellclassifier.pkl")
        t0 = time.perf_counter()
        cache = self.cache_features(train_pairs)
        self.feature_cache_seconds = time.perf_counter() - t0
        best = 0.0
        for epoch in range(epochs):
            t0 = time.perf_counter()
            losses = [self.step(*entry) for entry in cache]
            self.log(f"Epoch {epoch + 1}/{epochs}, Loss: {sum(losses) / max(len(losses), 1):.4f}")
            dice_total = 0.0
            for img, gt in val_pairs:
                pred = self.model.predict_mask(img)
                _, avg = micro_dice(torch.from_numpy(pred[None].astype(np.int64)),
                                    torch.from_numpy(gt[None].astype(np.int64)),
                                    self.model.num_classes)
                dice_total += float(avg)
            val_dice = dice_total / max(len(val_pairs), 1)
            if val_dice > best:
                best = val_dice
                self.model.save(path)
                self.log(f"New Best Validation Dice Score: {val_dice:.4f}")
            else:
                self.log(f"Validation Dice Score: {val_dice:.4f}")
            self.epoch_seconds.append(time.perf_counter() - t0)
        return path
