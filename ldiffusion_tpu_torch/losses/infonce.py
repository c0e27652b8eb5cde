"""InfoNCE contrastive loss + VGG19 content loss, the stage-1 objective
(counterpart of ``ldiffusion_tpu/losses/infonce.py``).

The contrastive loss is split in two. ``sample_contrast_indices`` draws, per
image, ``num_anchors`` anchor pixels (the first ``num_classes`` pinned one per
present class when ``num_classes`` is given), one positive per anchor (same
class, self excluded) and ``num_negatives`` negatives (other classes, with
replacement), from an explicit ``torch.Generator``; an anchor is valid iff its
class has more than one pixel and more than ``num_negatives`` pixels outside
it (the reference's eligibility rule). ``contrastive_loss`` takes those
indices: raw dot products over the temperature, cross-entropy against the
positive, mean over valid anchors (0 where none is), mean over the batch.
The JAX package draws the same distributions with Gumbel-max keys; the draws
themselves differ, so tests hand both the JAX package's indices.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import NamedTuple, Optional

import torch

from ldiffusion_tpu_torch.core.device import resolve_device
from ldiffusion_tpu_torch.models.layers import init_random_
from ldiffusion_tpu_torch.models.safetensors_io import load_state_dict
from ldiffusion_tpu_torch.models.vgg import VGG19Features, convert_vgg19
from ldiffusion_tpu_torch.ops.resize import resize_bilinear


class ContrastIndices(NamedTuple):
    anchor: torch.Tensor     # (B, A) pixel indices into the flattened H*W
    positive: torch.Tensor   # (B, A)
    negatives: torch.Tensor  # (B, A, K)
    valid: torch.Tensor      # (B, A) bool


def _uniform_over(mask: torch.Tensor, n: int, generator, replacement: bool = False):
    """``n`` draws per row, uniform over the row's True entries (a row with
    none draws uniformly over all: its anchor is invalid anyway). The empty
    rows are filled with ``torch.where``: a boolean index syncs with the host
    (``nonzero``), which a captured step cannot."""
    w = mask.float()
    w = torch.where(w.sum(dim=1, keepdim=True) == 0, torch.ones_like(w), w)
    return torch.multinomial(w, n, replacement=replacement, generator=generator)


def sample_contrast_indices(labels, generator: torch.Generator, num_negatives: int = 1024,
                            num_anchors: int = 64,
                            num_classes: Optional[int] = None) -> ContrastIndices:
    """labels: (B, H, W) integer class ids → the indices ``contrastive_loss``
    takes, drawn from ``generator`` (on labels' device)."""
    if num_classes is not None and num_classes >= num_anchors:
        raise ValueError(f"num_anchors={num_anchors} must exceed num_classes={num_classes}")
    b = labels.shape[0]
    labs = labels.reshape(b, -1)
    n = labs.shape[1]
    dev = labs.device
    out = []
    for lab in labs:
        if num_classes is None:
            anchor = torch.randint(0, n, (num_anchors,), generator=generator, device=dev)
            present = torch.ones(num_anchors, dtype=torch.bool, device=dev)
        else:
            class_mask = lab[None, :] == torch.arange(num_classes, device=dev)[:, None]
            pinned = _uniform_over(class_mask, 1, generator)[:, 0]
            uniform = torch.randint(0, n, (num_anchors - num_classes,), generator=generator,
                                    device=dev)
            anchor = torch.cat([pinned, uniform])
            present = torch.cat([class_mask.any(dim=1),
                                 torch.ones(num_anchors - num_classes, dtype=torch.bool,
                                            device=dev)])
        same = lab[None, :] == lab[anchor][:, None]  # (A, N)
        n_same = same.sum(dim=1)
        valid = present & (n_same > 1) & (n - n_same > num_negatives)
        # self excluded by a comparison: an index assignment of a host
        # ``False`` is a host-to-device copy, which a captured step cannot hold
        others = same & (torch.arange(n, device=dev)[None, :] != anchor[:, None])
        positive = _uniform_over(others, 1, generator)[:, 0]
        negatives = _uniform_over(~same, num_negatives, generator, replacement=True)
        out.append((anchor, positive, negatives, valid))
    return ContrastIndices(*(torch.stack(x) for x in zip(*out)))


def contrastive_loss(features, indices: ContrastIndices, temperature: float = 0.5):
    """features: (B, H, W, C) trajectory features → scalar loss."""
    b, h, w, c = features.shape
    feats = features.reshape(b, h * w, c).float()
    rows = torch.arange(b, device=feats.device)[:, None]
    a = feats[rows, indices.anchor]                        # (B, A, C)
    p = feats[rows, indices.positive]                      # (B, A, C)
    neg = feats[rows[..., None], indices.negatives]        # (B, A, K, C)
    pos_sim = (a * p).sum(-1) / temperature                # (B, A)
    neg_sim = torch.einsum("bac,bakc->bak", a, neg) / temperature
    logits = torch.cat([pos_sim[..., None], neg_sim], dim=-1)
    ce = torch.logsumexp(logits, dim=-1) - pos_sim
    valid = indices.valid
    n_valid = valid.sum(dim=1)
    per_image = torch.where(valid, ce, torch.zeros_like(ce)).sum(dim=1) / n_valid.clamp_min(1)
    return torch.where(n_valid > 0, per_image, torch.zeros_like(per_image)).mean()


@dataclasses.dataclass
class InfoNceLoss:
    """Combined content + contrastive loss (reference ``model/loss.py:111-126``)."""

    vgg: VGG19Features
    temperature: float = 0.5
    num_negatives: int = 1024
    num_anchors: int = 64
    num_classes: Optional[int] = None
    pretrained_vgg: bool = False

    @classmethod
    def create(cls, seed: int = 7, vgg_weights_path: Optional[str] = None, device=None,
               **kw) -> "InfoNceLoss":
        """``vgg_weights_path``: a torchvision vgg19 state dict saved with
        ``torch.save`` or as ``.safetensors``, or unset to use the ``LDIFFUSION_VGG19_WEIGHTS``
        environment variable. Without weights the content loss runs on a
        seeded random frozen VGG — a deterministic multiscale feature MSE, but
        NOT the reference's pretrained-VGG19 semantics — and warns so.
        ``device``: None → the GPU (raises when there is none)."""
        device = resolve_device(device)
        with torch.device("meta"):
            vgg = VGG19Features()
        vgg = vgg.to_empty(device=device)
        vgg_weights_path = vgg_weights_path or os.environ.get("LDIFFUSION_VGG19_WEIGHTS")
        if vgg_weights_path:
            vgg.load_state_dict(convert_vgg19(load_state_dict(vgg_weights_path)))
            pretrained = True
        else:
            warnings.warn(
                "InfoNceLoss: no VGG19 weights provided — content loss uses a "
                "RANDOM frozen VGG, deviating from the reference's pretrained "
                "VGG19 (model/loss.py:19-27). Pass vgg_weights_path= or set "
                "LDIFFUSION_VGG19_WEIGHTS to a torchvision vgg19 state dict.",
                stacklevel=2,
            )
            init_random_(vgg, torch.Generator(device=device).manual_seed(seed))
            pretrained = False
        vgg.requires_grad_(False).eval()
        return cls(vgg=vgg, pretrained_vgg=pretrained, **kw)

    def content_loss(self, original, generated):
        """VGG feature MSE at 224² (reference ``loss.py:19-42``);
        original/generated: (B, H, W, 3)."""
        feats = [self.vgg(resize_bilinear(x.float(), (224, 224)).permute(0, 3, 1, 2))
                 for x in (original, generated)]
        return torch.mean((feats[0] - feats[1]) ** 2)

    def sample(self, labels, generator: torch.Generator) -> ContrastIndices:
        return sample_contrast_indices(labels, generator, self.num_negatives,
                                       self.num_anchors, self.num_classes)

    def contrast(self, features, indices: ContrastIndices):
        return contrastive_loss(features, indices, self.temperature)
