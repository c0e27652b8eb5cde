"""The stage-1 Laplace warm-up step in plain PyTorch (L-Diffusion
``ldiffusion.py:121-295``, ``model/loss.py:19-126``): the Laplace draw and
the contrastive indices from one generator, the trajectory, the VGG19
content loss at 224² plus InfoNCE over the trajectory's grays, the backward,
the global gradient clip and AdamW on float32 parameters.

The draws call the generator as the program's trainer does (the noise, then
per image the pinned anchors, the uniform anchors, the positives and the
negatives), so the same seed on the same device gives the same draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from portbench.reference import diffusion, models


class Indices(NamedTuple):
    anchor: torch.Tensor     # (B, A) pixel indices of the flattened label map
    positive: torch.Tensor   # (B, A)
    negatives: torch.Tensor  # (B, A, K)
    valid: torch.Tensor      # (B, A) bool


def _uniform_over(mask, n: int, generator, replacement: bool = False):
    w = mask.float()
    w = torch.where(w.sum(dim=1, keepdim=True) == 0, torch.ones_like(w), w)
    return torch.multinomial(w, n, replacement=replacement, generator=generator)


def sample_indices(labels, generator, num_classes: int, num_anchors: int = 64,
                   num_negatives: int = 1024) -> Indices:
    """Per image: one anchor pinned in each class (uniform over its pixels),
    the rest uniform; a positive of the anchor's class other than itself; the
    negatives from the other classes, with replacement. An anchor is valid
    when its class has more than one pixel and more than ``num_negatives``
    pixels lie outside it."""
    labs = labels.reshape(labels.shape[0], -1)
    n, dev = labs.shape[1], labs.device
    out = []
    for lab in labs:
        class_mask = lab[None, :] == torch.arange(num_classes, device=dev)[:, None]
        pinned = _uniform_over(class_mask, 1, generator)[:, 0]
        uniform = torch.randint(0, n, (num_anchors - num_classes,), generator=generator,
                                device=dev)
        anchor = torch.cat([pinned, uniform])
        present = torch.cat([class_mask.any(dim=1),
                             torch.ones(num_anchors - num_classes, dtype=torch.bool, device=dev)])
        same = lab[None, :] == lab[anchor][:, None]
        n_same = same.sum(dim=1)
        valid = present & (n_same > 1) & (n - n_same > num_negatives)
        others = same & (torch.arange(n, device=dev)[None, :] != anchor[:, None])
        positive = _uniform_over(others, 1, generator)[:, 0]
        negatives = _uniform_over(~same, num_negatives, generator, replacement=True)
        out.append((anchor, positive, negatives, valid))
    return Indices(*(torch.stack(x) for x in zip(*out)))


def info_nce(features, idx: Indices, temperature: float = 0.5):
    """features (B, H, W, C): cross-entropy of each valid anchor's positive
    against its negatives (dot products over the temperature), mean over the
    valid anchors, then over the batch."""
    b, h, w, c = features.shape
    feats = features.reshape(b, h * w, c)
    rows = torch.arange(b, device=feats.device)[:, None]
    a, p = feats[rows, idx.anchor], feats[rows, idx.positive]
    neg = feats[rows[..., None], idx.negatives]
    pos = (a * p).sum(-1) / temperature
    logits = torch.cat([pos[..., None], torch.einsum("bac,bakc->bak", a, neg) / temperature], -1)
    ce = torch.logsumexp(logits, dim=-1) - pos
    n_valid = idx.valid.sum(dim=1)
    per_image = torch.where(idx.valid, ce, torch.zeros_like(ce)).sum(dim=1) / n_valid.clamp_min(1)
    return torch.where(n_valid > 0, per_image, torch.zeros_like(per_image)).mean()


class Stage1:
    """The reference trainer: float32 parameters (the UNet and the
    projection trained, the VAE, the text tower and VGG19 frozen), one
    ``torch.Generator`` seeded as the program's, AdamW with the program's
    hyperparameters. ``state``: {"unet", "vae", "text", "proj", "vgg"} state
    dicts; ``prec``: the precision of the products."""

    def __init__(self, cfg: dict, state: dict, device, seed: int,
                 prec: models.Precision = None):
        prec = prec or models.Precision()
        tr = cfg["train"]
        self.cfg, self.device = cfg, torch.device(device)
        with torch.device("meta"):
            mods = {"unet": models.UNet(cfg["unet"]), "vae": models.VAE(cfg["vae"]),
                    "text": models.CLIPText(cfg["text_encoder"]),
                    "proj": models.Linear(cfg["text_encoder"]["hidden_size"],
                                          cfg["unet"]["cross_attention_dim"]),
                    "vgg": models.VGG19Features()}
        for key, m in mods.items():
            m.to_empty(device=self.device).load_state_dict(state[key])
            models.set_precision(m, prec)
            setattr(self, key, m)
        for m in (self.vae, self.text, self.vgg):
            m.requires_grad_(False)
        self.trained = {f"{key}.{name}": p for key in ("unet", "proj")
                        for name, p in getattr(self, key).named_parameters()}
        self.opt = torch.optim.AdamW(list(self.trained.values()), lr=tr["learning_rate"],
                                     betas=tuple(tr["betas"]), eps=tr["eps"],
                                     weight_decay=tr["weight_decay"], foreach=False)
        self.generator = None if self.device.type == "meta" else \
            torch.Generator(device=self.device).manual_seed(seed)
        self.steps = max(1, tr["num_inference_steps"] // 5)

    def draw(self, images, labels):
        b, (h, w) = labels.shape[0], images.shape[1:3]
        n_t = len(diffusion.plms_timesteps(self.steps)[0])
        f = 2 ** (len(self.cfg["vae"]["block_out_channels"]) - 1)
        noise = diffusion.laplace_noise((n_t, b, h // f, w // f, self.cfg["vae"]["latent_channels"]),
                                        self.generator, self.device)
        return noise, sample_indices(labels, self.generator, self.cfg["train"]["num_classes"])

    def loss(self, images, labels, noise, idx, remat: bool = True):
        """(content + contrast, content, contrast) of one batch."""
        emb = diffusion.text_embedding(self.text, self.proj, images.shape[0])
        grays, rgb64 = diffusion.trajectory(self.unet, self.vae, emb, images, noise, self.steps,
                                            remat=remat)
        feats = [self.vgg(diffusion.resize(x.permute(0, 3, 1, 2), (224, 224)))
                 for x in (images, rgb64)]
        content = torch.mean((feats[0] - feats[1]) ** 2)
        contrast = info_nce(grays, idx)
        return content + contrast, content, contrast

    def step(self, images, labels) -> dict:
        """One step on device tensors: images (B, H, W, 3) normalised, labels
        (B, 64, 64) int. Returns the losses, the gradient norm before the
        clip and each trained tensor's clipped gradient (the tensors AdamW
        reads, which the next step replaces)."""
        noise, idx = self.draw(images, labels)
        for p in self.trained.values():
            p.grad = None
        loss, content, contrast = self.loss(images, labels, noise, idx)
        loss.backward()
        for p in self.trained.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = nn.utils.clip_grad_norm_(list(self.trained.values()),
                                        self.cfg["train"]["grad_clip"])
        grads = {k: p.grad for k, p in self.trained.items()}
        self.opt.step()
        return {"loss": float(loss.detach()), "content": float(content.detach()),
                "contrast": float(contrast.detach()), "grad_norm": float(norm), "grads": grads}
