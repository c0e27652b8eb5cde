"""The stage-2 segmentor's loss (counterpart of
``ldiffusion_tpu/losses/dice.py:32-156``; reference
``training/loss/{dice,robust_ce_loss,compound_losses,deep_supervision}.py``):
soft Dice over (batch and) spatial axes without the background class, robust
cross-entropy, their sum, and the deep-supervision weighting (1/2^i, the
lowest scale zeroed, normalised); and the cell level's evaluation metric,
``micro_dice`` (``ldiffusion_tpu/losses/dice.py:179-194``).

Layout: logits (B, C, *spatial), channels first; targets (B, *spatial) int.
Computed in float32 whatever the logits' dtype. The loss mask of an ignore
label (with the label managers), the TopK, focal and cell-level losses wait
(ROADMAP queue 1, *Long tail*).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _one_hot(targets, num_classes: int):
    """(B, *spatial) → (B, C, *spatial) float32; out-of-range targets are
    all-zero rows, as ``jax.nn.one_hot`` gives them."""
    t = targets.long()
    valid = (t >= 0) & (t < num_classes)
    oh = F.one_hot(torch.where(valid, t, torch.zeros_like(t)), num_classes).float()
    oh = oh * valid.unsqueeze(-1)
    return oh.movedim(-1, 1)


SMOOTH = 1e-5


def soft_dice_loss(logits, targets, batch_dice: bool = True):
    """1 − mean soft Dice over the foreground classes (reference
    ``dice.py:58-119``)."""
    c = logits.shape[1]
    probs = torch.softmax(logits.float(), dim=1)
    onehot = _one_hot(targets, c)
    spatial = tuple(range(2, probs.dim()))
    axes = (0,) + spatial if batch_dice else spatial
    tp = (probs * onehot).sum(dim=axes)
    fp = (probs * (1.0 - onehot)).sum(dim=axes)
    fn = ((1.0 - probs) * onehot).sum(dim=axes)
    tp, fp, fn = tp[..., 1:], fp[..., 1:], fn[..., 1:]
    dc = (2 * tp + SMOOTH) / torch.clamp(2 * tp + fp + fn + SMOOTH, min=1e-8)
    return 1.0 - dc.mean()


def robust_cross_entropy(logits, targets):
    """Mean CE over the pixels (reference ``robust_ce_loss.py:6-15``);
    targets outside [0, C) are clamped, as the JAX package does."""
    c = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    idx = targets.long().clamp(0, c - 1).unsqueeze(1)
    return -logp.gather(1, idx).mean()


def dc_and_ce_loss(logits, targets, batch_dice: bool = True):
    """nnU-Net's default compound, Dice + CE (reference
    ``compound_losses.py:8-57``)."""
    return soft_dice_loss(logits, targets, batch_dice=batch_dice) + \
        robust_cross_entropy(logits, targets)


def deep_supervision_weights(n: int):
    """float32 (n,): 1/2^i, the lowest scale zeroed, normalised."""
    w = torch.tensor([1.0 / (2 ** i) for i in range(n)], dtype=torch.float32)
    if n > 1:
        w[-1] = 0.0
    return w / w.sum()


def deep_supervision_loss(logits_list: Sequence, targets_list: Sequence, loss_fn):
    """Σ wᵢ·loss(logitsᵢ, targetsᵢ), highest resolution first (reference
    ``deep_supervision.py:5-30``; weights ``nnUNetTrainer.py:364-373``)."""
    w = deep_supervision_weights(len(logits_list))
    total = 0.0
    for i, (lg, tg) in enumerate(zip(logits_list, targets_list)):
        total = total + w[i].to(lg.device) * loss_fn(lg, tg)
    return total


def micro_dice(pred_labels, true_labels, num_classes: int):
    """Evaluation micro-Dice over every pixel of the batch, with the
    empty-class = 1 convention (reference ``segmentor.py:114-142``,
    ``utils.py:55-82``). ``pred_labels``: (B, H, W) labels or (B, C, H, W)
    logits (argmax over C). Returns (per-class (C,) float32, their mean)."""
    if pred_labels.dim() == 4:
        pred_labels = pred_labels.argmax(dim=1)
    p = _one_hot(pred_labels.reshape(1, -1), num_classes)[0]
    t = _one_hot(true_labels.reshape(1, -1), num_classes)[0]
    tp = (p * t).sum(dim=1)
    fp = (p * (1 - t)).sum(dim=1)
    fn = ((1 - p) * t).sum(dim=1)
    dice = torch.where(tp + fp + fn == 0, torch.ones_like(tp),
                       2 * tp / torch.clamp(2 * tp + fp + fn, min=1e-8))
    return dice, dice.mean()
