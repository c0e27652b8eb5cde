"""The stage-2 segmentor's losses (counterpart of
``ldiffusion_tpu/losses/dice.py:32-156, 213-284``; reference
``training/loss/{dice,robust_ce_loss,compound_losses,deep_supervision}.py``):
soft Dice over (batch and) spatial axes without the background class, robust
cross-entropy, their sum, TopK cross-entropy (the hardest k% pixels, optional
label smoothing), focal loss and DC+focal; for the regions regime the sigmoid
family (BCE, sigmoid soft Dice, DC+BCE, sigmoid focal, DC+sigmoid focal); the
deep-supervision weighting (1/2^i, the lowest scale zeroed, normalised); the
conductor nets' ``micro_dice_soft``, ``CombinedLoss`` and
``kl_div_multichannel`` (``:159-210, 285-291``); and the cell level's
evaluation metric, ``micro_dice`` (``ldiffusion_tpu/losses/dice.py:179-194``).

Layout: logits (B, C, *spatial), channels first; targets (B, *spatial) int,
or (B, R, *spatial) region maps for the sigmoid family; ``loss_mask``
(B, *spatial), 0 on ignored pixels. Computed in float32 whatever the
logits' dtype.

``group`` (the counterpart of the JAX ``axis_name``): with batch Dice, tp,
fp and fn are summed over the group's ranks before the Dice, as JAX's
``psum`` and the reference's ``AllGatherGrad`` (``dice.py:107-110``) do,
through ``core.dist.all_reduce_sum``, whose backward sums the gradient over
the ranks. Every rank then holds the global batch Dice and a W-fold share
of its gradient; DDP's mean over W ranks makes that the global gradient.
The cross-entropy terms stay each rank's own mean (nnU-Net's DDP), which
equals the global mean when the ranks hold as many unmasked pixels.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ldiffusion_tpu_torch.core.dist import all_reduce_sum


def _one_hot(targets, num_classes: int):
    """(B, *spatial) → (B, C, *spatial) float32; out-of-range targets are
    all-zero rows, as ``jax.nn.one_hot`` gives them."""
    return one_hot(targets, num_classes).float().movedim(-1, 1)


def one_hot(labels, num_classes: int):
    """(...) int labels → (..., num_classes) bool, a comparison with the
    class ids as ``jax.nn.one_hot`` takes it; a label outside [0,
    num_classes) is an all-false row. Device ops only: ``F.one_hot`` reads
    the labels' minimum and maximum to the host on the CPU."""
    return labels.unsqueeze(-1) == torch.arange(num_classes, device=labels.device)


SMOOTH = 1e-5


def _dice_from(probs, onehot, batch_dice: bool, smooth: float, include_background: bool,
               group=None):
    spatial = tuple(range(2, probs.dim()))
    axes = (0,) + spatial if batch_dice else spatial
    tp = (probs * onehot).sum(dim=axes)
    fp = (probs * (1.0 - onehot)).sum(dim=axes)
    fn = ((1.0 - probs) * onehot).sum(dim=axes)
    if batch_dice and group is not None:
        tp, fp, fn = all_reduce_sum(torch.stack([tp, fp, fn]), group).unbind(0)
    if not include_background:
        tp, fp, fn = tp[..., 1:], fp[..., 1:], fn[..., 1:]
    dc = (2 * tp + smooth) / torch.clamp(2 * tp + fp + fn + smooth, min=1e-8)
    return 1.0 - dc.mean()


def soft_dice_loss(logits, targets, loss_mask=None, batch_dice: bool = True,
                   smooth: float = SMOOTH, group=None):
    """1 − mean soft Dice over the foreground classes (reference
    ``dice.py:58-119``); ``smooth`` 0 is the noSmooth variant."""
    probs = torch.softmax(logits.float(), dim=1)
    onehot = _one_hot(targets, logits.shape[1])
    if loss_mask is not None:
        m = loss_mask.float().unsqueeze(1)
        probs, onehot = probs * m, onehot * m
    return _dice_from(probs, onehot, batch_dice, smooth, include_background=False, group=group)


def _nll(logits, targets):
    """(−log p[target] (B, *spatial), log p (B, C, *spatial)); targets
    outside [0, C) are clamped, as the JAX package does."""
    c = logits.shape[1]
    logp = torch.log_softmax(logits.float(), dim=1)
    idx = targets.long().clamp(0, c - 1).unsqueeze(1)
    return -logp.gather(1, idx).squeeze(1), logp


def _masked_mean(values, loss_mask):
    if loss_mask is None:
        return values.mean()
    m = loss_mask.float()
    return (values * m).sum() / torch.clamp(m.sum(), min=1.0)


def robust_cross_entropy(logits, targets, loss_mask=None):
    """Mean CE over the unmasked pixels (reference ``robust_ce_loss.py:6-15``)."""
    return _masked_mean(_nll(logits, targets)[0], loss_mask)


def topk_cross_entropy(logits, targets, k_percent: float = 10.0,
                       label_smoothing: float = 0.0, loss_mask=None):
    """TopK CE (reference ``robust_ce_loss.py:18-31``): the mean of the
    ``max(1, int(N·k/100))`` largest per-pixel losses of all N pixels. Masked
    pixels are zeroed before the selection and stay in N, as the JAX package
    does, so they only enter the top k once fewer than k pixels lose more
    than 0. ``label_smoothing`` (Topk10LossLS01):
    (1 − ε)·nll + ε·mean_c(−log p)."""
    nll, logp = _nll(logits, targets)
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll - label_smoothing * logp.mean(dim=1)
    if loss_mask is not None:
        nll = nll * loss_mask.float()
    nll = nll.reshape(-1)
    k = max(1, int(nll.numel() * k_percent / 100.0))
    return torch.topk(nll, k, sorted=False).values.mean()


def focal_loss(logits, targets, alpha: float = 1.0, gamma: float = 2.0, loss_mask=None):
    """Softmax focal loss α(1 − p_t)^γ·CE, the masked mean (reference
    ``compound_losses.py:152-181``)."""
    ce = _nll(logits, targets)[0]
    return _masked_mean(alpha * (1.0 - torch.exp(-ce)) ** gamma * ce, loss_mask)


def dc_and_ce_loss(logits, targets, loss_mask=None, batch_dice: bool = True,
                   smooth: float = SMOOTH, group=None):
    """nnU-Net's default compound, Dice + CE (reference
    ``compound_losses.py:8-57``)."""
    return soft_dice_loss(logits, targets, loss_mask, batch_dice, smooth, group) + \
        robust_cross_entropy(logits, targets, loss_mask)


def dc_and_focal_loss(logits, targets, loss_mask=None, batch_dice: bool = True, group=None):
    """Dice + focal (reference ``compound_losses.py:183-207``). As in the JAX
    package, the mask reaches the Dice term only."""
    return soft_dice_loss(logits, targets, loss_mask, batch_dice, group=group) + \
        focal_loss(logits, targets)


def dc_and_topk10_loss(logits, targets, loss_mask=None, batch_dice: bool = True,
                       smooth: float = SMOOTH, group=None):
    """Dice + TopK10 (reference ``compound_losses.py:103-149``)."""
    return soft_dice_loss(logits, targets, loss_mask, batch_dice, smooth, group) + \
        topk_cross_entropy(logits, targets, loss_mask=loss_mask)


# ---------------------------------------------------------------------------
# the sigmoid family (regions)
# ---------------------------------------------------------------------------

def _bce(logits, targets):
    lg = logits.float()
    return lg.clamp_min(0) - lg * targets.float() + torch.log1p(torch.exp(-lg.abs()))


def binary_cross_entropy_with_logits(logits, targets, loss_mask=None):
    """Elementwise BCE over the region channels, the (masked) mean
    (reference ``compound_losses.py:59-100``)."""
    bce = _bce(logits, targets)
    if loss_mask is None:
        return bce.mean()
    m = loss_mask.float().unsqueeze(1)
    return (bce * m).sum() / torch.clamp(m.sum() * logits.shape[1], min=1.0)


def soft_dice_loss_sigmoid(logits, region_targets, loss_mask=None, batch_dice: bool = True,
                           smooth: float = SMOOTH, group=None):
    """1 − mean soft Dice of sigmoid probabilities over every region."""
    probs = torch.sigmoid(logits.float())
    tgt = region_targets.float()
    if loss_mask is not None:
        m = loss_mask.float().unsqueeze(1)
        probs, tgt = probs * m, tgt * m
    return _dice_from(probs, tgt, batch_dice, smooth, include_background=True, group=group)


def dc_and_bce_loss(logits, region_targets, loss_mask=None, batch_dice: bool = True,
                    group=None):
    """The reference's region compound (``compound_losses.py:59-100``)."""
    return soft_dice_loss_sigmoid(logits, region_targets, loss_mask, batch_dice,
                                  group=group) + \
        binary_cross_entropy_with_logits(logits, region_targets, loss_mask)


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0,
                       loss_mask=None):
    """α(1 − p_t)^γ·BCE, the mean; with a mask, its sum over the masked
    pixels' channels divided by the masked pixel count (reference
    ``compound_losses.py:152-170, 197-200``)."""
    tg = targets.float()
    p = torch.sigmoid(logits.float())
    p_t = tg * p + (1 - tg) * (1 - p)
    fl = alpha * (1 - p_t) ** gamma * _bce(logits, targets)
    if loss_mask is None:
        return fl.mean()
    m = loss_mask.float().unsqueeze(1)
    return (fl * m).sum() / torch.clamp(m.sum(), min=1e-8)


def dc_and_focal_sigmoid_loss(logits, region_targets, loss_mask=None,
                              batch_dice: bool = True, group=None):
    """The regions regime's training loss (reference
    ``nnUNetTrainer.py:350-355``, ``compound_losses.py:173-207``)."""
    return soft_dice_loss_sigmoid(logits, region_targets, loss_mask, batch_dice,
                                  group=group) + \
        sigmoid_focal_loss(logits, region_targets, loss_mask=loss_mask)


def deep_supervision_weights(n: int):
    """float32 (n,): 1/2^i, the lowest scale zeroed, normalised."""
    w = torch.tensor([1.0 / (2 ** i) for i in range(n)], dtype=torch.float32)
    if n > 1:
        w[-1] = 0.0
    return w / w.sum()


def deep_supervision_loss(logits_list: Sequence, targets_list: Sequence, loss_fn):
    """Σ wᵢ·loss(logitsᵢ, targetsᵢ), highest resolution first (reference
    ``deep_supervision.py:5-30``; weights ``nnUNetTrainer.py:364-373``)."""
    w = deep_supervision_weights(len(logits_list)).tolist()  # host numbers: no copy
    total = 0.0
    for i, (lg, tg) in enumerate(zip(logits_list, targets_list)):
        total = total + w[i] * loss_fn(lg, tg)
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


def micro_dice_soft(logits, targets, num_classes: int, class_weights=None,
                    fp_weight: float = 0.3, fn_weight: float = 0.7, smooth: float = 1e-5):
    """The differentiable micro-Dice of the conductor nets
    (``ldiffusion_tpu/losses/dice.py:159-179``; reference MicroDiceLoss,
    ``model/loss.py:128-171``): softmax probabilities, tp/fp/fn summed over
    the batch and space, FP weighted 0.3 and FN 0.7, absent classes scored 0,
    ``class_weights`` padded with ones (or cut) to ``num_classes``."""
    probs = torch.softmax(logits.float(), dim=1)
    onehot = _one_hot(targets, num_classes)
    axes = (0,) + tuple(range(2, probs.dim()))
    tp = (probs * onehot).sum(dim=axes)
    fp = (probs * (1 - onehot)).sum(dim=axes)
    fn = ((1 - probs) * onehot).sum(dim=axes)
    present = (onehot.sum(dim=axes) + fp) > 0
    dice = 2 * tp / (2 * tp + fp_weight * fp + fn_weight * fn + smooth)
    dice = torch.where(present, dice, torch.zeros_like(dice))
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=dice.device)
        if cw.shape[0] < num_classes:
            cw = torch.cat([cw, cw.new_ones(num_classes - cw.shape[0])])
        dice = dice * cw[:num_classes]
    return 1.0 - dice.mean()


class CombinedLoss:
    """Weighted soft micro-Dice (class weights 1, 2, 2, 1, the rest 1) plus
    cross-entropy ignoring label 255 (reference ``model/loss.py:173-186``)."""

    def __init__(self, num_classes: int = 7, dice_weight: float = 1.0, ce_weight: float = 1.0):
        self.num_classes = num_classes
        self.dice_weight = dice_weight
        self.ce_weight = ce_weight
        self.class_weights = (1.0, 2.0, 2.0, 1.0)

    def __call__(self, logits, targets):
        dice = micro_dice_soft(logits, targets, self.num_classes, self.class_weights)
        ce = robust_cross_entropy(logits, targets, loss_mask=targets != 255)
        return self.dice_weight * dice + self.ce_weight * ce


def kl_div_multichannel(pred_logits, target_logits):
    """KL(softmax(target) ‖ softmax(pred)) over dim 1, batchmean (reference
    ``model/loss.py:206-214``)."""
    logp = torch.log_softmax(pred_logits.float(), dim=1)
    q = torch.softmax(target_logits.float(), dim=1)
    logq = torch.log_softmax(target_logits.float(), dim=1)
    return (q * (logq - logp)).sum() / pred_logits.shape[0]
