"""Image resizing (counterpart of ``ldiffusion_tpu/ops/resize.py``).

``resize_bilinear`` uses half-pixel centres (``align_corners=False``) and
never antialiases, also when shrinking (512² decodes → 64² trajectory
features): the JAX package forces ``antialias=False`` to match torch's
``F.interpolate`` default. ``rgb_to_gray`` is the ITU-R 601 luma with the
reference's weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GRAY_WEIGHTS = (0.2989, 0.5870, 0.1140)


def upsample_nearest_2x(x):
    """2x nearest upsample, NHWC (B, H, W, C) → (B, 2H, 2W, C)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)


def resize_bilinear(x, size, channel_last: bool = True):
    """Resize the spatial dims to ``size=(H, W)``; x: (B, H, W, C) if
    ``channel_last`` else (B, C, H, W). Keeps x's dtype."""
    nchw = x.permute(0, 3, 1, 2) if channel_last else x
    y = F.interpolate(nchw, size=tuple(size), mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1) if channel_last else y


def _nearest_index(n_in: int, n_out: int, device):
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * n_in / n_out
    return torch.floor(pos).long()


def resize_nearest(x, size, channel_last: bool = True):
    """Nearest resize of the spatial dims to ``size=(H, W)``; x: (..., H, W, C)
    if ``channel_last`` else (..., C, H, W)."""
    h_dim, w_dim = (-3, -2) if channel_last else (-2, -1)
    for dim, n in ((h_dim, size[0]), (w_dim, size[1])):
        if x.shape[dim] != n:
            x = x.index_select(dim, _nearest_index(x.shape[dim], n, x.device))
    return x


def rgb_to_gray(x):
    """(..., 3) → (..., 1): 0.2989 R + 0.5870 G + 0.1140 B. The weights are
    host numbers: a weight tensor made with ``torch.tensor(..., device=)``
    is a host-to-device copy, which a captured training step cannot hold."""
    r, g, b = x.unbind(-1)
    wr, wg, wb = GRAY_WEIGHTS
    return (r * wr + g * wg + b * wb)[..., None]
