"""Spacing-aware resampling (the port's copy of
``ldiffusion_tpu/segmentor/resample.py:19-140``; reference
``default_resampling.py:13-216``): cubic-spline (order 3) zoom for image
data, per-class one-hot linear zoom + argmax for labels (no interpolated
label values), linear for logits; volumes with anisotropic spacing (largest
over smallest > 3) are resampled in-plane slice by slice, then along the
coarse axis with ``order_z`` (nearest by default). scipy on the host, as in
the JAX package, so both give the same arrays."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy import ndimage

ANISOTROPY_THRESHOLD = 3.0  # reference configuration.py ANISO_THRESHOLD


def compute_new_shape(old_shape: Sequence[int], old_spacing: Sequence[float],
                      new_spacing: Sequence[float]) -> Tuple[int, ...]:
    return tuple(int(round(s * osp / nsp))
                 for s, osp, nsp in zip(old_shape, old_spacing, new_spacing))


def resample_data(data: np.ndarray, new_shape: Sequence[int], order: int = 3) -> np.ndarray:
    """data: (H, W) or (H, W, C) float."""
    if tuple(data.shape[:2]) == tuple(new_shape):
        return data
    zoom = [n / o for n, o in zip(new_shape, data.shape[:2])]
    if data.ndim == 3:
        out = np.stack([ndimage.zoom(data[..., c], zoom, order=order)
                        for c in range(data.shape[-1])], axis=-1)
    else:
        out = ndimage.zoom(data, zoom, order=order)
    return out.astype(data.dtype)


def _onehot_zoom(seg: np.ndarray, zoom) -> np.ndarray:
    """Each present label's mask zoomed linearly, then the argmax's label."""
    classes = np.unique(seg)
    stack = np.stack([ndimage.zoom((seg == c).astype(np.float32), zoom, order=1)
                      for c in classes])
    return classes[np.argmax(stack, axis=0)].astype(seg.dtype)


def resample_seg(seg: np.ndarray, new_shape: Sequence[int]) -> np.ndarray:
    """Labels by per-class one-hot linear zoom + argmax."""
    if tuple(seg.shape) == tuple(new_shape):
        return seg
    return _onehot_zoom(seg, [n / o for n, o in zip(new_shape, seg.shape)])


def resample_logits(logits: np.ndarray, new_shape: Sequence[int]) -> np.ndarray:
    """(H, W, C) logits, linear per channel."""
    return resample_data(logits, new_shape, order=1)


def _is_anisotropic(spacing: Sequence[float]) -> bool:
    sp = np.asarray(spacing, np.float64)
    return bool(np.max(sp) / np.min(sp) > ANISOTROPY_THRESHOLD)


def resample_data_3d(data: np.ndarray, new_shape: Sequence[int],
                     spacing: Sequence[float] = (1.0, 1.0, 1.0),
                     order: int = 3, order_z: int = 0, is_seg: bool = False) -> np.ndarray:
    """(Z, H, W) labels or single channel, or (Z, H, W, C), to ``new_shape``.
    Isotropic spacing: one 3D zoom. Anisotropic: the coarsest axis (largest
    spacing, not necessarily axis 0) goes to the front, each slice is
    resampled in-plane with ``order`` (labels one-hot), then that axis with
    ``order_z`` (labels always by nearest index, on ``ndimage.zoom``'s
    ``(old - 1) / (new - 1)`` grid)."""
    data = np.asarray(data)
    has_c = data.ndim == 4
    if tuple(data.shape[:3]) == tuple(new_shape):
        return data
    zoom = [n / o for n, o in zip(new_shape, data.shape[:3])]
    if not _is_anisotropic(spacing):
        if is_seg:
            return _onehot_zoom(data, zoom)
        if has_c:
            return np.stack([ndimage.zoom(data[..., c], zoom, order=order)
                             for c in range(data.shape[-1])], axis=-1).astype(data.dtype)
        return ndimage.zoom(data, zoom, order=order).astype(data.dtype)

    z_ax = int(np.argmax(spacing))
    if z_ax != 0:
        perm = (z_ax,) + tuple(a for a in range(3) if a != z_ax)
        inv = tuple(int(np.argsort(perm)[a]) for a in range(3))
        extra = (3,) if has_c else ()
        out = resample_data_3d(np.transpose(data, perm + extra),
                               tuple(new_shape[a] for a in perm),
                               tuple(spacing[a] for a in perm),
                               order=order, order_z=order_z, is_seg=is_seg)
        return np.transpose(out, inv + extra)
    nz, nh, nw = new_shape
    if is_seg:
        planes = [resample_seg(data[z], (nh, nw)) for z in range(data.shape[0])]
    else:
        planes = [resample_data(data[z], (nh, nw), order=order) for z in range(data.shape[0])]
    vol = np.stack(planes, axis=0)
    if vol.shape[0] == nz:
        return vol.astype(data.dtype)
    if is_seg or order_z == 0:
        old_z = vol.shape[0]
        idx = np.zeros(1, np.int64) if nz == 1 else \
            np.round(np.arange(nz) * (old_z - 1) / (nz - 1)).astype(np.int64)
        return vol[np.clip(idx, 0, old_z - 1)].astype(data.dtype)
    axes_zoom = (nz / vol.shape[0],) + (1.0,) * (vol.ndim - 1)
    return ndimage.zoom(vol, axes_zoom, order=order_z).astype(data.dtype)
