"""Data augmentation of the stage-2 trainer, the default 2D stack
(counterpart of ``ldiffusion_tpu/data/augment.py:29-212, 321-538, 568-635``;
reference ``nnUNetTrainer.py:673-795`` via batchgenerators).

* Host: rotation ±180° / scaling 0.7-1.4 (p 0.2 each) by the native C++
  resample in the prefetch thread (``HostSpatialAugmenter``), from patches
  sampled at the enlarged initial size and centre-cropped back to the plan's
  patch (``configure_spatial_da``), as the JAX trainer does.
* Device (``augment_batch``): Gaussian noise (p 0.1), Gaussian blur σ 0.5-1
  (p 0.2), multiplicative brightness 0.75-1.25 (p 0.15), contrast 0.75-1.25
  (p 0.15), simulated low resolution by 2× or 4× mean pooling (p 0.25),
  inverted and plain gamma 0.7-1.5 (p 0.1, 0.3), mirroring (p 0.5 an axis),
  as torch ops on the batch's device.
* The DA5 recipe's additions (``ldiffusion_tpu/data/augment.py:321-530``;
  reference ``nnUNetTrainerDA5.py:106-264``): rot90 and transpose of square
  patches; OneOf(median 3/5/7 | blur); additive per-channel brightness;
  contrast clipped half the time to the channel's range; the second gamma
  inverted; then, after mirroring, blank rectangles (1-5, filled with their
  mean), an additive brightness gradient and a local gamma (Gaussian bumps
  centred anywhere in [-0.5, 1.5]·size), and Laplacian sharpening clipped to
  the channel's range.

Each transform's random draws are split from its application:
``draw_augment_params`` draws every per-sample parameter from an explicit
``torch.Generator`` (on the batch's device, so a step needs no host sync)
and ``apply_augment`` applies them, so a test can fix the parameters. As in
the JAX package, a transform whose p is 0 is skipped, and an enabled one is
computed for the whole batch and selected per sample; the median filters,
the stack's costliest, run only when a sample picked one (one host read of
the flags).

Rotation and scaling in one resample (``augment_batch`` with ``p_rotation``
or ``p_scaling`` above 0, ``ldiffusion_tpu/data/augment.py:214-236,336-347``)
also run on the device, for callers of the public function: the inverse
map about the patch centre, bilinear for the data and nearest (half-way
rounded away from zero) for the labels, 0 outside, through gathers; one
draw decides both. The trainer keeps them on the host and sets their p to 0
on the device.

Layout: data (B, C, H, W) float32, seg (B, H, W) int.

Volumes (``ldiffusion_tpu/data/augment.py:124-198, 540-566, 637-730``): the
host applies an Euler rotation (±30° about each axis by default,
``rotation_max_3d``) and scaling through the native trilinear resample
(``HostSpatialAugmenter3D``), or, for an anisotropic patch (largest edge over
the first > 3, "dummy 2D"), an in-plane rotation ±180° of every z slice with
the sample's draws repeated across z; the device (``augment_batch_3d``)
mirrors each allowed axis (p 0.5) and adds Gaussian noise (p 0.1), on
(B, C, D, H, W) data and (B, D, H, W) labels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ldiffusion_tpu_torch.native import (
    affine_augment_batch_3d_native,
    affine_augment_batch_native,
)

ANISO_THRESHOLD = 3.0  # reference configuration.py:7


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The same fields and defaults as the JAX package's ``AugmentConfig``."""

    p_rotation: float = 0.2
    p_scaling: float = 0.2
    rotation_max: float = 3.141592653589793  # ±180°
    scale_range: tuple = (0.7, 1.4)
    p_noise: float = 0.1
    noise_var_max: float = 0.1
    p_blur: float = 0.2
    blur_sigma: tuple = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness_range: tuple = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast_range: tuple = (0.75, 1.25)
    p_lowres: float = 0.25
    lowres_zoom: tuple = (0.5, 1.0)
    p_gamma_invert: float = 0.1
    p_gamma: float = 0.3
    gamma_range: tuple = (0.7, 1.5)
    p_mirror: float = 0.5
    mirror_axes: tuple = (0, 1, 2)
    # the DA5 modes and transforms
    brightness_additive_sigma: float = 0.0
    contrast_clip_half: bool = False
    gamma2_invert: bool = False
    p_rot90: float = 0.0
    p_transpose: float = 0.0
    p_median: float = 0.0
    p_blank_rect: float = 0.0
    p_brightness_gradient: float = 0.0
    p_local_gamma: float = 0.0
    p_sharpen: float = 0.0
    sharpen_strength: tuple = (0.1, 1.0)
    rotation_max_3d: float = 0.5235987755982988  # pi/6
    initial_scale_range: tuple = None


# ---------------------------------------------------------------------------
# spatial-DA configuration (rotation range, initial patch size)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SpatialDAPlan:
    """``configure_spatial_da``'s result (reference
    ``nnUNetTrainer.py:375-431``)."""

    rotation_max: tuple        # per-axis max |angle| in radians
    do_dummy_2d: bool
    initial_patch_size: tuple  # sample at this size, centre-crop to the final one
    mirror_axes: tuple


def get_initial_patch_size(final_patch_size, rot_x, rot_y, rot_z, scale_range) -> tuple:
    """The patch to sample so that rotation and zoom-out still see content at
    the final patch's corners (reference
    ``compute_initial_patch_size.py:get_patch_size``): the extent vector
    rotated by each axis's largest angle (3D: about x, y and z in turn; 2D:
    one rotation), the componentwise max, over the least scale. It rotates
    the extent vector, not the corners, as the reference does."""

    def _max_abs(r):
        if isinstance(r, (tuple, list)):
            r = max(abs(float(v)) for v in r)
        return min(np.pi / 2, abs(float(r)))

    coords = np.asarray(final_patch_size, np.float64)
    final = coords.copy()
    if len(coords) == 3:
        for axis, ang in enumerate((_max_abs(rot_x), _max_abs(rot_y), _max_abs(rot_z))):
            c, s = np.cos(ang), np.sin(ang)
            m = np.eye(3)
            a, b = [i for i in range(3) if i != axis]
            m[a, a] = m[b, b] = c
            m[a, b] = s if axis == 1 else -s
            m[b, a] = -s if axis == 1 else s
            final = np.maximum(final, np.abs(coords @ m))
    elif len(coords) == 2:
        c, s = np.cos(_max_abs(rot_x)), np.sin(_max_abs(rot_x))
        final = np.maximum(final, np.abs(coords @ np.array([[c, -s], [s, c]])))
    final = final / min(scale_range)
    return tuple(int(v) for v in final)


def configure_spatial_da(patch_size, initial_scale_range=None) -> SpatialDAPlan:
    """From the patch geometry (reference ``nnUNetTrainer.py:375-431``):
    2D: aspect > 1.5 → rotation ±15°, else ±180°; mirror axes (0, 1). 3D:
    ``max(patch) / patch[0] > 3`` → dummy-2D (in-plane ±180° only, the first
    axis's extent kept), else ±30° about each axis; mirror axes (0, 1, 2).
    The initial patch from the legacy (0.85, 1.25) scale range unless given."""
    patch_size = tuple(int(p) for p in patch_size)
    dim = len(patch_size)
    scale = tuple(initial_scale_range or (0.85, 1.25))
    do_dummy = False
    if dim == 2:
        rot = np.pi / 12 if max(patch_size) / min(patch_size) > 1.5 else np.pi
        rotation, mirror_axes = (rot, 0.0, 0.0), (0, 1)
    elif dim == 3:
        do_dummy = max(patch_size) / patch_size[0] > ANISO_THRESHOLD
        rotation = (np.pi, 0.0, 0.0) if do_dummy else (np.pi / 6,) * 3
        mirror_axes = (0, 1, 2)
    else:
        raise ValueError(f"patch rank {dim}")
    initial = get_initial_patch_size(patch_size, *rotation, scale)
    if do_dummy:
        initial = (patch_size[0], *initial[1:])
    return SpatialDAPlan(rotation_max=rotation, do_dummy_2d=do_dummy,
                         initial_patch_size=initial, mirror_axes=mirror_axes)


def center_crop_batch(data, seg, final_patch):
    """Centre-crop (B, *spatial, C) / (B, *spatial) to ``final_patch``."""
    nd = len(final_patch)
    spatial = data.shape[1:1 + nd]
    sl = [slice(None)]
    for ax in range(nd):
        off = (spatial[ax] - final_patch[ax]) // 2
        if off < 0:
            raise ValueError(f"cannot centre-crop {spatial} to {final_patch}")
        sl.append(slice(off, off + final_patch[ax]))
    return data[tuple(sl)], seg[tuple(sl)]


class HostSpatialAugmenter:
    """Host rotation + scale through the native resample, in the prefetch
    thread (``ldiffusion_tpu/data/augment.py:568-635``), bilinear
    (``data_order=1``) or nearest (0, the DAOrd0 variants) data and nearest
    labels. numpy draws from
    ``default_rng(seed)``, as the JAX package's. ``out_size``: the final
    patch; inputs are then initial-size patches and only the centred window
    is computed. Returns (data (B, *out, C) float32, seg (B, *out) of seg's
    dtype)."""

    def __init__(self, cfg: AugmentConfig, seed: int = 0, data_order: int = 1,
                 out_size=None):
        self.cfg = cfg
        self.data_order = data_order
        self.rng = np.random.default_rng(seed)
        self.out_size = tuple(out_size) if out_size is not None else None

    def __call__(self, data, seg):
        cfg = self.cfg
        B = data.shape[0]
        u = self.rng.random((B, 2))
        rot = u[:, 0] < cfg.p_rotation
        sc = u[:, 1] < cfg.p_scaling
        apply = rot | sc
        if not apply.any():
            if self.out_size is None:
                return data, seg
            return center_crop_batch(data, seg, self.out_size)
        angles = np.where(rot, self.rng.uniform(-cfg.rotation_max, cfg.rotation_max, B), 0.0)
        scales = np.where(sc, self.rng.uniform(cfg.scale_range[0], cfg.scale_range[1], B), 1.0)
        d, s = affine_augment_batch_native(
            np.ascontiguousarray(data, np.float32), np.ascontiguousarray(seg, np.int16),
            angles, scales, apply, data_order=self.data_order, out_size=self.out_size)
        return d, s.astype(seg.dtype)


class HostSpatialAugmenter3D:
    """Host 3D rotation + scale in the prefetch thread
    (``ldiffusion_tpu/data/augment.py:637-730``), numpy draws from
    ``default_rng(seed)`` in the JAX package's order: the flags (B, 2), the
    scales, then the angles. Euler angles U(±``rotation_max_3d``) about x, y,
    z through the native trilinear resample; with ``dummy_2d`` one in-plane
    angle U(±π) a sample, repeated across its z slices, through the 2D
    resample of the (B·Z) slices. ``out_size``: the final patch, whose
    centred window alone is computed. Returns (data (B, *out, C) float32,
    seg (B, *out) of seg's dtype)."""

    def __init__(self, cfg: AugmentConfig, seed: int = 0, data_order: int = 1,
                 out_size=None, dummy_2d: bool = False):
        self.cfg = cfg
        self.data_order = data_order
        self.rng = np.random.default_rng(seed)
        self.out_size = tuple(out_size) if out_size is not None else None
        self.dummy_2d = dummy_2d

    def draw(self, B: int):
        """(apply, scales, angles): angles (x, y, z) each (B,), or the (B,)
        in-plane angles under ``dummy_2d``; None when no sample moves."""
        cfg = self.cfg
        u = self.rng.random((B, 2))
        rot, sc = u[:, 0] < cfg.p_rotation, u[:, 1] < cfg.p_scaling
        apply = rot | sc
        if not apply.any():
            return None
        scales = np.where(sc, self.rng.uniform(cfg.scale_range[0], cfg.scale_range[1], B), 1.0)
        if self.dummy_2d:
            return apply, scales, np.where(rot, self.rng.uniform(-np.pi, np.pi, B), 0.0)
        r = cfg.rotation_max_3d
        return apply, scales, tuple(np.where(rot, self.rng.uniform(-r, r, B), 0.0)
                                    for _ in range(3))

    def __call__(self, data, seg):
        drawn = self.draw(data.shape[0])
        if drawn is None:
            if self.out_size is None:
                return data, seg
            return center_crop_batch(data, seg, self.out_size)
        return self.apply(data, seg, *drawn)

    def apply(self, data, seg, apply, scales, angles):
        """The transform of ``draw``'s values (fixed draws in the tests)."""
        data = np.ascontiguousarray(data, np.float32)
        seg16 = np.ascontiguousarray(seg, np.int16)
        if not self.dummy_2d:
            d, s = affine_augment_batch_3d_native(data, seg16, *angles, scales, apply,
                                                  data_order=self.data_order,
                                                  out_size=self.out_size)
            return d, s.astype(seg.dtype)
        # (B, Z, H, W, C) → (B·Z, H, W, C), each sample's draws repeated across z
        B, Z, H, W, C = data.shape
        out2d = None if self.out_size is None else self.out_size[1:]
        OH, OW = (H, W) if out2d is None else out2d
        d, s = affine_augment_batch_native(
            data.reshape(B * Z, H, W, C), seg16.reshape(B * Z, H, W), np.repeat(angles, Z),
            np.repeat(scales, Z), np.repeat(apply, Z), data_order=self.data_order,
            out_size=out2d)
        d, s = d.reshape(B, Z, OH, OW, C), s.reshape(B, Z, OH, OW).astype(seg.dtype)
        if self.out_size is not None and Z != self.out_size[0]:
            d, s = center_crop_batch(d, s, self.out_size)
        return d, s


# ---------------------------------------------------------------------------
# device stack
# ---------------------------------------------------------------------------

def _uniform(lo, hi, n, generator, device):
    """U(lo, hi) of shape ``n`` (an int or a tuple)."""
    return lo + (hi - lo) * torch.rand(n, generator=generator, device=device)


def draw_augment_params(shape: Sequence[int], cfg: AugmentConfig,
                        generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    """Every per-sample draw of ``apply_augment`` for a (B, C, H, W) batch:
    ``<name>_on`` flags (u < p) and the values of the enabled transforms."""
    B = shape[0]
    g = generator
    p: Dict[str, torch.Tensor] = {}
    u = torch.rand((B, 9), generator=g, device=device)

    def flag(i, prob):
        return u[:, i] < prob

    if cfg.p_noise > 0:
        p["noise_on"] = flag(0, cfg.p_noise)
        p["noise_var"] = _uniform(0.0, cfg.noise_var_max, B, g, device)
        p["noise"] = torch.randn(tuple(shape), generator=g, device=device)
    if cfg.p_blur > 0:
        p["blur_on"] = flag(1, cfg.p_blur)
        p["blur_sigma"] = _uniform(*cfg.blur_sigma, B, g, device)
    if cfg.p_brightness > 0:
        p["brightness_on"] = flag(2, cfg.p_brightness)
        if not cfg.brightness_additive_sigma:  # DA5's additive shift: _draw_da5
            p["brightness"] = _uniform(*cfg.brightness_range, B, g, device)
    if cfg.p_contrast > 0:
        p["contrast_on"] = flag(3, cfg.p_contrast)
        p["contrast"] = _uniform(*cfg.contrast_range, B, g, device)
    if cfg.p_lowres > 0:
        p["lowres_on"] = flag(4, cfg.p_lowres)
        p["lowres_factor4"] = torch.rand(B, generator=g, device=device) < 0.5
    if cfg.p_gamma_invert > 0:
        p["gamma_invert_on"] = flag(5, cfg.p_gamma_invert)
        p["gamma_invert"] = _uniform(*cfg.gamma_range, B, g, device)
    if cfg.p_gamma > 0:
        p["gamma_on"] = flag(6, cfg.p_gamma)
        p["gamma"] = _uniform(*cfg.gamma_range, B, g, device)
    if cfg.p_mirror > 0:
        if 0 in cfg.mirror_axes:
            p["mirror_h"] = flag(7, cfg.p_mirror)
        if 1 in cfg.mirror_axes:
            p["mirror_w"] = flag(8, cfg.p_mirror)
    p.update(_draw_da5(shape, cfg, g, device))
    p.update(_draw_spatial(B, cfg, g, device))
    return p


def _draw_spatial(B: int, cfg: AugmentConfig, g, device) -> Dict[str, torch.Tensor]:
    """The rotation and scaling draws, last, so the stream of a stack without
    them is unchanged: an angle where the rotation fires (else 0), a scale
    where the scaling fires (else 1), and ``spatial_on`` where either does."""
    if not (cfg.p_rotation > 0 or cfg.p_scaling > 0):
        return {}
    u = torch.rand((B, 2), generator=g, device=device)
    rotate, scale = u[:, 0] < cfg.p_rotation, u[:, 1] < cfg.p_scaling
    angle = _uniform(-cfg.rotation_max, cfg.rotation_max, B, g, device)
    factor = _uniform(*cfg.scale_range, B, g, device)
    return {"spatial_on": rotate | scale,
            "angle": torch.where(rotate, angle, torch.zeros_like(angle)),
            "scale": torch.where(scale, factor, torch.ones_like(factor))}


def _draw_da5(shape, cfg: AugmentConfig, g, device) -> Dict[str, torch.Tensor]:
    """The DA5 draws, from their own flags so the default stack's stream is
    unchanged (as the JAX package keeps them in a key block of their own)."""
    B, C, h, w = shape
    p: Dict[str, torch.Tensor] = {}
    if not any(getattr(cfg, f) for f in ("p_rot90", "p_transpose", "p_median",
                                         "brightness_additive_sigma", "contrast_clip_half",
                                         "p_blank_rect", "p_brightness_gradient",
                                         "p_local_gamma", "p_sharpen")):
        return p
    u5 = torch.rand((B, 7), generator=g, device=device)

    def coin(size=(B,)):
        return torch.rand(size, generator=g, device=device) < 0.5

    def randint(lo, hi, size=(B,)):
        return torch.randint(lo, hi, size, generator=g, device=device)

    def bump():  # (sy, sx, my, mx) of a Gaussian bump, per sample
        lh, lw = np.log(max(h / 6.0, 1.0)), np.log(max(w / 6.0, 1.0))
        return torch.stack([_uniform(lh, np.log(float(h)), B, g, device).exp(),
                            _uniform(lw, np.log(float(w)), B, g, device).exp(),
                            _uniform(-0.5, 1.5, B, g, device) * h,
                            _uniform(-0.5, 1.5, B, g, device) * w], dim=1)

    if cfg.p_rot90 > 0 and h == w:
        p["rot90_on"] = u5[:, 0] < cfg.p_rot90
        p["rot90_k"] = randint(0, 4)
    if cfg.p_transpose > 0 and h == w:
        p["transpose_on"] = u5[:, 1] < cfg.p_transpose
    if cfg.p_median > 0:
        p["median_pick"] = coin()
        p["median_on"] = u5[:, 2] < cfg.p_median
        p["median_size"] = randint(0, 3)  # 3, 5 or 7
    if cfg.p_brightness > 0 and cfg.brightness_additive_sigma > 0:
        on = coin((B, C))
        p["brightness_shift"] = torch.randn((B, C), generator=g, device=device) \
            * cfg.brightness_additive_sigma * on
    if cfg.p_contrast > 0 and cfg.contrast_clip_half:
        p["contrast_clip"] = coin()
    if cfg.p_blank_rect > 0:
        p["blank_on"] = u5[:, 3] < cfg.p_blank_rect
        p["blank_n"] = randint(1, 6)
        p["blank_channels"] = coin((B, C))
        rh = randint(max(1, h // 10), max(2, h // 3 + 1), (B, 5))
        rw = randint(max(1, w // 10), max(2, w // 3 + 1), (B, 5))
        y0 = torch.minimum(randint(0, h, (B, 5)), h - rh)
        x0 = torch.minimum(randint(0, w, (B, 5)), w - rw)
        p["blank_rects"] = torch.stack([y0, x0, rh, rw], dim=2)
    if cfg.p_brightness_gradient > 0:
        p["gradient_on"] = u5[:, 4] < cfg.p_brightness_gradient
        p["gradient_bump"] = bump()
        sign = torch.where(coin((B, C)), 1.0, -1.0)
        p["gradient_strength"] = _uniform(1.0, 5.0, (B, C), g, device) * sign * coin((B, C))
    if cfg.p_local_gamma > 0:
        p["local_gamma_on"] = u5[:, 5] < cfg.p_local_gamma
        p["local_gamma_bump"] = bump()
        p["local_gamma"] = torch.where(coin((B, C)), _uniform(0.01, 0.8, (B, C), g, device),
                                       _uniform(1.5, 4.0, (B, C), g, device))
        p["local_gamma_channels"] = coin((B, C))
    if cfg.p_sharpen > 0:
        p["sharpen_on"] = u5[:, 6] < cfg.p_sharpen
        p["sharpen_strength"] = _uniform(*cfg.sharpen_strength, B, g, device)
    return p


def _sel(on, a, b):
    """Per sample: ``a`` where ``on`` else ``b``."""
    return torch.where(on.view((-1,) + (1,) * (a.dim() - 1)), a, b)


def _col(v, x):
    return v.to(x.dtype).view((-1,) + (1,) * (x.dim() - 1))


def gauss_kernel(sigma, radius: int = 3):
    """(B,) sigmas → (B, 2r+1) normalised Gaussian taps."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x[None, :] / sigma[:, None].float()) ** 2)
    return k / k.sum(dim=1, keepdim=True)


def blur(x, sigma, radius: int = 3):
    """Separable 7-tap Gaussian blur with edge replication, rows then
    columns (``_blur``): x (B, C, H, W), sigma (B,)."""
    k = gauss_kernel(sigma, radius).to(x.dtype)
    h, w = x.shape[-2:]
    xp = F.pad(x, (0, 0, radius, radius), mode="replicate")
    out = None
    for i in range(2 * radius + 1):
        term = k[:, i].view(-1, 1, 1, 1) * xp[:, :, i:i + h, :]
        out = term if out is None else out + term
    xp = F.pad(out, (radius, radius, 0, 0), mode="replicate")
    out = None
    for i in range(2 * radius + 1):
        term = k[:, i].view(-1, 1, 1, 1) * xp[:, :, :, i:i + w]
        out = term if out is None else out + term
    return out


def gamma(x, g, invert: bool):
    """Per-sample gamma over the sample's range (``_gamma``): x (B, C, H, W),
    g (B,)."""
    if invert:
        x = -x
    flat = x.reshape(x.shape[0], -1)
    mn = _col(flat.min(dim=1).values, x)
    rng = _col(flat.max(dim=1).values, x) - mn + 1e-7
    x = torch.pow((x - mn) / rng, _col(g, x)) * rng + mn
    return -x if invert else x


def contrast(x, c):
    """(x − mean)·c + mean, the mean per sample and channel."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    return (x - mean) * _col(c, x) + mean


def lowres(x, factor: int):
    """Mean-pool by ``factor``, then nearest upsampling back."""
    pooled = F.avg_pool2d(x, factor)
    return pooled.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def median_filter(x, size: int):
    """k×k median of each channel with edge replication (``_median_filter``)."""
    r = size // 2
    xp = F.pad(x, (r, r, r, r), mode="replicate")
    win = xp.unfold(2, size, 1).unfold(3, size, 1)  # (B, C, H, W, k, k)
    return win.reshape(*win.shape[:4], size * size).median(dim=-1).values


def _channel_range(x):
    """Per-sample, per-channel (min, max) over the spatial axes, (B, C, 1, 1)."""
    flat = x.flatten(2)
    return flat.min(dim=2).values[..., None, None], flat.max(dim=2).values[..., None, None]


def laplacian(x):
    """4-neighbour Laplacian with edge replication (``_laplacian``)."""
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    return 4.0 * x - xp[..., :-2, 1:-1] - xp[..., 2:, 1:-1] - xp[..., 1:-1, :-2] \
        - xp[..., 1:-1, 2:]


def gaussian_bump(params, h: int, w: int):
    """(B, 4) (sy, sx, my, mx) → (B, 1, H, W) separable Gaussian bumps,
    normalised by their maximum (``_local_gaussian_kernel``)."""
    yy = torch.arange(h, dtype=torch.float32, device=params.device)
    xx = torch.arange(w, dtype=torch.float32, device=params.device)
    sy, sx, my, mx = (params[:, i, None] for i in range(4))
    ky = torch.exp(-0.5 * ((yy[None] - my) / sy) ** 2)
    kx = torch.exp(-0.5 * ((xx[None] - mx) / sx) ** 2)
    k = ky[:, :, None] * kx[:, None, :]
    return (k / (k.flatten(1).max(dim=1).values[:, None, None] + 1e-8))[:, None]


def blank_rectangles(x, rects, n, channels):
    """Up to 5 rectangles (B, 5, 4) = (y0, x0, rh, rw), the first ``n`` (B,)
    of each sample on, each filled on the ``channels`` picked with its mean
    over the data as the previous rectangles left it."""
    h, w = x.shape[-2:]
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    for slot in range(rects.shape[1]):
        y0, x0, rh, rw = (rects[:, slot, i, None, None] for i in range(4))
        mask = ((yy >= y0) & (yy < y0 + rh) & (xx >= x0) & (xx < x0 + rw)).to(x.dtype)[:, None]
        fill = (mask * x).sum(dim=(2, 3), keepdim=True) / (mask.sum(dim=(2, 3), keepdim=True)
                                                           + 1e-8)
        on = (slot < n).to(x.dtype)[:, None, None, None]
        sel = mask * channels.to(x.dtype)[..., None, None] * on
        x = x * (1 - sel) + fill * sel
    return x


def local_gamma(x, bump, g, channels):
    """The exponent goes from 1 to ``g`` (B, C) along the bump, on the
    ``channels`` picked, over each channel's range."""
    mn, mx = _channel_range(x)
    xn = (x - mn) / (mx - mn + 1e-7)
    expnt = bump * ((g - 1.0) * channels.to(x.dtype))[..., None, None] + 1.0
    return torch.pow(xn.clamp_min(1e-7), expnt) * (mx - mn) + mn


def affine_coords(h: int, w: int, angle, scale):
    """(B,) angles and scales → the (B, H, W) rows and columns each output
    pixel samples: rotation by ``angle`` and scaling by ``scale`` about the
    patch centre, as the inverse map (output → input), in float32
    (``_affine_coords``)."""
    yy = torch.arange(h, dtype=torch.float32, device=angle.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=angle.device)[None, :]
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y, x = yy - cy, xx - cx
    cos, sin = (f(angle.float()).view(-1, 1, 1) for f in (torch.cos, torch.sin))
    s = scale.float().view(-1, 1, 1)
    return (cos * y + sin * x) / s + cy, (-sin * y + cos * x) / s + cx


def _round_half_away(x):
    r = torch.round(x)  # half to even; ties move away from zero instead
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x), r)


def map_coordinates(img, sy, sx, order: int):
    """``img`` (B, C, H, W) sampled at rows ``sy`` and columns ``sx`` (B, OH,
    OW): order 1 bilinear, order 0 nearest with half-way coordinates rounded
    away from zero; a tap outside the image reads 0. The taps and their sum
    in ``jax.scipy.ndimage.map_coordinates(mode="constant", cval=0)``'s order."""
    B, C, H, W = img.shape
    flat = img.reshape(B, C, H * W)

    def taps(coord):
        if order == 0:
            return [(_round_half_away(coord).long(), None)]
        lower = torch.floor(coord)
        upper = coord - lower
        return [(lower.long(), 1 - upper), (lower.long() + 1, upper)]

    out = None
    for iy, wy in taps(sy):
        for ix, wx in taps(sx):
            valid = ((iy >= 0) & (iy < H) & (ix >= 0) & (ix < W))[:, None]
            idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, 1, -1)
            v = torch.gather(flat, 2, idx.expand(B, C, -1)).reshape(B, C, *sy.shape[1:])
            term = torch.where(valid, v, torch.zeros_like(v))
            if wy is not None:
                term = (wy * wx)[:, None] * term
            out = term if out is None else out + term
    return out


def spatial_transform(data, seg, angle, scale):
    """Rotation + scaling in one resample: data bilinear, labels nearest."""
    sy, sx = affine_coords(data.shape[-2], data.shape[-1], angle, scale)
    d = map_coordinates(data, sy, sx, 1)
    s = map_coordinates(seg[:, None].float(), sy, sx, 0)[:, 0].to(seg.dtype)
    return d, s


def apply_augment(data, seg, p: Dict[str, torch.Tensor], cfg: AugmentConfig):
    """Apply drawn parameters in the JAX stack's order: rotation + scaling;
    (DA5) rot90 and transpose; noise, blur (or DA5's median), brightness,
    contrast, low resolution, inverted gamma, gamma, mirroring; (DA5) blank
    rectangles, brightness gradient, local gamma, sharpening."""
    h, w = data.shape[-2:]
    if "spatial_on" in p:
        d, s = spatial_transform(data, seg, p["angle"], p["scale"])
        data, seg = _sel(p["spatial_on"], d, data), _sel(p["spatial_on"], s, seg)
    if "rot90_on" in p:
        rd, rs = data, seg
        for k in (1, 2, 3):
            on = p["rot90_on"] & (p["rot90_k"] == k)
            rd = _sel(on, torch.rot90(data, k, dims=(2, 3)), rd)
            rs = _sel(on, torch.rot90(seg, k, dims=(1, 2)), rs)
        data, seg = rd, rs
    if "transpose_on" in p:
        data = _sel(p["transpose_on"], data.transpose(2, 3), data)
        seg = _sel(p["transpose_on"], seg.transpose(1, 2), seg)
    if "noise_on" in p:
        data = _sel(p["noise_on"], data + p["noise"] * _col(p["noise_var"], data).sqrt(), data)
    if "blur_on" in p:
        on = p["blur_on"] & ~p["median_pick"] if "median_pick" in p else p["blur_on"]
        data = _sel(on, blur(data, p["blur_sigma"]), data)
    if "median_pick" in p:
        # every size's filter, then each sample's pick, as the JAX program
        # does: skipping them when no sample picks one is a host branch on
        # device values, which a captured step cannot take
        med = data
        for i, size in enumerate((3, 5, 7)):
            med = _sel(p["median_size"] == i, median_filter(data, size), med)
        data = _sel(p["median_pick"] & p["median_on"], med, data)
    if "brightness_on" in p:
        if "brightness_shift" in p:  # DA5: additive, per channel
            data = _sel(p["brightness_on"], data + p["brightness_shift"][..., None, None], data)
        else:
            data = _sel(p["brightness_on"], data * _col(p["brightness"], data), data)
    if "contrast_on" in p:
        res = contrast(data, p["contrast"])
        if "contrast_clip" in p:
            mn, mx = _channel_range(data)
            res = _sel(p["contrast_clip"], torch.minimum(torch.maximum(res, mn), mx), res)
        data = _sel(p["contrast_on"], res, data)
    if "lowres_on" in p and h % 4 == 0 and w % 4 == 0:
        low = _sel(p["lowres_factor4"], lowres(data, 4), lowres(data, 2))
        data = _sel(p["lowres_on"], low, data)
    if "gamma_invert_on" in p:
        data = _sel(p["gamma_invert_on"], gamma(data, p["gamma_invert"], True), data)
    if "gamma_on" in p:
        data = _sel(p["gamma_on"], gamma(data, p["gamma"], cfg.gamma2_invert), data)
    if "mirror_h" in p:
        data = _sel(p["mirror_h"], data.flip(2), data)
        seg = _sel(p["mirror_h"], seg.flip(1), seg)
    if "mirror_w" in p:
        data = _sel(p["mirror_w"], data.flip(3), data)
        seg = _sel(p["mirror_w"], seg.flip(2), seg)
    if "blank_on" in p:
        n = torch.where(p["blank_on"], p["blank_n"], torch.zeros_like(p["blank_n"]))
        data = blank_rectangles(data, p["blank_rects"], n, p["blank_channels"])
    if "gradient_on" in p:
        add = gaussian_bump(p["gradient_bump"], h, w) * p["gradient_strength"][..., None, None]
        data = _sel(p["gradient_on"], data + add, data)
    if "local_gamma_on" in p:
        res = local_gamma(data, gaussian_bump(p["local_gamma_bump"], h, w), p["local_gamma"],
                          p["local_gamma_channels"])
        data = _sel(p["local_gamma_on"], res, data)
    if "sharpen_on" in p:
        mn, mx = _channel_range(data)
        sharp = data + _col(p["sharpen_strength"], data) * laplacian(data)
        data = _sel(p["sharpen_on"], torch.minimum(torch.maximum(sharp, mn), mx), data)
    return data, seg


def augment_batch(data, seg, cfg: AugmentConfig = AugmentConfig(),
                  generator: Optional[torch.Generator] = None):
    """The device stack on (B, C, H, W) data and (B, H, W) labels (the
    trainer runs rotation and scaling on the host, ``HostSpatialAugmenter``,
    and passes a config with their p at 0)."""
    return apply_augment(data, seg, draw_augment_params(data.shape, cfg, generator,
                                                        data.device), cfg)


def draw_augment_params_3d(shape: Sequence[int], cfg: AugmentConfig,
                           generator: torch.Generator, device=None) -> Dict[str, torch.Tensor]:
    """The draws of ``apply_augment_3d`` for a (B, C, D, H, W) batch: a flip
    flag for each allowed spatial axis (``mirror_<axis>``) and the noise's
    flag, variance and field."""
    B = shape[0]
    g = generator
    p: Dict[str, torch.Tensor] = {}
    for ax in range(3):
        if ax in cfg.mirror_axes:
            p[f"mirror_{ax}"] = torch.rand(B, generator=g, device=device) < cfg.p_mirror
    if cfg.p_noise > 0:
        p["noise_on"] = torch.rand(B, generator=g, device=device) < cfg.p_noise
        p["noise_var"] = _uniform(0.0, cfg.noise_var_max, B, g, device)
        p["noise"] = torch.randn(tuple(shape), generator=g, device=device)
    return p


def apply_augment_3d(data, seg, p: Dict[str, torch.Tensor]):
    """Per sample: flip each spatial axis whose flag is on (data axis 2 + a,
    labels 1 + a), then add ``noise · sqrt(var)`` where the noise is on
    (``ldiffusion_tpu/data/augment.py:540-566``)."""
    for ax in range(3):
        if f"mirror_{ax}" in p:
            on = p[f"mirror_{ax}"]
            data = _sel(on, data.flip(2 + ax), data)
            seg = _sel(on, seg.flip(1 + ax), seg)
    if "noise_on" in p:
        noisy = data + p["noise"].to(data.dtype) * _col(p["noise_var"], data).sqrt()
        data = _sel(p["noise_on"], noisy, data)
    return data, seg


def augment_batch_3d(data, seg, cfg: AugmentConfig = AugmentConfig(),
                     generator: Optional[torch.Generator] = None):
    """The volumes' device stack, mirroring and noise, on (B, C, D, H, W)
    data and (B, D, H, W) labels; rotation and scaling run on the host
    (``HostSpatialAugmenter3D``)."""
    return apply_augment_3d(data, seg, draw_augment_params_3d(data.shape, cfg, generator,
                                                              data.device))
