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

Each transform's random draws are split from its application:
``draw_augment_params`` draws every per-sample parameter from an explicit
``torch.Generator`` (on the batch's device, so a step needs no host sync)
and ``apply_augment`` applies them, so a test can fix the parameters. As in
the JAX package, a transform whose p is 0 is skipped, and an enabled one is
computed for the whole batch and selected per sample.

Layout: data (B, C, H, W) float32, seg (B, H, W) int. The DA5 transforms
(rot90/transpose, median, blank rectangles, brightness gradient, local gamma,
sharpening, additive brightness, the clipped contrast and the second
inverted gamma), device-side rotation/scaling and 3D raise
``NotImplementedError`` when enabled (ROADMAP queue 1, *Long tail*).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ldiffusion_tpu_torch.native import affine_augment_batch_native


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
    # the DA5 modes and transforms (not ported: raise when enabled)
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


_DA5 = ("brightness_additive_sigma", "contrast_clip_half", "gamma2_invert", "p_rot90",
        "p_transpose", "p_median", "p_blank_rect", "p_brightness_gradient", "p_local_gamma",
        "p_sharpen")


def check_supported(cfg: AugmentConfig) -> None:
    on = [name for name in _DA5 if getattr(cfg, name)]
    if on:
        raise NotImplementedError(f"the DA5 augmentations {on} are not ported yet "
                                  "(ROADMAP queue 1, *Long tail*)")


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
    the final patch's corners, 2D (reference
    ``compute_initial_patch_size.py:get_patch_size``): the extent vector
    rotated by the largest angle, the componentwise max, over the least
    scale."""
    del rot_y, rot_z  # 2D rotates about one axis only

    def _max_abs(r):
        if isinstance(r, (tuple, list)):
            r = max(abs(float(v)) for v in r)
        return min(np.pi / 2, abs(float(r)))

    coords = np.asarray(final_patch_size, np.float64)
    if len(coords) != 2:
        raise NotImplementedError("3D spatial augmentation is not ported yet "
                                  "(ROADMAP queue 1, *Long tail*)")
    rx = _max_abs(rot_x)
    c, s = np.cos(rx), np.sin(rx)
    final = np.maximum(coords, np.abs(coords @ np.array([[c, -s], [s, c]])))
    final = final / min(scale_range)
    return tuple(int(v) for v in final)


def configure_spatial_da(patch_size, initial_scale_range=None) -> SpatialDAPlan:
    """2D: aspect > 1.5 → rotation ±15°, else ±180°; mirror axes (0, 1); the
    initial patch from the legacy (0.85, 1.25) scale range unless given."""
    patch_size = tuple(int(p) for p in patch_size)
    if len(patch_size) != 2:
        raise NotImplementedError("3D spatial augmentation is not ported yet "
                                  "(ROADMAP queue 1, *Long tail*)")
    scale = tuple(initial_scale_range or (0.85, 1.25))
    rot = np.pi / 12 if max(patch_size) / min(patch_size) > 1.5 else np.pi
    rotation = (rot, 0.0, 0.0)
    initial = get_initial_patch_size(patch_size, *rotation, scale)
    return SpatialDAPlan(rotation_max=rotation, do_dummy_2d=False,
                         initial_patch_size=initial, mirror_axes=(0, 1))


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
    thread (``ldiffusion_tpu/data/augment.py:568-635``), bilinear data and
    nearest labels (the nearest-data variant is not ported). numpy draws from
    ``default_rng(seed)``, as the JAX package's. ``out_size``: the final
    patch; inputs are then initial-size patches and only the centred window
    is computed. Returns (data (B, *out, C) float32, seg (B, *out) of seg's
    dtype)."""

    def __init__(self, cfg: AugmentConfig, seed: int = 0, out_size=None):
        self.cfg = cfg
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
            angles, scales, apply, out_size=self.out_size)
        return d, s.astype(seg.dtype)


# ---------------------------------------------------------------------------
# device stack
# ---------------------------------------------------------------------------

def _uniform(lo, hi, n, generator, device):
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


def apply_augment(data, seg, p: Dict[str, torch.Tensor], cfg: AugmentConfig):
    """Apply drawn parameters in the JAX stack's order: noise, blur,
    brightness, contrast, low resolution, inverted gamma, gamma, mirroring."""
    h, w = data.shape[-2:]
    if "noise_on" in p:
        data = _sel(p["noise_on"], data + p["noise"] * _col(p["noise_var"], data).sqrt(), data)
    if "blur_on" in p:
        data = _sel(p["blur_on"], blur(data, p["blur_sigma"]), data)
    if "brightness_on" in p:
        data = _sel(p["brightness_on"], data * _col(p["brightness"], data), data)
    if "contrast_on" in p:
        data = _sel(p["contrast_on"], contrast(data, p["contrast"]), data)
    if "lowres_on" in p and h % 4 == 0 and w % 4 == 0:
        low = _sel(p["lowres_factor4"], lowres(data, 4), lowres(data, 2))
        data = _sel(p["lowres_on"], low, data)
    if "gamma_invert_on" in p:
        data = _sel(p["gamma_invert_on"], gamma(data, p["gamma_invert"], True), data)
    if "gamma_on" in p:
        data = _sel(p["gamma_on"], gamma(data, p["gamma"], False), data)
    if "mirror_h" in p:
        data = _sel(p["mirror_h"], data.flip(2), data)
        seg = _sel(p["mirror_h"], seg.flip(1), seg)
    if "mirror_w" in p:
        data = _sel(p["mirror_w"], data.flip(3), data)
        seg = _sel(p["mirror_w"], seg.flip(2), seg)
    return data, seg


def augment_batch(data, seg, cfg: AugmentConfig = AugmentConfig(),
                  generator: Optional[torch.Generator] = None):
    """The device stack on (B, C, H, W) data and (B, H, W) labels; the
    spatial transform runs on the host (``HostSpatialAugmenter``)."""
    check_supported(cfg)
    if cfg.p_rotation > 0 or cfg.p_scaling > 0:
        raise NotImplementedError("device-side rotation/scaling is not ported; the "
                                  "trainer runs them on the host (HostSpatialAugmenter)")
    return apply_augment(data, seg, draw_augment_params(data.shape, cfg, generator,
                                                        data.device), cfg)
