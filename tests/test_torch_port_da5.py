"""The DA5 augmentations of the port against the JAX package's, on the CPU in
float32, with fixed draws: this file replays the JAX stack's own draws (the
same key splits and samplers as ``ldiffusion_tpu/data/augment.py:321-530``)
into the port's parameter dict, so ``apply_augment`` must give the batch
``jaug.augment_batch`` gives for that key. The device-side rotation and
scaling (``:214-236,336-347``) are replayed the same way.

Tolerance: 5e-5 absolute on data of O(1)-O(5) (float32 on both sides; the
power and exponential functions and the order of sums differ); labels
exactly. The spatial resample: data 1e-5 absolute (bilinear weights from
the same float32 coordinates), labels exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldiffusion_tpu.data import augment as jaug
from ldiffusion_tpu_torch.data import augment as taug
from ldiffusion_tpu_torch.segmentor.variants import get_variant

TOL = 5e-5
PS = ("p_rot90", "p_transpose", "p_median", "p_noise", "p_blur", "p_brightness",
      "p_contrast", "p_lowres", "p_gamma_invert", "p_gamma", "p_mirror", "p_blank_rect",
      "p_brightness_gradient", "p_local_gamma", "p_sharpen")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file: the suite runs several workers on
    one host, where tiny CPU ops lose more to oversubscribed threads than
    they gain; the previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _da5(**kw):
    """The DA5 recipe's device stack (the spatial part runs on the host)."""
    cfg = dataclasses.replace(get_variant("nnUNetTrainerDA5").augment, p_rotation=0.0,
                              p_scaling=0.0, **kw)
    return cfg, jaug.AugmentConfig(**dataclasses.asdict(cfg))


def _bump(key, h, w):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    sy = jnp.exp(jax.random.uniform(k1, (), minval=jnp.log(max(h / 6.0, 1.0)),
                                    maxval=jnp.log(float(h))))
    sx = jnp.exp(jax.random.uniform(k2, (), minval=jnp.log(max(w / 6.0, 1.0)),
                                    maxval=jnp.log(float(w))))
    my = jax.random.uniform(k3, (), minval=-0.5, maxval=1.5) * h
    mx = jax.random.uniform(k4, (), minval=-0.5, maxval=1.5) * w
    return np.asarray(jnp.stack([sy, sx, my, mx]))


def _draws_one(key, h, w, c, cfg):
    """One sample's draws of ``_augment_one``, in the port's parameter names."""
    r = jax.random
    ks = r.split(key, 16)
    u = np.asarray(r.uniform(ks[0], (12,)))
    ks5 = r.split(ks[13], 12)
    u5 = np.asarray(r.uniform(ks[14], (8,)))
    p = {"noise_on": u[2] < cfg.p_noise,
         "noise_var": r.uniform(ks[3], (), maxval=cfg.noise_var_max),
         "noise": np.asarray(r.normal(ks[4], (h, w, c))).transpose(2, 0, 1),
         "blur_on": u[3] < cfg.p_blur,
         "blur_sigma": r.uniform(ks[5], (), minval=cfg.blur_sigma[0], maxval=cfg.blur_sigma[1]),
         "median_pick": r.bernoulli(ks5[2], 0.5), "median_on": u5[2] < cfg.p_median,
         "median_size": r.randint(ks5[3], (), 0, 3),
         "brightness_on": u[4] < cfg.p_brightness,
         "brightness_shift": np.asarray(r.normal(ks[6], (c,))) * cfg.brightness_additive_sigma
         * np.asarray(r.bernoulli(ks[11], 0.5, (c,))),
         "contrast_on": u[5] < cfg.p_contrast,
         "contrast": r.uniform(ks[7], (), minval=cfg.contrast_range[0],
                               maxval=cfg.contrast_range[1]),
         "contrast_clip": r.bernoulli(ks[12], 0.5),
         "lowres_on": u[6] < cfg.p_lowres, "lowres_factor4": r.uniform(ks[8], ()) < 0.5,
         "gamma_invert_on": u[7] < cfg.p_gamma_invert,
         "gamma_invert": r.uniform(ks[9], (), minval=cfg.gamma_range[0],
                                   maxval=cfg.gamma_range[1]),
         "gamma_on": u[8] < cfg.p_gamma,
         "gamma": r.uniform(ks[10], (), minval=cfg.gamma_range[0], maxval=cfg.gamma_range[1]),
         "mirror_h": u[9] < cfg.p_mirror, "mirror_w": u[10] < cfg.p_mirror,
         "rot90_on": u5[0] < cfg.p_rot90, "rot90_k": r.randint(ks5[0], (), 0, 4),
         "transpose_on": u5[1] < cfg.p_transpose,
         "blank_on": u5[3] < cfg.p_blank_rect, "blank_n": r.randint(ks5[5], (), 1, 6),
         "blank_channels": r.bernoulli(ks5[6], 0.5, (c,)),
         "gradient_on": u5[4] < cfg.p_brightness_gradient, "gradient_bump": _bump(ks5[7], h, w),
         "local_gamma_on": u5[5] < cfg.p_local_gamma, "local_gamma_bump": _bump(ks5[9], h, w),
         "sharpen_on": u5[6] < cfg.p_sharpen,
         "sharpen_strength": r.uniform(ks5[11], (), minval=cfg.sharpen_strength[0],
                                       maxval=cfg.sharpen_strength[1])}
    rects = []
    for slot in r.split(ks5[4], 5):
        k1, k2, k3, k4 = r.split(slot, 4)
        rh = int(r.randint(k1, (), max(1, h // 10), max(2, h // 3 + 1)))
        rw = int(r.randint(k2, (), max(1, w // 10), max(2, w // 3 + 1)))
        rects.append([min(int(r.randint(k3, (), 0, h)), h - rh),
                      min(int(r.randint(k4, (), 0, w)), w - rw), rh, rw])
    p["blank_rects"] = np.asarray(rects)
    km, ksign, kon = r.split(ks5[8], 3)
    p["gradient_strength"] = np.asarray(
        r.uniform(km, (c,), minval=1.0, maxval=5.0)
        * jnp.where(r.bernoulli(ksign, 0.5, (c,)), 1.0, -1.0) * r.bernoulli(kon, 0.5, (c,)))
    kg1, kg2, kpick, kon = r.split(ks5[10], 4)
    p["local_gamma"] = np.asarray(jnp.where(r.bernoulli(kpick, 0.5, (c,)),
                                            r.uniform(kg1, (c,), minval=0.01, maxval=0.8),
                                            r.uniform(kg2, (c,), minval=1.5, maxval=4.0)))
    p["local_gamma_channels"] = r.bernoulli(kon, 0.5, (c,))
    return {k: np.asarray(v) for k, v in p.items()}


def jax_draws(key, shape, cfg):
    """The draws of ``jaug.augment_batch(key, ...)`` for an NHWC ``shape``,
    batched, as the port's parameter dict (the keys ``cfg`` enables)."""
    b, h, w, c = shape
    per = [_draws_one(k, h, w, c, cfg) for k in jax.random.split(key, b)]
    tensors = {k: torch.from_numpy(np.stack([d[k] for d in per])) for k in per[0]}
    want = taug.draw_augment_params((b, c, h, w), cfg, torch.Generator().manual_seed(0))
    missing = set(want) - set(tensors)
    assert not missing, missing
    return {k: tensors[k] for k in want}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("every", [False, True])
def test_da5_stack_with_the_jax_draws(seed, every):
    """The DA5 recipe's probabilities (few transforms fire) and every p at 1
    (all fire, so each one's parameters are held), square patches."""
    kw = dict.fromkeys(PS, 1.0) if every else {}
    cfg, jcfg = _da5(**kw)
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(2, 16, 16, 3)) * 2 + 0.5).astype(np.float32)
    seg = rng.integers(-1, 4, (2, 16, 16)).astype(np.int32)
    key = jax.random.key(seed)
    jd, js = jaug.augment_batch(key, jnp.asarray(data), jnp.asarray(seg), jcfg)
    p = jax_draws(key, data.shape, cfg)
    d, s = taug.apply_augment(_nchw(data), torch.from_numpy(seg), p, cfg)
    np.testing.assert_allclose(d.permute(0, 2, 3, 1).numpy(), np.asarray(jd), atol=TOL, rtol=0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_non_square_patches_skip_rot90_and_transpose():
    cfg, jcfg = _da5(**dict.fromkeys(PS, 1.0))
    rng = np.random.default_rng(7)
    data = rng.normal(size=(2, 16, 24, 3)).astype(np.float32)
    seg = rng.integers(0, 4, (2, 16, 24)).astype(np.int32)
    key = jax.random.key(7)
    jd, js = jaug.augment_batch(key, jnp.asarray(data), jnp.asarray(seg), jcfg)
    p = jax_draws(key, data.shape, cfg)
    assert "rot90_on" not in p and "transpose_on" not in p
    d, s = taug.apply_augment(_nchw(data), torch.from_numpy(seg), p, cfg)
    np.testing.assert_allclose(d.permute(0, 2, 3, 1).numpy(), np.asarray(jd), atol=TOL, rtol=0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("size", [3, 5, 7])
def test_median_filter_and_laplacian_match_jax(size):
    rng = np.random.default_rng(size)
    img = rng.normal(size=(12, 10, 2)).astype(np.float32)
    x = _nchw(img[None])
    np.testing.assert_array_equal(taug.median_filter(x, size)[0].permute(1, 2, 0).numpy(),
                                  np.asarray(jaug._median_filter(jnp.asarray(img), size)))
    np.testing.assert_allclose(taug.laplacian(x)[0].permute(1, 2, 0).numpy(),
                               np.asarray(jaug._laplacian(jnp.asarray(img))), atol=1e-6, rtol=0)


def test_da5_draws_come_from_the_generator():
    cfg, _ = _da5()
    a = taug.draw_augment_params((2, 3, 8, 8), cfg, torch.Generator().manual_seed(1))
    b = taug.draw_augment_params((2, 3, 8, 8), cfg, torch.Generator().manual_seed(1))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert {"rot90_k", "median_size", "brightness_shift", "blank_rects", "gradient_bump",
            "local_gamma", "sharpen_strength"} <= set(a)
    out, _ = taug.augment_batch(torch.randn(2, 3, 8, 8), torch.zeros(2, 8, 8, dtype=torch.long),
                                cfg, torch.Generator().manual_seed(2))
    assert torch.isfinite(out).all()


SPATIAL_TOL = 1e-5
NO_STACK = dict.fromkeys(("p_noise", "p_blur", "p_brightness", "p_contrast", "p_lowres",
                          "p_gamma_invert", "p_gamma", "p_mirror"), 0.0)


def spatial_draws(key, b, cfg):
    """The rotation and scaling draws of ``_augment_one`` for each of ``b``
    samples, in the port's parameter names."""
    rows = []
    for k in jax.random.split(key, b):
        ks = jax.random.split(k, 16)
        u = np.asarray(jax.random.uniform(ks[0], (12,)))
        angle = float(jax.random.uniform(ks[1], (), minval=-cfg.rotation_max,
                                         maxval=cfg.rotation_max))
        scale = float(jax.random.uniform(ks[2], (), minval=cfg.scale_range[0],
                                         maxval=cfg.scale_range[1]))
        rot, sc = u[0] < cfg.p_rotation, u[1] < cfg.p_scaling
        rows.append((rot or sc, angle if rot else 0.0, scale if sc else 1.0))
    on, angle, scale = zip(*rows)
    return {"spatial_on": torch.tensor(on), "angle": torch.tensor(angle, dtype=torch.float32),
            "scale": torch.tensor(scale, dtype=torch.float32)}


@pytest.mark.parametrize("seed,p", [(0, 1.0), (1, 1.0), (2, 0.5), (3, 0.2)])
def test_spatial_branch_with_the_jax_draws(seed, p):
    """Rotation ±180° and scaling 0.7-1.4 about the patch centre on the
    device: bilinear data, nearest labels, 0 outside; where only one of the
    two fires the other stays at 0° or 1x, and a sample with neither is
    untouched."""
    cfg = taug.AugmentConfig(p_rotation=p, p_scaling=p, **NO_STACK)
    jcfg = jaug.AugmentConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(seed)
    data = (rng.normal(size=(6, 20, 16, 2)) * 2 + 1).astype(np.float32)
    seg = rng.integers(0, 5, (6, 20, 16)).astype(np.int32)
    key = jax.random.key(seed)
    jd, js = jaug.augment_batch(key, jnp.asarray(data), jnp.asarray(seg), jcfg)
    drawn = spatial_draws(key, 6, cfg)
    want = taug.draw_augment_params((6, 2, 20, 16), cfg, torch.Generator().manual_seed(0))
    assert {"spatial_on", "angle", "scale"} <= set(want)
    p_all = {**{k: v for k, v in want.items() if k not in drawn}, **drawn}
    d, s = taug.apply_augment(_nchw(data), torch.from_numpy(seg), p_all, cfg)
    np.testing.assert_allclose(d.permute(0, 2, 3, 1).numpy(), np.asarray(jd),
                               atol=SPATIAL_TOL, rtol=0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    off = ~drawn["spatial_on"].numpy()
    np.testing.assert_array_equal(d.permute(0, 2, 3, 1).numpy()[off], data[off])


def test_map_coordinates_rounds_half_away_from_zero_like_jax():
    """Order 0 at half-way coordinates (the ties jax.scipy's ``lax.round``
    sends away from zero), order 1 between pixels, and taps outside."""
    img = np.arange(1, 31, dtype=np.float32).reshape(5, 6)
    ys = np.array([[-0.5, 0.5, 1.5, 2.5, 3.5, 4.49, 4.5, -0.51]], np.float32)
    xs = np.array([[0.5, 1.5, 2.5, 3.5, 4.5, 5.5, -0.5, 2.0]], np.float32)
    for order in (0, 1):
        want = jax.scipy.ndimage.map_coordinates(jnp.asarray(img), [ys, xs], order=order,
                                                 mode="constant", cval=0.0)
        got = taug.map_coordinates(torch.from_numpy(img)[None, None],
                                   torch.from_numpy(ys), torch.from_numpy(xs), order)
        np.testing.assert_array_equal(got[0, 0].numpy(), np.asarray(want)[0])
    sy, sx = taug.affine_coords(7, 6, torch.zeros(1), torch.ones(1))
    yy, xx = np.meshgrid(np.arange(7), np.arange(6), indexing="ij")
    assert np.array_equal(sy[0].numpy(), yy) and np.array_equal(sx[0].numpy(), xx)
