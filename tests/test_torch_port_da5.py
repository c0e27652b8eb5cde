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
from torch_port_common import jax_draws

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
