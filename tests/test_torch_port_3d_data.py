"""The 3D input pipeline of the port against the JAX package's, on the CPU at
tiny sizes: the native 3D crop, the native 3D Euler affine (trilinear and
nearest, with and without the centred output window), the patch sampler on
volumes (positional and probabilistic foreground oversampling), the 3D
spatial-DA configuration (initial patch, dummy-2D rule, rotation bounds),
``HostSpatialAugmenter3D`` (3D and dummy-2D) and ``augment_batch_3d`` (the
device mirroring and noise) with the JAX package's draws fed to the port.

Tolerances:
- crop, sampler batches, labels of every transform, the spatial-DA plan:
  equal;
- the affine's data against the JAX library and both numpy versions, and
  the host augmenter: <= 1e-5 absolute (float32 outputs of the same float64
  arithmetic; found equal);
- ``augment_batch_3d`` with fixed draws: <= 5e-5 absolute (noise scaled in
  float32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldiffusion_tpu import native as jnative
from ldiffusion_tpu.data import augment as jaug
from ldiffusion_tpu.data.patches import PatchSampler as JSampler
from ldiffusion_tpu.segmentor.preprocess import PreprocessedCase as JCase
from ldiffusion_tpu.segmentor.preprocess import PreprocessedDataset as JDataset
from ldiffusion_tpu_torch import native as tnative
from ldiffusion_tpu_torch.data import augment as taug
from ldiffusion_tpu_torch.data.patches import PatchSampler
from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedCase, PreprocessedDataset
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

AFFINE_TOL = 1e-5
DEVICE_DA_TOL = 5e-5


def _cases(rng, n=3, shape=(10, 14, 12), channels=2):
    out = []
    for _ in range(n):
        data = rng.normal(size=shape + (channels,)).astype(np.float32)
        seg = rng.integers(0, 3, shape).astype(np.int16)
        out.append((data, seg))
    return out


def test_native_3d_crop_equals_jax_and_numpy():
    rng = np.random.default_rng(0)
    cases = _cases(rng, n=4)
    lbs = np.array([[-3, 2, -1], [0, 0, 0], [6, 9, 8], [-20, -20, -20]])
    tnative.reset_routes()
    got = tnative.crop_with_pad_batch_native(cases, lbs, (8, 9, 7))
    want = jnative.crop_with_pad_batch_native(cases, lbs, (8, 9, 7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for b, (d, s) in enumerate(cases):
        od, os_ = tnative.crop_with_pad_numpy(d, s, lbs[b], (8, 9, 7))
        np.testing.assert_array_equal(got[0][b], od)
        np.testing.assert_array_equal(got[1][b], os_)
    assert got[1][3].min() == -1 and not got[0][3].any()  # wholly outside: all padding
    assert tnative.launches_by_route["crop_with_pad_batch_3d"] == {"native": 1, "numpy": 0}
    assert tnative.launches_by_route["crop_with_pad_batch"]["native"] == 0
    with pytest.raises(ValueError, match="rank"):
        tnative.crop_with_pad_batch_native(cases, lbs, (8, 9, 7, 2))


@pytest.mark.parametrize("data_order", [1, 0])
@pytest.mark.parametrize("out_size", [None, (7, 10, 8)])
def test_native_3d_affine_equals_jax_native_and_numpy(data_order, out_size):
    rng = np.random.default_rng(1)
    B = 3
    data = rng.normal(size=(B, 9, 13, 11, 2)).astype(np.float32)
    seg = rng.integers(0, 4, (B, 9, 13, 11)).astype(np.int16)
    ax, ay, az = (rng.uniform(-0.6, 0.6, B) for _ in range(3))
    scales = rng.uniform(0.7, 1.4, B)
    apply = np.array([1, 0, 1], np.uint8)
    tnative.reset_routes()
    got = tnative.affine_augment_batch_3d_native(data, seg, ax, ay, az, scales, apply,
                                                 data_order=data_order, out_size=out_size)
    oracle = tnative.affine_augment_batch_3d_numpy(data, seg, ax, ay, az, scales, apply,
                                                   data_order=data_order, out_size=out_size)
    j_native = jnative.affine_augment_batch_3d_native(
        data, seg, ax, ay, az, scales, apply, data_order=data_order, out_size=out_size)
    j_numpy = jnative.affine_augment_batch_3d_numpy(
        data, seg, ax, ay, az, scales, apply, data_order=data_order, out_size=out_size)
    for other in (oracle, j_native, j_numpy):
        assert np.abs(got[0] - other[0]).max() <= AFFINE_TOL
        np.testing.assert_array_equal(got[1], other[1])
    assert got[0].shape[1:4] == (out_size or (9, 13, 11))
    assert tnative.launches_by_route["affine_augment_batch_3d"] == {"native": 1, "numpy": 1}


def _datasets(rng):
    cases = _cases(rng, n=3, shape=(12, 16, 14), channels=1)
    t, j = PreprocessedDataset(), JDataset()
    for i, (d, s) in enumerate(cases):
        s = np.where(s == 2, 0, s).astype(np.int16)
        locs = {1: np.argwhere(s == 1).astype(np.int32)}
        props = {"class_locations": locs}
        t.cases[f"c{i}"] = PreprocessedCase(data=d, seg=s, properties=props)
        j.cases[f"c{i}"] = JCase(data=d, seg=s, properties=props)
    return t, j


@pytest.mark.parametrize("probabilistic", [False, True])
def test_3d_sampler_batches_equal_jax(probabilistic):
    t_ds, j_ds = _datasets(np.random.default_rng(2))
    kw = dict(oversample_fg=0.5, seed=3, probabilistic_oversampling=probabilistic)
    t_it = iter(PatchSampler(t_ds, (8, 20, 10), 3, **kw))
    j_it = iter(JSampler(j_ds, (8, 20, 10), 3, **kw))
    for _ in range(4):
        (td, ts), (jd, js) = next(t_it), next(j_it)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ts, js)
        assert td.shape == (3, 8, 20, 10, 1) and ts.min() == -1  # 20 > 16: padded


@pytest.mark.parametrize("patch", [(80, 128, 128), (112, 96, 96), (16, 160, 128),
                                   (32, 32, 32), (24, 28)])
@pytest.mark.parametrize("scale", [None, (0.7, 1.43)])
def test_spatial_da_plan_equals_jax(patch, scale):
    got = taug.configure_spatial_da(patch, scale)
    want = jaug.configure_spatial_da(patch, scale)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.do_dummy_2d == (len(patch) == 3 and max(patch) / patch[0] > 3)
    rot = (0.3, (0.1, -0.5), 0.2)
    assert taug.get_initial_patch_size(patch, *rot, (0.8, 1.2)) == \
        jaug.get_initial_patch_size(patch, *rot, (0.8, 1.2))


@pytest.mark.parametrize("dummy_2d", [False, True])
def test_host_spatial_augmenter_3d_equals_jax(dummy_2d):
    rng = np.random.default_rng(4)
    cfg = taug.AugmentConfig(p_rotation=0.7, p_scaling=0.6)
    jcfg = jaug.AugmentConfig(p_rotation=0.7, p_scaling=0.6)
    out = (6, 10, 9)
    data = rng.normal(size=(4, 6, 15, 13, 2)).astype(np.float32)
    seg = rng.integers(-1, 3, (4, 6, 15, 13)).astype(np.int32)
    t = taug.HostSpatialAugmenter3D(cfg, seed=5, out_size=out, dummy_2d=dummy_2d)
    j = jaug.HostSpatialAugmenter3D(jcfg, seed=5, out_size=out, dummy_2d=dummy_2d)
    tnative.reset_routes()
    for _ in range(3):
        (td, ts), (jd, js) = t(data, seg), j(data, seg)
        assert td.shape == (4, *out, 2) and ts.dtype == seg.dtype
        assert np.abs(td - jd).max() <= AFFINE_TOL
        np.testing.assert_array_equal(ts, js)
    route = "affine_augment_batch" if dummy_2d else "affine_augment_batch_3d"
    assert tnative.launches_by_route[route]["native"] > 0
    # fixed draws through ``apply``: the numpy oracle of the same transform
    draws = taug.HostSpatialAugmenter3D(cfg, seed=6, dummy_2d=dummy_2d).draw(4)
    apply, scales, angles = draws
    d16 = np.ascontiguousarray(seg, np.int16)
    if dummy_2d:
        return
    td, ts = t.apply(data, seg, apply, scales, angles)
    od, os_ = tnative.affine_augment_batch_3d_numpy(data, d16, *angles, scales, apply,
                                                    out_size=out)
    assert np.abs(td - od).max() <= AFFINE_TOL
    np.testing.assert_array_equal(ts, os_)


def _jax_3d_draws(key, shape, cfg):
    """What ``ldiffusion_tpu.data.augment.augment_batch_3d`` draws from ``key``
    for a (B, Z, H, W, C) batch (the same splits), as the port's parameters
    of a (B, C, Z, H, W) batch."""
    p = {f"mirror_{ax}": [] for ax in cfg.mirror_axes}
    p.update(noise_on=[], noise_var=[], noise=[])
    for k in jax.random.split(key, shape[0]):
        ks = jax.random.split(k, 5)
        for ax in cfg.mirror_axes:
            p[f"mirror_{ax}"].append(bool(jax.random.bernoulli(ks[ax], cfg.p_mirror)))
        ks2 = jax.random.split(ks[3], 3)
        p["noise_on"].append(bool(jax.random.bernoulli(ks2[0], cfg.p_noise)))
        p["noise_var"].append(float(jax.random.uniform(ks2[1], (), minval=0.0,
                                                       maxval=cfg.noise_var_max)))
        p["noise"].append(np.moveaxis(np.asarray(jax.random.normal(ks2[2], shape[1:])), -1, 0))
    return {k: torch.tensor(np.asarray(v)) for k, v in p.items()}


@pytest.mark.parametrize("mirror_axes", [(0, 1, 2), (0, 1)])
def test_augment_batch_3d_with_jax_draws(mirror_axes):
    rng = np.random.default_rng(7)
    data = rng.normal(size=(6, 4, 6, 5, 2)).astype(np.float32)
    seg = rng.integers(0, 3, (6, 4, 6, 5)).astype(np.int32)
    jcfg = jaug.AugmentConfig(p_noise=0.5, p_mirror=0.5, mirror_axes=mirror_axes)
    cfg = taug.AugmentConfig(p_noise=0.5, p_mirror=0.5, mirror_axes=mirror_axes)
    key = jax.random.key(8)
    jd, js = jaug.augment_batch_3d(key, jnp.asarray(data), jnp.asarray(seg), jcfg)
    drawn = _jax_3d_draws(key, data.shape, jcfg)
    assert any(drawn["noise_on"]) and not all(drawn["noise_on"])
    td, ts = taug.apply_augment_3d(torch.from_numpy(data).movedim(-1, 1),
                                   torch.from_numpy(seg), drawn)
    assert float(np.abs(td.movedim(1, -1).numpy() - np.asarray(jd)).max()) <= DEVICE_DA_TOL
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the port's own draws: the same keys on every call of a seeded generator
    g = torch.Generator().manual_seed(0)
    p = taug.draw_augment_params_3d((6, 2, 4, 6, 5), cfg, g)
    assert {f"mirror_{a}" for a in mirror_axes} | {"noise_on", "noise_var", "noise"} == set(p)
    out, _ = taug.augment_batch_3d(torch.from_numpy(data).movedim(-1, 1), torch.from_numpy(seg),
                                   cfg, torch.Generator().manual_seed(0))
    ref, _ = taug.apply_augment_3d(torch.from_numpy(data).movedim(-1, 1), torch.from_numpy(seg), p)
    assert torch.equal(out, ref)
