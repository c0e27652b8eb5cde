"""Stage-2 data path of the port against the JAX package's, on the CPU:
fingerprint, plan, splits, ``dataset.json``, preprocessing, the patch
sampler, the host C++ (crop and 2D affine) and the device augmentation.

Tolerances:
- fingerprint, plan, splits, ``dataset.json``, the preprocessed store, the
  sampler's batches, the native library and the host spatial augmenter: equal
  (``plans.json`` and ``splits_final.json`` byte for byte; the same numpy
  generators, the same C++ arithmetic);
- z-score: 1e-6 absolute (float32 of the same float64 statistics);
- the native affine against its numpy oracle: 1e-5 (``tests/test_native.py``);
- each device transform with its parameters fixed: 1e-5 absolute against the
  JAX function; the whole ``augment_batch`` with every p at 0 or 1 and
  zero-width ranges: 5e-5 (float32, other summation orders: the low-res
  pooling, the gamma's ``pow``).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import ldiffusion_tpu.native as jnative
from ldiffusion_tpu.data import augment as jaug
from ldiffusion_tpu.data.patches import PatchSampler as JSampler
from ldiffusion_tpu.data.patches import downsample_seg_for_ds as j_ds_targets
from ldiffusion_tpu.segmentor import dataset_builder as jbuild
from ldiffusion_tpu.segmentor import fingerprint as jfp
from ldiffusion_tpu.segmentor import planner as jplan
from ldiffusion_tpu.segmentor import preprocess as jpre
from ldiffusion_tpu.segmentor import splits as jsplits
from ldiffusion_tpu_torch import native as tnative
from ldiffusion_tpu_torch.data import augment as taug
from ldiffusion_tpu_torch.data.patches import PatchSampler as TSampler
from ldiffusion_tpu_torch.data.patches import downsample_seg_for_ds as t_ds_targets
from ldiffusion_tpu_torch.segmentor import dataset_builder as tbuild
from ldiffusion_tpu_torch.segmentor import fingerprint as tfp
from ldiffusion_tpu_torch.segmentor import planner as tplan
from ldiffusion_tpu_torch.segmentor import preprocess as tpre
from ldiffusion_tpu_torch.segmentor import splits as tsplits
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)


def _cases(n=4, size=48, seed=0, classes=4):
    """Smooth synthetic RGB cases in [0, 1] (a zero border on the first, so
    the crop to nonzero is exercised) and blocky labels."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for i in range(n):
        coarse = rng.random((size // 8, size // 8, 3)).astype(np.float32)
        img = np.kron(coarse, np.ones((8, 8, 1), np.float32))
        img += 0.05 * rng.normal(size=img.shape).astype(np.float32)
        if i == 0:
            img[:3] = 0.0
        lab = np.kron(rng.integers(0, classes, (size // 8, size // 8)),
                      np.ones((8, 8), np.int64)).astype(np.int32)
        images.append(img.astype(np.float32))
        labels.append(lab)
    return images, labels


# ---------------------------------------------------------------------------
# fingerprint, plan, splits, dataset.json
# ---------------------------------------------------------------------------

def test_fingerprint_and_integrity_match_jax():
    images, labels = _cases()
    assert tfp.extract_fingerprint(images, labels) == jfp.extract_fingerprint(images, labels)
    assert tfp.crop_to_nonzero_bbox(images[0]) == jfp.crop_to_nonzero_bbox(images[0])
    bad = [labels[0] + 9, labels[1][:-1]]
    assert tfp.verify_dataset_integrity(images[:2], bad, 4) == \
        jfp.verify_dataset_integrity(images[:2], bad, 4)
    assert tfp.verify_dataset_integrity(images, labels, 4) == []


@pytest.mark.parametrize("shapes,classes", [
    ([[48, 48]] * 4, 4),               # a tiny plan
    ([[45, 61], [64, 40], [52, 52]], 3),  # ragged shapes
    ([[1024, 1024]] * 4, 7),           # chip_smoke.py's FULL_PLAN
    ([[2048, 1536]] * 3, 7),           # shrunk to the activation budget
])
def test_plan_json_is_byte_equal(tmp_path, shapes, classes):
    fp = {"shapes_after_crop": shapes, "num_channels": 3,
          "foreground_intensity_properties_per_channel": {"0": {"mean": 0.5}}}
    tp, jp = tplan.plan_experiment(fp, classes), jplan.plan_experiment(fp, classes)
    tp.save(str(tmp_path / "t" / "plans.json"))
    jp.save(str(tmp_path / "j" / "plans.json"))
    assert (tmp_path / "t" / "plans.json").read_bytes() == \
        (tmp_path / "j" / "plans.json").read_bytes()
    assert tplan.SegPlan.load(str(tmp_path / "j" / "plans.json")) == tp
    if shapes[0] == [1024, 1024]:
        assert (tp.patch_size, tp.batch_size, len(tp.features_per_stage)) == \
            ((1024, 1024), 2, 7)
        assert tp.features_per_stage == (32, 64, 128, 256, 512, 512, 512)


def test_planner_variants_raise_naming_the_roadmap():
    """The residual-encoder planner, which raised before it was ported, now
    plans (``test_torch_port_seg_nets`` holds it against JAX); a name that
    is neither planner raises."""
    fp = {"shapes_after_crop": [[64, 64]], "num_channels": 3}
    assert tplan.plan_experiment(fp, 3, planner="resenc").block_type == "residual"
    with pytest.raises(ValueError, match="planner"):
        tplan.plan_experiment(fp, 3, planner="nnUNetPlannerResEncM")


@pytest.mark.parametrize("n", [1, 4, 7, 12])
def test_splits_final_json_is_byte_equal(tmp_path, n):
    keys = [f"case_{i:03d}" for i in range(n)]
    tr, va = tsplits.do_split(keys, 0, str(tmp_path / "t" / "splits_final.json"))
    jtr, jva = jsplits.do_split(keys, 0, str(tmp_path / "j" / "splits_final.json"))
    assert (tr, va) == (jtr, jva)
    assert (tmp_path / "t" / "splits_final.json").read_bytes() == \
        (tmp_path / "j" / "splits_final.json").read_bytes()
    # a fold beyond the file's: the seeded 80:20 fallback
    assert tsplits.do_split(keys, 9, str(tmp_path / "t" / "splits_final.json"),
                            log=lambda *a: None) == \
        jsplits.do_split(keys, 9, str(tmp_path / "j" / "splits_final.json"),
                         log=lambda *a: None)
    assert tsplits.do_split(keys, "all", "unused") == (keys, keys)


def test_dataset_dir_without_transform_matches_jax(tmp_path):
    """The raw-copy route (mixed sizes) of ``build_transformed_dataset``:
    images, labels and ``dataset.json`` byte-equal to the JAX package's."""
    rng = np.random.default_rng(3)
    src = tmp_path / "src"
    src.mkdir()
    codes = np.array([0, 100, 150, 50, 200, 250, 255], np.uint8)
    paths = []
    for i, size in enumerate([(40, 40), (40, 48), (40, 40)]):
        ip, lp = src / f"i{i}.png", src / f"l{i}.png"
        Image.fromarray((rng.random(size + (3,)) * 255).astype(np.uint8)).save(ip)
        Image.fromarray(codes[rng.integers(0, 7, size)]).save(lp)
        paths.append((str(ip), str(lp)))
    args = ([p[0] for p in paths[:2]], [p[1] for p in paths[:2]],
            [paths[2][0]], [paths[2][1]], 7, "tissue")
    tn, tdir = tbuild.build_transformed_dataset(*args, object(), str(tmp_path / "t"),
                                                image_size=32)
    jn, jdir = jbuild.build_transformed_dataset(*args, object(), str(tmp_path / "j"),
                                                image_size=32)
    assert tn == jn == 1 and os.path.basename(tdir) == os.path.basename(jdir)
    for root, _, files in os.walk(jdir):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), jdir)
            assert open(os.path.join(tdir, rel), "rb").read() == \
                open(os.path.join(jdir, rel), "rb").read(), rel
    assert tbuild.next_dataset_dir(str(tmp_path / "t"))[0] == 2
    ti, tl = tbuild.load_transformed_dataset(tdir, "Tr")
    ji, jl = jbuild.load_transformed_dataset(jdir, "Tr")
    for a, b in zip(ti + tl, ji + jl):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# preprocessing
# ---------------------------------------------------------------------------

def test_preprocess_and_store_round_trip(tmp_path):
    images, labels = _cases()
    np.testing.assert_allclose(tpre.zscore_normalize(images[1]),
                               jpre.zscore_normalize(images[1]), atol=1e-6, rtol=0)
    locs = tpre.sample_fg_locations(labels[1], 4, per_class=20)
    jlocs = jpre.sample_fg_locations(labels[1], 4, per_class=20)
    assert locs.keys() == jlocs.keys()
    for k in locs:
        np.testing.assert_array_equal(locs[k], jlocs[k])
    ds = tpre.PreprocessedDataset.build(images, labels, 4, directory=str(tmp_path / "t"))
    jds = jpre.PreprocessedDataset.build(images, labels, 4, directory=str(tmp_path / "j"))
    assert ds.keys() == jds.keys()
    for store in (ds, tpre.PreprocessedDataset.load(str(tmp_path / "t")),
                  tpre.PreprocessedDataset.load(str(tmp_path / "j"))):
        for k in jds.keys():
            a, b = store[k], jds[k]
            np.testing.assert_allclose(a.data, b.data, atol=1e-6, rtol=0)
            np.testing.assert_array_equal(a.seg, b.seg)
            assert a.seg.dtype == np.int16 and a.data.dtype == np.float32
            assert a.properties["bbox"] == b.properties["bbox"]
            for c in b.properties["class_locations"]:
                np.testing.assert_array_equal(a.properties["class_locations"][c],
                                              b.properties["class_locations"][c])
    assert ds["case_000"].properties["bbox"] == [[3, 48], [0, 48]]
    sub = ds.subset(["case_002", "case_000"])
    assert sub.keys() == ["case_002", "case_000"] and len(sub) == 2
    with pytest.raises(KeyError):
        ds.subset(["nope"])


# ---------------------------------------------------------------------------
# sampler and the host C++
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("native", [True, False])
def test_patch_sampler_batches_are_bit_equal(native, monkeypatch):
    images, labels = _cases(n=3, size=40)
    ds = tpre.PreprocessedDataset.build(images, labels, 4)
    jds = jpre.PreprocessedDataset.build(images, labels, 4)
    if not native:  # the JAX sampler's numpy route
        monkeypatch.setattr(jnative, "crop_with_pad_batch_native", lambda *a, **k: None)
    tnative.reset_routes()
    port = iter(TSampler(ds, (56, 32), 3, 0.5, seed=7, use_native=native))
    ref = iter(JSampler(jds, (56, 32), 3, 0.5, seed=7))
    for _ in range(5):
        (d, s), (jd, js) = next(port), next(ref)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_allclose(d, jd, atol=1e-6, rtol=0)  # the z-scored data
        assert s.dtype == np.int32 and d.shape == (3, 56, 32, 3) and (s == -1).any()
        for a, b in zip(t_ds_targets(s, (1, 2, 2)), j_ds_targets(js, (1, 2, 2))):
            np.testing.assert_array_equal(a, b)
    route = "native" if native else "numpy"
    assert tnative.launches_by_route["crop_with_pad_batch"][route] == 5


def test_native_crop_is_bit_equal_to_jax_and_numpy():
    rng = np.random.default_rng(1)
    cases = [(rng.normal(size=(30 + 5 * i, 27, 3)).astype(np.float32),
              rng.integers(0, 5, (30 + 5 * i, 27)).astype(np.int16)) for i in range(4)]
    lbs = np.array([[-5, -3], [0, 0], [20, 10], [-10, 15]], np.int64)
    out = tnative.crop_with_pad_batch_native(cases, lbs, (24, 20))
    ref = jnative.crop_with_pad_batch_native(cases, lbs, (24, 20))
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    for b, ((d, s), lb) in enumerate(zip(cases, lbs)):
        od, os_ = tnative.crop_with_pad_numpy(d, s, lb, (24, 20))
        np.testing.assert_array_equal(out[0][b], od)
        np.testing.assert_array_equal(out[1][b], os_)
    with pytest.raises(ValueError):
        tnative.crop_with_pad_batch_native([(cases[0][0][:, ::2], cases[0][1])], lbs[:1],
                                           (8, 8))


@pytest.mark.parametrize("data_order,out_size", [(1, None), (0, None), (1, (40, 36))])
def test_native_affine_is_bit_equal_to_jax_and_near_numpy(data_order, out_size):
    rng = np.random.default_rng(2)
    data = rng.normal(size=(4, 48, 44, 3)).astype(np.float32)
    seg = rng.integers(0, 7, (4, 48, 44)).astype(np.int16)
    angles = np.array([0.3, -2.5, 0.0, 1.2])
    scales = np.array([1.2, 0.8, 1.0, 1.0])
    apply = np.array([True, True, False, True])
    kw = dict(data_order=data_order, out_size=out_size)
    out = tnative.affine_augment_batch_native(data, seg, angles, scales, apply, **kw)
    ref = jnative.affine_augment_batch_native(data, seg, angles, scales, apply, **kw)
    oracle = tnative.affine_augment_batch_numpy(data, seg, angles, scales, apply, **kw)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out[0], oracle[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out[1], oracle[1])


def test_host_spatial_augmenter_matches_jax():
    cfg = taug.AugmentConfig(p_rotation=0.6, p_scaling=0.6)
    jcfg = jaug.AugmentConfig(p_rotation=0.6, p_scaling=0.6)
    plan, jplan_ = taug.configure_spatial_da((32, 32)), jaug.configure_spatial_da((32, 32))
    for shape in ((32, 32), (64, 20)):
        a, b = taug.configure_spatial_da(shape), jaug.configure_spatial_da(shape)
        assert (a.rotation_max, a.do_dummy_2d, a.initial_patch_size, a.mirror_axes) == \
            (b.rotation_max, b.do_dummy_2d, b.initial_patch_size, b.mirror_axes)
    aug = taug.HostSpatialAugmenter(cfg, seed=4, out_size=(32, 32))
    jaug_ = jaug.HostSpatialAugmenter(jcfg, seed=4, out_size=(32, 32))
    rng = np.random.default_rng(0)
    for _ in range(4):
        data = rng.normal(size=(2,) + plan.initial_patch_size + (3,)).astype(np.float32)
        seg = rng.integers(-1, 4, (2,) + plan.initial_patch_size).astype(np.int32)
        (d, s), (jd, js) = aug(data, seg), jaug_(data, seg)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(s, js)
        assert d.shape == (2, 32, 32, 3) and s.dtype == np.int32


# ---------------------------------------------------------------------------
# device augmentation
# ---------------------------------------------------------------------------

def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def test_each_device_transform_matches_jax():
    rng = np.random.default_rng(4)
    data = rng.normal(size=(2, 16, 20, 3)).astype(np.float32)
    x = _nchw(data)
    sig = np.array([0.5, 0.93], np.float32)
    np.testing.assert_allclose(
        _nhwc(taug.blur(x, torch.from_numpy(sig))),
        np.stack([np.asarray(jaug._blur(jnp.asarray(d), s)) for d, s in zip(data, sig)]),
        atol=1e-5, rtol=0)
    g = np.array([0.7, 1.43], np.float32)
    for invert in (False, True):
        np.testing.assert_allclose(
            _nhwc(taug.gamma(x, torch.from_numpy(g), invert)),
            np.stack([np.asarray(jaug._gamma(jnp.asarray(d), gg, invert))
                      for d, gg in zip(data, g)]), atol=1e-5, rtol=0)
    c = np.array([0.8, 1.2], np.float32)
    want = [(d - d.mean((0, 1), keepdims=True)) * cc + d.mean((0, 1), keepdims=True)
            for d, cc in zip(data, c)]
    np.testing.assert_allclose(_nhwc(taug.contrast(x, torch.from_numpy(c))), np.stack(want),
                               atol=1e-5, rtol=0)
    # the low-res path and the mirrors, through the JAX stack with only them on
    off = dict(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
               p_contrast=0.0, p_gamma_invert=0.0, p_gamma=0.0)
    seg = rng.integers(0, 4, (2, 16, 20)).astype(np.int32)
    jd, _ = jaug.augment_batch(jax.random.key(0), jnp.asarray(data), jnp.asarray(seg),
                               jaug.AugmentConfig(**off, p_lowres=1.0, p_mirror=0.0))
    # JAX draws each sample's factor: each must be the port's 2× or 4× pooling
    for b in range(2):
        errs = [float(np.abs(_nhwc(taug.lowres(x[b:b + 1], f))[0] - np.asarray(jd[b])).max())
                for f in (2, 4)]
        assert min(errs) <= 1e-5, errs
    jd, js = jaug.augment_batch(jax.random.key(0), jnp.asarray(data), jnp.asarray(seg),
                                jaug.AugmentConfig(**off, p_lowres=0.0, p_mirror=1.0))
    p = {"mirror_h": torch.tensor([True, True]), "mirror_w": torch.tensor([True, True])}
    d, s = taug.apply_augment(x, torch.from_numpy(seg), p, taug.AugmentConfig())
    np.testing.assert_array_equal(_nhwc(d), np.asarray(jd))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("on", [0.0, 1.0])
def test_whole_augment_batch_with_fixed_draws_matches_jax(on):
    """Every p at 0 or 1 and every range of zero width: no draw matters, so
    both stacks must give the same batch."""
    rng = np.random.default_rng(5)
    data = (rng.normal(size=(2, 16, 16, 3)) * 2 + 1).astype(np.float32)
    seg = rng.integers(-1, 4, (2, 16, 16)).astype(np.int32)
    kw = dict(p_rotation=0.0, p_scaling=0.0, p_noise=on, noise_var_max=0.0, p_blur=on,
              blur_sigma=(0.75, 0.75), p_brightness=on, brightness_range=(1.1, 1.1),
              p_contrast=on, contrast_range=(0.9, 0.9), p_lowres=0.0, p_gamma_invert=on,
              p_gamma=on, gamma_range=(1.3, 1.3), p_mirror=on)
    jd, js = jaug.augment_batch(jax.random.key(3), jnp.asarray(data), jnp.asarray(seg),
                                jaug.AugmentConfig(**kw))
    d, s = taug.augment_batch(_nchw(data), torch.from_numpy(seg), taug.AugmentConfig(**kw),
                              torch.Generator().manual_seed(0))
    np.testing.assert_allclose(_nhwc(d), np.asarray(jd), atol=5e-5, rtol=0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if on == 0.0:
        np.testing.assert_array_equal(_nhwc(d), data)


def test_draws_come_from_the_generator_and_da5_raises():
    """The draws repeat from the same generator. The DA5 transforms, which
    raised before they were ported, now run (``test_torch_port_da5`` holds
    them against the JAX stack); device-side rotation, which raised before it
    was ported, gives the JAX stack's batch from the same draws; and a 3D
    patch gets the JAX package's spatial-DA plan."""
    cfg = taug.AugmentConfig(p_rotation=0.0, p_scaling=0.0)
    a = taug.draw_augment_params((2, 3, 8, 8), cfg, torch.Generator().manual_seed(1))
    b = taug.draw_augment_params((2, 3, 8, 8), cfg, torch.Generator().manual_seed(1))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert {"noise_on", "blur_sigma", "lowres_factor4", "mirror_h", "mirror_w"} <= set(a)
    x = torch.zeros(2, 3, 8, 8)
    for field, value in (("p_rot90", 0.5), ("p_median", 0.5), ("p_sharpen", 0.1),
                         ("brightness_additive_sigma", 0.5), ("gamma2_invert", True)):
        da5 = taug.AugmentConfig(p_rotation=0.0, p_scaling=0.0, **{field: value})
        out, _ = taug.augment_batch(x, torch.zeros(2, 8, 8, dtype=torch.long), da5,
                                    torch.Generator())
        assert out.shape == x.shape and torch.isfinite(out).all()
    # device-side rotation and scaling: the default config's spatial branch,
    # with the draws of its JAX key, gives the JAX stack's batch
    spatial = taug.AugmentConfig(**{k: 0.0 for k in (
        "p_noise", "p_blur", "p_brightness", "p_contrast", "p_lowres", "p_gamma_invert",
        "p_gamma", "p_mirror")}, p_rotation=1.0)
    rng = np.random.default_rng(6)
    img = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    lab = rng.integers(0, 4, (2, 8, 8)).astype(np.int32)
    key = jax.random.key(6)
    jd, js = jaug.augment_batch(key, jnp.asarray(img), jnp.asarray(lab),
                                jaug.AugmentConfig(**dataclasses.asdict(spatial)))
    drawn = taug.draw_augment_params((2, 3, 8, 8), spatial, torch.Generator().manual_seed(1))
    assert {"spatial_on", "angle", "scale"} <= set(drawn)
    for i, k in enumerate(jax.random.split(key, 2)):
        ks = jax.random.split(k, 16)
        drawn["angle"][i] = float(jax.random.uniform(ks[1], (), minval=-np.pi, maxval=np.pi))
        drawn["scale"][i] = (float(jax.random.uniform(ks[2], (), minval=0.7, maxval=1.4))
                             if float(jax.random.uniform(ks[0], (12,))[1]) < 0.2 else 1.0)
    drawn["spatial_on"][:] = True
    d, s = taug.apply_augment(_nchw(img), torch.from_numpy(lab), drawn, spatial)
    np.testing.assert_allclose(_nhwc(d), np.asarray(jd), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # a 3D patch is ported: ±30° about each axis, the JAX package's plan
    plan3d = taug.configure_spatial_da((8, 8, 8))
    assert dataclasses.asdict(plan3d) == dataclasses.asdict(jaug.configure_spatial_da((8, 8, 8)))
    assert plan3d.rotation_max == pytest.approx((np.pi / 6,) * 3) and not plan3d.do_dummy_2d
