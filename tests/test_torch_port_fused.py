"""The port's one-program tissue inference and the predictor's bucketed
programs against the JAX package's, on the CPU in float32.

- ``LDiffusionModel._make_fused_predict``'s ``run`` against the JAX
  ``_make_fused_predict`` (``ldiffusion_tpu/api.py:313-346``), both
  ``want_transformed`` values: masks on >= 99.5% of pixels
  (``test_torch_port_api``'s ``MASK_AGREEMENT``), the [0, 1] transform within
  1e-3 (``test_torch_port_pipeline``'s) and its uint8 PNG within one level
  (``test_single_image_matches_jax``'s).
- ``predict`` / ``predict_logits`` against the JAX ``_run`` (``:280-318``)
  with 2 folds, a plain and a region label manager, at a shape smaller than
  the patch and at one of several tiles: masks equal, logits within 1e-5
  (f32 on both sides, the same weights: summation order only).
- Folder mode (5 square ROIs, 1 non-square, ``overwrite=False`` over one
  existing PNG) against the JAX folder mode (``:394-420``): the same files,
  written in sorted order, the masks at ``MASK_AGREEMENT``.
- The caches: one program per (padded shape, tile count, mode, crop) key,
  the JAX predictor's keys; one per (shape, want_transformed) for the fused
  run; on the CPU no ``torch.cuda.CUDAGraph`` is ever made.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ldiffusion_tpu.api import LDiffusionModel as JModel
from ldiffusion_tpu.core.checkpoint import save_pytree
from ldiffusion_tpu.segmentor import label_manager as jlabel
from ldiffusion_tpu.segmentor.planner import SegPlan as JPlan
from ldiffusion_tpu.segmentor.predictor import SlidingWindowPredictor as JPredictor
from ldiffusion_tpu_torch.api import LDiffusionModel
from ldiffusion_tpu_torch.core import graphs
from ldiffusion_tpu_torch.data.dataset import load_image
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents, trajectory_text_emb
from ldiffusion_tpu_torch.models.convert import dynunet_from_flax, dynunet_to_flax
from ldiffusion_tpu_torch.models.dynunet import DynUNet
from ldiffusion_tpu_torch.models.layers import init_random_
from ldiffusion_tpu_torch.segmentor import label_manager as tlabel
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor as TPredictor
from torch_port_common import jax_components_of

MASK_AGREEMENT = 0.995
TRANSFORM_TOL = 1e-3
LOGITS_TOL = 1e-5
SQUARE = tuple(f"roi_{i}.png" for i in range(5))
NON_SQUARE = "roi_5_wide.png"
REGIONS = ({"background": 0, "abc": (1, 2, 3), "ab": (1, 2), "a": (1,)}, [3, 2, 1])


def _plan_kw(classes, patch, features=(8, 16, 32)):
    return dict(patch_size=patch, batch_size=2, features_per_stage=features,
                strides=(1, 2, 2)[:len(features)], n_conv_per_stage=2, num_classes=classes,
                in_channels=3, normalization="zscore_image", intensity_properties={},
                median_shape=patch, batch_dice=True)


def _fold_params(kw, seeds):
    """Flax-layout DynUNet params of each fold, drawn by the port's seeded
    initialiser (no JAX init to compile)."""
    cfg = SegPlan(**kw).network_config()
    return [dynunet_to_flax(init_random_(DynUNet(cfg), torch.Generator().manual_seed(s))
                            .state_dict(), cfg) for s in seeds]


def _tissue_like(rng, h, w):
    coarse = Image.fromarray((rng.random((h // 8, w // 8, 3)) * 255).astype(np.uint8))
    field = np.asarray(coarse.resize((w, h), Image.BICUBIC), np.float32)
    field += rng.normal(scale=8.0, size=field.shape)
    return Image.fromarray(np.clip(field, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file (the suite runs several workers on
    one host); the previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Six ROIs, a 2-fold segmentor directory at a 32² / 7-class plan in the
    JAX layout, and the same tiny SD weights on both sides."""
    root = tmp_path_factory.mktemp("fused")
    images = root / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for name in SQUARE:
        _tissue_like(rng, 64, 64).save(images / name)
    _tissue_like(rng, 40, 56).save(images / NON_SQUARE)
    plan = JPlan(**_plan_kw(7, (32, 32)))
    seg = root / "segmentor"
    plan.save(str(seg / "plans.json"))
    for fold, params in enumerate(_fold_params(_plan_kw(7, (32, 32)), (5, 6))):
        save_pytree(str(seg / f"fold_{fold}" / "checkpoint_final.pkl"),
                    {"params": params, "batch_stats": {}, "plan": plan.to_json()})
    comps = SDComponents.random(device="cpu")
    return {"root": root, "images": images, "seg": str(seg), "comps": comps,
            "jax_components": jax_components_of(comps)}


@pytest.fixture
def f32_predictors(monkeypatch):
    """Both packages build their inference predictors in f32."""
    tload = TPredictor.from_checkpoints.__func__
    monkeypatch.setattr(TPredictor, "from_checkpoints", classmethod(
        lambda cls, plan, paths, **kw: tload(cls, plan, paths, dtype=torch.float32, **kw)))
    jload = JPredictor.from_checkpoints.__func__
    monkeypatch.setattr(JPredictor, "from_checkpoints", classmethod(
        lambda cls, plan, paths, **kw: jload(cls, plan, paths, dtype=jnp.float32, **kw)))


@pytest.fixture
def no_graphs(monkeypatch):
    """A CUDA graph made anywhere fails the test."""
    def refuse(*a, **k):
        raise AssertionError("a CUDA graph was made on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)


def _predictors(world):
    ckpts = [os.path.join(world["seg"], f"fold_{f}", "checkpoint_final.pkl") for f in (0, 1)]
    plan = SegPlan.load(os.path.join(world["seg"], "plans.json"))
    jplan = JPlan.load(os.path.join(world["seg"], "plans.json"))
    return (TPredictor.from_checkpoints(plan, ckpts, dtype=torch.float32, device="cpu"),
            JPredictor.from_checkpoints(jplan, ckpts, dtype=jnp.float32))


def test_fused_run_matches_jax(world, no_graphs):
    tpred, jpred = _predictors(world)
    tmodel = LDiffusionModel("random:tiny", "tissue", components=world["comps"], device="cpu")
    jmodel = JModel("random:tiny", "tissue", components=world["jax_components"],
                    work_dir=str(world["root"] / "jax_work"))
    with torch.inference_mode():
        trun = tmodel._make_fused_predict(tpred, trajectory_text_emb(world["comps"], 1))
    jrun = jmodel._make_fused_predict(jpred)
    img = load_image(str(world["images"] / SQUARE[0]), (64, 64))
    jt, jmask = (np.asarray(a) for a in jrun(img, want_transformed=True))
    t, mask = trun(img, want_transformed=True)
    assert isinstance(t, torch.Tensor) and isinstance(mask, torch.Tensor)
    t, mask = t.numpy(), mask.numpy()
    assert t.shape == (64, 64, 3) and t.dtype == np.float32
    assert mask.shape == (64, 64) and mask.dtype == np.uint8
    assert float(np.abs(t - jt).max()) <= TRANSFORM_TOL
    png = lambda a: (np.clip(a, 0, 1) * 255).astype(np.uint8).astype(np.int16)  # noqa: E731
    assert int(np.abs(png(t) - png(jt)).max()) <= 1
    assert float(np.mean(mask == jmask)) >= MASK_AGREEMENT
    only = trun(img, want_transformed=False).numpy()
    np.testing.assert_array_equal(only, mask)  # the same program, the mask alone
    assert float(np.mean(only == np.asarray(jrun(img, want_transformed=False)))) >= \
        MASK_AGREEMENT
    assert set(trun.programs) == {((64, 64, 3), True), ((64, 64, 3), False)}
    trun(img, want_transformed=False)  # the same key: no new program
    assert len(trun.programs) == 2
    assert all(p.graph is None for p in trun.programs.values())


@pytest.mark.parametrize("regime", ["plain", "regions"])
def test_predict_and_logits_match_jax_run(regime, no_graphs):
    """2 folds; (10, 14) pads up to the 16² patch, (28, 36) takes 3 x 4 tiles."""
    labels, order = REGIONS if regime == "regions" else (
        {"background": 0, "a": 1, "b": 2, "c": 3}, None)
    tlm, jlm = tlabel.LabelManager(dict(labels), order), jlabel.LabelManager(dict(labels),
                                                                              order)
    heads = tlm.num_segmentation_heads
    kw = _plan_kw(heads, (16, 16), features=(4, 8))
    jplan, tplan = JPlan(**kw), SegPlan(**kw)
    params = _fold_params(kw, (7, 8))
    jpred = JPredictor(jplan, params, dtype=jnp.float32, label_manager=jlm)
    tpred = TPredictor(tplan, [dynunet_from_flax(p, tplan.network_config()) for p in params],
                       dtype=torch.float32, device="cpu", label_manager=tlm)
    rng = np.random.default_rng(9)
    for shape in ((10, 14), (28, 36)):
        img = rng.random(shape + (3,)).astype(np.float32)
        want = np.asarray(jpred.predict_logits(img))
        got = tpred.predict_logits(img)
        assert got.shape == want.shape == shape + (heads,)
        np.testing.assert_allclose(got, want, atol=LOGITS_TOL, rtol=0)
        mask = tpred.predict(img)
        assert mask.shape == shape and mask.dtype == np.uint8
        np.testing.assert_array_equal(mask, np.asarray(jpred.predict(img)))
        np.testing.assert_array_equal(tpred.seg(torch.from_numpy(img)).numpy(), mask)
    assert set(tpred._predict_cache) == set(jpred._predict_cache)
    assert len(tpred._predict_cache) == 4  # 2 shapes x 2 modes
    forwards = tpred.network_forwards
    tpred.predict(img)  # the same shape reuses its program
    assert len(tpred._predict_cache) == 4
    assert tpred.network_forwards - forwards == 12 * 4 * 2  # tiles x flips x folds
    tpred.predict(img[:25])  # a new shape adds one
    assert len(tpred._predict_cache) == 5


def test_folder_mode_matches_jax_in_sorted_order(world, f32_predictors, no_graphs,
                                                 monkeypatch):
    saved = []
    save = Image.Image.save
    monkeypatch.setattr(Image.Image, "save", lambda self, fp, *a, **k: (
        saved.append(os.path.basename(str(fp))), save(self, fp, *a, **k))[1])
    masks, names = {}, sorted(SQUARE + (NON_SQUARE,))
    pngs = [os.path.splitext(n)[0] + ".png" for n in names]
    sentinel = np.full((64, 64), 6, np.uint8)
    for side, model in (("jax", JModel("random:tiny", "tissue",
                                       components=world["jax_components"],
                                       work_dir=str(world["root"] / "jax_work"))),
                        ("port", LDiffusionModel("random:tiny", "tissue",
                                                 components=world["comps"], device="cpu"))):
        out = world["root"] / f"{side}_masks"
        out.mkdir()
        save(Image.fromarray(sentinel), out / pngs[1])  # an existing output
        saved.clear()
        assert model.inference_tissue(str(world["images"]), None, world["seg"], 7,
                                      output_path=str(out), overwrite=False) == (None, None)
        assert saved == pngs[:1] + pngs[2:], side
        assert sorted(os.listdir(out)) == pngs
        np.testing.assert_array_equal(np.asarray(Image.open(out / pngs[1])), sentinel)
        masks[side] = {p: np.asarray(Image.open(out / p)) for p in pngs}
    for p in pngs:
        assert masks["port"][p].shape == masks["jax"][p].shape, p
        assert float(np.mean(masks["port"][p] == masks["jax"][p])) >= MASK_AGREEMENT, p
    # one fused program (64², mask only) and one bucket (the non-square ROI)
    assert set(model.tissue_programs["fused"]) == {((64, 64, 3), False)}
    assert len(model.tissue_programs["predict"]) == 1


def test_counters_follow_replays_in_arithmetic():
    """What a capture records per counter (ints and dicts by route), taken
    back after the capture and added on every replay."""
    class Owner:
        launches = 3
        launches_by_route = {"wgmma": 2, "mma": 0}

    pairs = [(Owner, "launches"), (Owner, "launches_by_route")]
    before = graphs._read(pairs)
    Owner.launches += 5
    Owner.launches_by_route["wgmma"] += 5
    delta = graphs._diff(graphs._read(pairs), before)
    assert delta == [5, {"wgmma": 5, "mma": 0}]
    graphs._add(pairs, delta, -1)
    assert graphs._read(pairs) == before
    graphs._add(pairs, delta)
    graphs._add(pairs, delta)
    assert Owner.launches == 13 and Owner.launches_by_route == {"wgmma": 12, "mma": 0}
    names = {getattr(o, "__name__", "") for o, _ in graphs.counters()}
    assert {"flash_attention_fwd", "groupnorm_silu", "int8_conv"} <= names
