"""The stage-2 slice as a whole: ``LDiffusionModel.train(component=
"segmentor"|"all")`` of the port on the CPU, at the tiny SD components and
synthetic 64² PUMA-convention PNGs, against the JAX API's
``_prepare_tissue`` on the same data and UNet, then inference from the
written segmentor.

Tolerances: the transformed dataset PNGs at most one 8-bit level apart (the
transforms agree to 1e-3, ``test_torch_port_pipeline``); labels,
``splits_final.json`` and ``dataset.json`` equal; the plan equal but for the
fingerprint's intensity statistics, taken over those PNGs: 1/255.
"""
import argparse
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

import jax

from ldiffusion_tpu.api import LDiffusionModel as JModel
from ldiffusion_tpu.core.config import MeshConfig
from ldiffusion_tpu.core.dist import make_mesh
from ldiffusion_tpu.diffusion import pipeline as jpipe
from ldiffusion_tpu.segmentor.splits import do_split as j_do_split
from ldiffusion_tpu_torch.api import LDiffusionModel
from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig, SegmentorTrainConfig
from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
from ldiffusion_tpu_torch.models.convert import save_unet_dir
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from torch_port_common import jax_random_components
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)


def _labels(rng, n, size, classes):
    return np.stack([np.kron(rng.integers(0, classes, (size // 8, size // 8)),
                             np.ones((8, 8), np.int64)) for _ in range(n)]).astype(np.int32)


CODES = np.array([0, 100, 150, 50, 200, 250, 255], np.uint8)  # tissue class ids 0..6


def _pairs(root, n=6):
    rng = np.random.default_rng(6)
    images, labels = root / "images", root / "labels"
    images.mkdir()
    labels.mkdir()
    for i in range(n):
        coarse = Image.fromarray((rng.random((8, 8, 3)) * 255).astype(np.uint8))
        coarse.resize((64, 64), Image.BICUBIC).save(images / f"roi_{i}.png")
        Image.fromarray(CODES[_labels(rng, 1, 64, 7)[0]]).save(labels / f"roi_{i}.png")
    return argparse.Namespace(image_dir=str(images), label_dir=str(labels), num_epochs=11,
                              batch_size=1, num_inference_steps=5, num_classes=7)


@pytest.fixture(scope="module")
def slice_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg_slice")
    jc = jax_random_components()
    unet_dir = str(root / "unet")
    comps = SDComponents.from_flax(jc.params, device="cpu")
    save_unet_dir(unet_dir, comps.unet_config, comps.unet.state_dict(), comps.proj.state_dict())
    return {"root": root, "args": _pairs(root), "jc": jc, "unet_dir": unet_dir}


def test_api_trains_the_segmentor_like_jax(slice_world, monkeypatch):
    root, args, unet_dir = slice_world["root"], slice_world["args"], slice_world["unet_dir"]
    comps = SDComponents.from_flax(slice_world["jc"].params, device="cpu")
    cfg = SegmentorTrainConfig(iters_per_epoch=2, val_iters_per_epoch=1, compute_dtype="float32")
    model = LDiffusionModel("random:tiny", "tissue", components=comps, device="cpu",
                            work_dir=str(root / "port"), segmentor_config=cfg)
    seg_dir = model.train(args, component="segmentor", ldiffusion_weight=unet_dir)["segmentor"]
    assert model.seg_trainer.current_epoch == 1  # max(1, 11 - 10)
    fold = os.path.join(seg_dir, "fold_0")
    for rel in ("checkpoint_final.pkl", "checkpoint_best.pkl", "validation/summary.json",
                "postprocessing.json"):
        assert os.path.exists(os.path.join(fold, rel)), rel

    mesh = make_mesh(MeshConfig(data=1), devices=jax.devices()[:1])
    # the JAX API builds SDComponents.random(image_size=64) for a random: path:
    # the bundle jax_random_components built (its UNet entry is replaced)
    jc = slice_world["jc"]
    monkeypatch.setattr(jpipe.SDComponents, "random", classmethod(
        lambda cls, **kw: dataclasses.replace(jc, params=dict(jc.params))))
    jmodel = JModel("random:tiny", "tissue", mesh=mesh, work_dir=str(root / "jax"))
    jtrain, jval = jmodel.load_data(args.image_dir, args.label_dir)
    prep = jmodel._prepare_tissue(unet_dir, 7, jtrain, jval)
    j_do_split(prep["pp_all"].keys(), 0, os.path.join(prep["out_dir"], "splits_final.json"),
               log=lambda *a: None)
    assert open(os.path.join(seg_dir, "splits_final.json"), "rb").read() == \
        open(os.path.join(prep["out_dir"], "splits_final.json"), "rb").read()
    # the plan: equal, but for the fingerprint's intensity statistics, which
    # are taken over the transformed PNGs (one 8-bit level apart at most)
    plan = SegPlan.load(os.path.join(seg_dir, "plans.json"))
    jplan = prep["plan"]
    assert dataclasses.replace(plan, intensity_properties={}).to_json() == \
        dataclasses.replace(jplan, intensity_properties={}).to_json()
    for c, props in jplan.intensity_properties.items():
        for k, v in props.items():
            assert abs(plan.intensity_properties[c][k] - v) <= 1 / 255, (c, k)
    ds = os.path.join(str(root / "port"), "seg_raw", "Dataset001_Custom")
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        names = sorted(os.listdir(os.path.join(ds, sub)))
        assert names == sorted(os.listdir(os.path.join(prep["ds_path"], sub)))
        for n in names:
            a = np.asarray(Image.open(os.path.join(ds, sub, n)), np.int16)
            b = np.asarray(Image.open(os.path.join(prep["ds_path"], sub, n)), np.int16)
            if sub.startswith("labels"):
                np.testing.assert_array_equal(a, b)
            else:
                assert np.abs(a - b).max() <= 1, (sub, n)
    with open(os.path.join(ds, "dataset.json")) as f, \
            open(os.path.join(prep["ds_path"], "dataset.json")) as g:
        assert json.load(f) == json.load(g)

    decoded, mask = model.inference(os.path.join(args.image_dir, "roi_0.png"), unet_dir,
                                    seg_dir, 7)
    assert mask.shape == (64, 64) and mask.dtype == np.uint8 and mask.max() < 7
    assert decoded.size == (64, 64)


def test_api_trains_all_components(slice_world, tmp_path):
    """``component="all"``: stage 1, then stage 2 from the UNet it saved."""
    comps = SDComponents.from_flax(slice_world["jc"].params, device="cpu")
    model = LDiffusionModel(
        "random:tiny", "tissue", components=comps, device="cpu", work_dir=str(tmp_path),
        diffusion_config=DiffusionTrainConfig(num_epochs=1, num_inference_steps=5,
                                              num_classes=7, compute_dtype="float32"),
        segmentor_config=SegmentorTrainConfig(iters_per_epoch=1, val_iters_per_epoch=1,
                                              compute_dtype="float32"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        out = model.train(slice_world["args"], component="all")
    assert set(out) == {"ldiffusion", "segmentor"}
    assert model.trainer.steps_done == 4  # int(6 * 0.7) = 4 training pairs, batch 1
    assert os.path.exists(os.path.join(out["segmentor"], "fold_0", "checkpoint_final.pkl"))
    with pytest.raises(ValueError, match="Invalid level"):
        LDiffusionModel("random:tiny", "organ", device="cpu").train(slice_world["args"])
