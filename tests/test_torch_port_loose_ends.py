"""The loose ends of the ported modules against their JAX counterparts, on
the same inputs: the normalisation schemes, the 2D export and the folder
postprocessing, ``labels_to_pixels``, ``PatchSampler.sample_one``,
``optax_sigmoid_bce``, ``LDiffusionConfig``, the process-count knobs,
``collate_outputs`` / ``dummy_context`` and ``profiler_trace``. Host numpy
code copied step for step is held bit-equal; the f32 elementwise formulas
(the normalisations, the BCE) within 1e-6.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ldiffusion_tpu.cell import instance as jinst
from ldiffusion_tpu.core import config as jconfig
from ldiffusion_tpu.core import logging as jlogging
from ldiffusion_tpu.core import paths as jpaths
from ldiffusion_tpu.core import registry as jregistry
from ldiffusion_tpu.data import labels as jlabels
from ldiffusion_tpu.data.patches import PatchSampler as JSampler
from ldiffusion_tpu.segmentor import export as jexport
from ldiffusion_tpu.segmentor import postprocess as jpost
from ldiffusion_tpu.segmentor import preprocess as jpre
from ldiffusion_tpu_torch.cell import instance as tinst
from ldiffusion_tpu_torch.core import config as tconfig
from ldiffusion_tpu_torch.core import logging as tlogging
from ldiffusion_tpu_torch.core import paths as tpaths
from ldiffusion_tpu_torch.core import registry as tregistry
from ldiffusion_tpu_torch.data import labels as tlabels
from ldiffusion_tpu_torch.data.patches import PatchSampler as TSampler
from ldiffusion_tpu_torch.segmentor import export as texport
from ldiffusion_tpu_torch.segmentor import postprocess as tpost
from ldiffusion_tpu_torch.segmentor import preprocess as tpre
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

F32_TOL = 1e-6


def _image(seed=0, shape=(20, 24, 3)):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 255).astype(np.float32)


CT_PROPS = {str(c): {"percentile_00_5": 10.0 + c, "percentile_99_5": 240.0 - c,
                     "mean": 120.0 + 3 * c, "std": 50.0 - c} for c in range(3)}


@pytest.mark.parametrize("scheme", ["zscore_image", "ct", "rescale_to_01", "rgb_to_01", "none"])
def test_normalization_schemes_match_jax(scheme):
    assert sorted(tpre.NORMALIZATION_SCHEMES) == sorted(jpre.NORMALIZATION_SCHEMES)
    img = _image(1)
    props = CT_PROPS if scheme == "ct" else None
    got = tpre.normalize(img, scheme, props)
    ref = jpre.normalize(img, scheme, props)
    assert got.dtype == ref.dtype == np.float32 and got.shape == img.shape
    np.testing.assert_allclose(got, ref, atol=F32_TOL, rtol=F32_TOL)


def test_normalization_functions_match_jax():
    img = _image(2)
    for t, j in ((tpre.rescale_to_01, jpre.rescale_to_01), (tpre.rgb_to_01, jpre.rgb_to_01),
                 (tpre.no_norm, jpre.no_norm)):
        np.testing.assert_allclose(t(img), j(img), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(tpre.ct_normalize(img, CT_PROPS), jpre.ct_normalize(img, CT_PROPS),
                               atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("resample", [False, True])
def test_logits_to_segmentation_and_png_match_jax(tmp_path, resample):
    rng = np.random.default_rng(3)
    crop = (18, 22)
    logits = rng.normal(size=(12, 15, 5) if resample else crop + (5,)).astype(np.float32)
    props = {"bbox": [[3, 21], [1, 23]], "original_shape": [25, 30]}
    got = texport.logits_to_segmentation(logits, props)
    ref = jexport.logits_to_segmentation(logits, props)
    assert got.dtype == np.uint8 and got.shape == (25, 30)
    np.testing.assert_array_equal(got, ref)
    if not resample:
        np.testing.assert_array_equal(texport.logits_to_segmentation(logits),
                                      jexport.logits_to_segmentation(logits))
    texport.save_segmentation_png(got, str(tmp_path / "t.png"))
    jexport.save_segmentation_png(ref, str(tmp_path / "j.png"))
    with Image.open(tmp_path / "t.png") as a, Image.open(tmp_path / "j.png") as b:
        assert a.mode == b.mode
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_apply_postprocessing_to_folder_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    src = tmp_path / "in"
    src.mkdir()
    for i in range(3):  # blocky masks: several components of each label
        m = np.kron(rng.integers(0, 4, (6, 7)), np.ones((5, 5), np.int64)).astype(np.uint8)
        Image.fromarray(m).save(src / f"case_{i}.png")
    (src / "notes.txt").write_text("not a mask")
    steps = [{"fn": "remove_all_but_largest_component", "labels": [1, 2, 3]},
             {"fn": "remove_all_but_largest_component", "labels": [2]}]
    steps_path = tmp_path / "postprocessing.json"
    steps_path.write_text(json.dumps(steps))
    tpost.apply_postprocessing_to_folder(str(src), str(tmp_path / "t"), str(steps_path))
    jpost.apply_postprocessing_to_folder(str(src), str(tmp_path / "j"), str(steps_path))
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        [f"case_{i}.png" for i in range(3)]
    changed = False
    for name in os.listdir(tmp_path / "t"):
        with Image.open(tmp_path / "t" / name) as a, Image.open(tmp_path / "j" / name) as b, \
                Image.open(src / name) as orig:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            changed |= not np.array_equal(np.asarray(a), np.asarray(orig))
    assert changed


@pytest.mark.parametrize("level", ["tissue", "cell"])
def test_labels_to_pixels_matches_jax(level):
    n = 7 if level == "tissue" else 11
    labels = np.random.default_rng(5).integers(0, n, (16, 16))
    got = tlabels.labels_to_pixels(labels, level)
    np.testing.assert_array_equal(got, jlabels.labels_to_pixels(labels, level))
    np.testing.assert_array_equal(tlabels.convert_labels(got, level), labels)


def test_patch_sampler_sample_one_matches_jax():
    rng = np.random.default_rng(6)
    images = [rng.random((40 + 8 * i, 32, 3)).astype(np.float32) for i in range(3)]
    labels = [np.kron(rng.integers(0, 4, (5 + i, 4)), np.ones((8, 8), np.int64)).astype(np.int32)
              for i in range(3)]
    port = TSampler(tpre.PreprocessedDataset.build(images, labels, 4), (48, 24), 2, seed=9)
    ref = JSampler(jpre.PreprocessedDataset.build(images, labels, 4), (48, 24), 2, seed=9)
    for force_fg in (True, False, True, False, True):
        (d, s), (jd, js) = port.sample_one(force_fg), ref.sample_one(force_fg)
        assert d.shape == (48, 24, 3) and s.shape == (48, 24)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_allclose(d, jd, atol=F32_TOL, rtol=0)  # the z-scored data


def test_optax_sigmoid_bce_matches_jax():
    rng = np.random.default_rng(7)
    logits = (rng.normal(size=(4, 33)) * 6).astype(np.float32)
    targets = rng.random((4, 33)).astype(np.float32)
    got = tinst.optax_sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(targets))
    ref = jinst.optax_sigmoid_bce(jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=F32_TOL, rtol=F32_TOL)


def test_ldiffusion_config_matches_jax():
    assert json.loads(tconfig.LDiffusionConfig().to_json()) == \
        json.loads(jconfig.LDiffusionConfig().to_json())
    d = {"diffusion_path": "sd15", "level": "cell", "num_classes": 11, "train_ratio": 0.8,
         "seed": 3, "unknown_key": 1}
    t, j = tconfig.LDiffusionConfig.from_dict(d), jconfig.LDiffusionConfig.from_dict(d)
    assert json.loads(t.to_json()) == json.loads(j.to_json())
    for mesh in ((-1, 2, 1), (8, 1, 1), (-1, 1, 2)):
        assert tconfig.MeshConfig(*mesh).resolved(8) == tconfig.MeshConfig(
            *jconfig.MeshConfig(*mesh).resolved(8).__dict__.values())
    with pytest.raises(ValueError):
        tconfig.MeshConfig(3, 1, 1).resolved(8)


@pytest.mark.parametrize("env", [{}, {"LDIFFUSION_N_PROC": "5", "LDIFFUSION_N_PROC_DA": "3"},
                                 {"nnUNet_def_n_proc": "12", "nnUNet_n_proc_DA": "6"}])
def test_process_counts_match_jax(monkeypatch, env):
    for name in ("LDIFFUSION_N_PROC", "LDIFFUSION_N_PROC_DA", "nnUNet_def_n_proc",
                 "nnUNet_n_proc_DA"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert tpaths.default_num_processes() == jpaths.default_num_processes()
    assert tpaths.num_processes_da() == jpaths.num_processes_da()


def test_collate_outputs_and_dummy_context_match_jax():
    rng = np.random.default_rng(8)
    outputs = [{"loss": float(rng.random()), "tp": rng.integers(0, 9, 4), "n": np.int64(i),
                "dice": np.float32(rng.random())} for i in range(3)]
    got, ref = tregistry.collate_outputs(outputs), jregistry.collate_outputs(outputs)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])
    assert tregistry.collate_outputs([]) == jregistry.collate_outputs([]) == {}
    with tregistry.dummy_context() as a, jregistry.dummy_context() as b:
        assert a is None and b is None


def test_profiler_trace(tmp_path):
    """None traces nothing in either package; a directory gets the port's
    Chrome trace of the block's ops, beside its spans file
    (``test_torch_port_tracing``)."""
    for ctx in (tlogging.profiler_trace(None), jlogging.profiler_trace(None),
                tlogging.profiler_trace("")):
        with ctx:
            pass
    with tlogging.profiler_trace(str(tmp_path / "trace")):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    spans, trace = sorted(os.listdir(tmp_path / "trace"))
    assert spans.startswith("spans_") and spans.endswith(".json")
    assert trace.startswith("trace_") and trace.endswith(".json")
    with open(tmp_path / "trace" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
