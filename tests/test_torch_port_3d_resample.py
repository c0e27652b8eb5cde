"""The port's resampling (``segmentor/resample.py``) and volume export
(``segmentor/export.py:export_volume_prediction``) against the JAX package's,
on the CPU at tiny sizes: data and labels, isotropic and separate-z
(anisotropic spacing, the coarse axis first or in-plane), every ``order`` and
``order_z``, up and down, with and without channels; the 2D helpers; the
export of (Z, H, W, C) logits into the crop bbox at the original shape,
plain and through a label manager.

Tolerance: both packages call scipy on the host, so every array is equal,
bit for bit, and so is the export after argmax.
"""
import numpy as np
import pytest

from ldiffusion_tpu.segmentor import export as jexport
from ldiffusion_tpu.segmentor import resample as jres
from ldiffusion_tpu.segmentor.label_manager import LabelManager as JLabelManager
from ldiffusion_tpu_torch.data.io import NumpyIO
from ldiffusion_tpu_torch.segmentor import export as texport
from ldiffusion_tpu_torch.segmentor import resample as tres
from ldiffusion_tpu_torch.segmentor.label_manager import LabelManager
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

SPACINGS = {"isotropic": (1.0, 1.2, 0.9), "aniso_z": (4.0, 0.8, 0.8),
            "aniso_y": (0.8, 3.5, 0.8), "aniso_x": (1.0, 1.0, 3.4)}
SHAPES = [(10, 14, 12), (7, 9, 16), (16, 20, 20)]


def _equal(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spacing", sorted(SPACINGS))
@pytest.mark.parametrize("new_shape", SHAPES)
def test_resample_data_3d_equal_jax(spacing, new_shape):
    rng = np.random.default_rng(0)
    sp = SPACINGS[spacing]
    vol = rng.normal(size=(9, 12, 13)).astype(np.float32)
    vol4 = rng.normal(size=(9, 12, 13, 2)).astype(np.float32)
    seg = np.kron(rng.integers(0, 3, (3, 4, 13)), np.ones((3, 3, 1))).astype(np.int16)
    for kw in (dict(order=3), dict(order=1), dict(order=3, order_z=1), dict(order=0)):
        _equal(tres.resample_data_3d(vol, new_shape, sp, **kw),
               jres.resample_data_3d(vol, new_shape, sp, **kw))
        _equal(tres.resample_data_3d(vol4, new_shape, sp, **kw),
               jres.resample_data_3d(vol4, new_shape, sp, **kw))
    got = tres.resample_data_3d(seg, new_shape, sp, is_seg=True)
    _equal(got, jres.resample_data_3d(seg, new_shape, sp, is_seg=True))
    assert set(np.unique(got)) <= {0, 1, 2}
    assert tres.resample_data_3d(vol, vol.shape, sp) is vol


def test_2d_helpers_equal_jax():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(11, 13, 3)).astype(np.float32)
    seg = rng.integers(0, 4, (11, 13)).astype(np.int16)
    for shape in ((20, 7), (11, 13), (5, 26)):
        _equal(tres.resample_data(img, shape), jres.resample_data(img, shape))
        _equal(tres.resample_data(img[..., 0], shape, order=1),
               jres.resample_data(img[..., 0], shape, order=1))
        _equal(tres.resample_seg(seg, shape), jres.resample_seg(seg, shape))
        _equal(tres.resample_logits(img, shape), jres.resample_logits(img, shape))
    for args in (((160, 256, 256), (2.5, 0.8, 0.8), (3.15, 1.01, 1.01)),
                 ((7, 9, 11), (1.0, 1.0, 1.0), (0.5, 2.0, 1.3))):
        assert tres.compute_new_shape(*args) == jres.compute_new_shape(*args)


@pytest.mark.parametrize("regime", ["argmax", "labels", "regions"])
def test_export_volume_prediction_equal_jax(tmp_path, regime):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 10, 9, 3)).astype(np.float32)
    props = {"original_shape": [14, 20, 22], "bbox": [[2, 12], [3, 19], [4, 18]],
             "spacing": [3.5, 0.8, 0.8], "target_spacing": [3.0, 1.0, 1.1]}
    tl = jl = None
    if regime == "labels":
        labels = {"background": 0, "a": 1, "b": 2}
        tl, jl = LabelManager(labels), JLabelManager(labels)
    elif regime == "regions":
        labels = {"background": 0, "ab": (1, 2), "b": (2,), "c": (3,)}
        tl, jl = LabelManager(labels, [1, 2, 3]), JLabelManager(labels, [1, 2, 3])
    got = texport.export_volume_prediction(logits, props, str(tmp_path / "t.npy"),
                                           reader_writer=NumpyIO(), label_manager=tl)
    want = jexport.export_volume_prediction(logits, props, str(tmp_path / "j.npy"),
                                            label_manager=jl)
    _equal(got, want)
    assert got.shape == (14, 20, 22) and got[:2].max() == 0
    np.testing.assert_array_equal(np.load(tmp_path / "t.npy"), got)
    # logits already on the cropped grid: only pasted
    same = rng.normal(size=(10, 16, 14, 3)).astype(np.float32)
    _equal(texport.export_volume_prediction(same, props, "", label_manager=tl),
           jexport.export_volume_prediction(same, props, "", label_manager=jl))
