"""The 3D pathway's planning and preprocessing in the port against the JAX
package's, on the CPU at tiny sizes: the 3D plans of isotropic, anisotropic,
large (lowres emitted), ResEnc and target-spacing fingerprints and of the
card phase's dataset, ``SegPlan3D``'s JSON, the plans file with
``inherits_from``, ``extract_fingerprint_3d``, ``preprocess_case_3d``,
``append_prev_stage_channels``, ``plan_and_preprocess_3d``, and the readers
(``NumpyIO``'s round trip, the gated readers naming their package).

Tolerance: everything here is host numpy/scipy in both packages, so the
results are equal (plans field by field, arrays bit for bit).
"""
import dataclasses
import json

import numpy as np
import pytest

from ldiffusion_tpu.data import io as jio
from ldiffusion_tpu.segmentor import fingerprint as jfp
from ldiffusion_tpu.segmentor import planner3d as jplan
from ldiffusion_tpu.segmentor import plans_file as jplans
from ldiffusion_tpu.segmentor import preprocess as jpre
from ldiffusion_tpu_torch.data import io as tio
from ldiffusion_tpu_torch.segmentor import fingerprint as tfp
from ldiffusion_tpu_torch.segmentor import planner3d as tplan
from ldiffusion_tpu_torch.segmentor import plans_file as tplans
from ldiffusion_tpu_torch.segmentor import preprocess as tpre
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)

LARGE = {"shapes_after_crop": [[300, 320, 310], [290, 330, 300], [310, 300, 320]],
         "spacings": [[1.0, 0.9, 0.9], [1.2, 0.8, 0.8], [1.1, 0.85, 0.85]], "num_channels": 1}
FINGERPRINTS = {
    "isotropic": ({"shapes_after_crop": [[40, 48, 52], [44, 50, 48], [36, 52, 50]],
                   "spacings": [[1.0, 1.0, 1.0]] * 3, "num_channels": 2}, {}),
    "anisotropic": ({"shapes_after_crop": [[20, 96, 100], [24, 90, 96], [18, 100, 92]],
                     "spacings": [[3.5, 0.7, 0.7], [5.0, 0.7, 0.7], [4.0, 0.75, 0.75]],
                     "num_channels": 1}, {}),
    "large": (LARGE, {}),
    "resenc": (LARGE, {"planner": "resenc"}),
    "target_spacing": (LARGE, {"target_spacing": (1.5, 1.0, 1.0)}),
    "small_budget": ({"shapes_after_crop": [[24, 48, 48]] * 3, "spacings": [[1.0] * 3] * 3,
                      "num_channels": 1}, {"hbm_budget": 16 << 20}),
}
# the card phase's dataset: 4 volumes of 160x256x256 at (2.5, 0.8, 0.8)
CARD = {"shapes_after_crop": [[160, 256, 256]] * 4, "spacings": [[2.5, 0.8, 0.8]] * 4,
        "num_channels": 1}


def _asdicts(configs):
    return {k: dataclasses.asdict(v) for k, v in configs.items()}


@pytest.mark.parametrize("name", sorted(FINGERPRINTS))
def test_plans_equal_jax(name):
    fp, kw = FINGERPRINTS[name]
    want = jplan.plan_all_configurations(fp, 3, **kw)
    got = tplan.plan_all_configurations(fp, 3, **kw)
    assert _asdicts(got) == _asdicts(want)
    if name in ("large", "resenc", "small_budget"):
        assert set(got) == {"3d_fullres", "3d_lowres", "3d_cascade_fullres"}
        assert got["3d_fullres"].batch_dice and not got["3d_lowres"].batch_dice
        cascade = got["3d_cascade_fullres"].network_config()
        assert cascade.in_channels == fp["num_channels"] + 2  # the foreground labels only
    if name == "resenc":
        assert got["3d_fullres"].block_type == "residual"
    if name == "target_spacing":
        assert got["3d_fullres"].spacing == (1.5, 1.0, 1.0)


def test_card_dataset_plans_at_full_width():
    got = tplan.plan_all_configurations(CARD, 3)
    assert _asdicts(got) == _asdicts(jplan.plan_all_configurations(CARD, 3))
    full, low = got["3d_fullres"], got["3d_lowres"]
    assert (full.patch_size, full.batch_size) == ((80, 128, 128), 2)
    assert full.features_per_stage == (32, 64, 128, 256, 320, 320)
    assert low.patch_size == (112, 96, 96) and low.features_per_stage[-1] == 320
    assert got["3d_cascade_fullres"].previous_stage == "3d_lowres"


def test_segplan3d_json_round_trip(tmp_path):
    plan = tplan.plan_all_configurations(LARGE, 3)["3d_lowres"]
    plan.save(str(tmp_path / "p.json"))
    assert tplan.SegPlan3D.load(str(tmp_path / "p.json")) == plan
    j = jplan.SegPlan3D.load(str(tmp_path / "p.json"))
    assert dataclasses.asdict(j) == dataclasses.asdict(plan)
    assert dataclasses.asdict(j.network_config()) == dataclasses.asdict(plan.network_config())


def test_plans_file_inheritance_equal_jax(tmp_path):
    path = str(tmp_path / "plans_3d.json")
    tplans.save_plans_file(path, tplan.plan_all_configurations(LARGE, 3))
    jpath = str(tmp_path / "j.json")
    jplans.save_plans_file(jpath, jplan.plan_all_configurations(LARGE, 3))
    with open(path) as f, open(jpath) as g:
        plans, jplans_dict = json.load(f), json.load(g)
    assert plans["configurations"] == jplans_dict["configurations"]
    plans["configurations"]["3d_custom"] = {"inherits_from": "3d_fullres", "batch_size": 5,
                                            "patch_size": [32, 64, 64]}
    plans["configurations"]["3d_custom2"] = {"inherits_from": "3d_custom", "n_conv_per_stage": 3}
    t, j = tplans.PlansFile(plans), jplans.PlansFile(plans)
    assert t.configuration_names() == j.configuration_names()
    for name in t.configuration_names():
        assert dataclasses.asdict(t.get_configuration(name)) == \
            dataclasses.asdict(j.get_configuration(name)), name
    got = t.get_configuration("3d_custom2")
    assert (got.batch_size, got.patch_size, got.n_conv_per_stage) == (5, (32, 64, 64), 3)
    assert tplans.inherits_from(plans, "3d_custom2")["batch_size"] == 5
    plans["configurations"]["3d_fullres"]["inherits_from"] = "3d_custom2"
    with pytest.raises(ValueError, match="circular"):
        tplans.PlansFile(plans).get_configuration("3d_custom")
    with pytest.raises(KeyError):
        t.get_configuration("2d")


def _volumes(rng, n=3, shape=(12, 20, 18), channels=1):
    vols, labs = [], []
    for _ in range(n):
        v = rng.normal(size=shape + (channels,)).astype(np.float32) + 2.0
        v[:2] = 0.0   # a zero border: cropped away
        v[:, :, -3:] = 0.0
        lab = np.zeros(shape, np.int16)
        lab[4:9, 5:12, 3:10] = 1
        lab[6:8, 8:10, 4:6] = 2
        vols.append(v)
        labs.append(lab)
    return vols, labs


def test_fingerprint_3d_equal_jax(tmp_path):
    vols, labs = _volumes(np.random.default_rng(0), channels=2)
    spacings = [(3.0, 0.8, 0.8), (2.5, 0.7, 0.7), (3.5, 0.9, 0.9)]
    got = tfp.extract_fingerprint_3d(vols, labs, spacings=spacings,
                                     save_path=str(tmp_path / "t.json"))
    want = jfp.extract_fingerprint_3d(vols, labs, spacings=spacings,
                                      save_path=str(tmp_path / "j.json"))
    assert got == want
    with open(tmp_path / "t.json", "rb") as f, open(tmp_path / "j.json", "rb") as g:
        assert f.read() == g.read()
    assert got["shapes_after_crop"][0] == [10, 20, 15]


@pytest.mark.parametrize("spacing,target", [((3.0, 0.8, 0.8), (3.0, 0.8, 0.8)),
                                            ((3.0, 0.8, 0.8), (2.0, 1.0, 1.0)),
                                            ((1.0, 1.0, 1.0), (1.3, 0.7, 0.9)),
                                            ((0.8, 3.2, 0.8), (1.0, 2.0, 1.0))])
def test_preprocess_case_3d_and_cascade_channels_equal_jax(spacing, target):
    vols, labs = _volumes(np.random.default_rng(1), n=1)
    got = tpre.DefaultPreprocessor().run_case_3d(vols[0], labs[0], 3, spacing=spacing,
                                                 target_spacing=target)
    want = jpre.DefaultPreprocessor().run_case_3d(vols[0], labs[0], 3, spacing=spacing,
                                                  target_spacing=target)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.seg, want.seg)
    assert got.data.dtype == want.data.dtype and got.seg.dtype == want.seg.dtype
    locs_t, locs_j = got.properties.pop("class_locations"), want.properties.pop("class_locations")
    assert got.properties == want.properties
    assert locs_t.keys() == locs_j.keys()
    for k in locs_t:
        np.testing.assert_array_equal(locs_t[k], locs_j[k])
    prev = np.random.default_rng(2).integers(-1, 3, got.seg.shape).astype(np.int16)
    a = tpre.append_prev_stage_channels(got, prev, 3)
    b = jpre.append_prev_stage_channels(want, prev, 3)
    np.testing.assert_array_equal(a.data, b.data)
    assert a.data.shape[-1] == got.data.shape[-1] + 2
    with pytest.raises(ValueError):
        tpre.append_prev_stage_channels(got, prev[:-1], 3)


def test_plan_and_preprocess_3d_equal_jax(tmp_path):
    vols, labs = _volumes(np.random.default_rng(3), n=3, shape=(16, 32, 32))
    spacings = [(2.8, 0.9, 0.9), (3.2, 0.8, 0.8), (3.0, 0.85, 0.85)]
    kw = dict(spacings=spacings, hbm_budget=4 << 20)
    got, t_ds = tplan.plan_and_preprocess_3d(vols, labs, 3, plans_path=str(tmp_path / "t.json"),
                                             **kw)
    want, j_ds = jplan.plan_and_preprocess_3d(vols, labs, 3,
                                              plans_path=str(tmp_path / "j.json"), **kw)
    assert _asdicts(got) == _asdicts(want) and set(t_ds) == set(j_ds)
    assert "3d_lowres" in t_ds and "3d_cascade_fullres" not in t_ds
    for name in t_ds:
        for cid in t_ds[name].keys():
            np.testing.assert_array_equal(t_ds[name][cid].data, j_ds[name][cid].data)
            np.testing.assert_array_equal(t_ds[name][cid].seg, j_ds[name][cid].seg)
    with open(tmp_path / "t.json") as f, open(tmp_path / "j.json") as g:
        assert json.load(f)["configurations"] == json.load(g)["configurations"]
    # the store round trip of a 3D case
    t_ds["3d_fullres"].save(str(tmp_path / "store"))
    back = tpre.PreprocessedDataset.load(str(tmp_path / "store"))
    jback = jpre.PreprocessedDataset.load(str(tmp_path / "store"))
    for cid in back.keys():
        np.testing.assert_array_equal(back[cid].data, jback[cid].data)
        assert back[cid].seg.ndim == 3


def test_numpy_io_round_trip_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    vol = rng.normal(size=(6, 8, 10)).astype(np.float32)
    for i in range(2):
        np.save(tmp_path / f"c_000{i}.npy", vol + i)
    with open(tmp_path / "c_0000.json", "w") as f:
        json.dump({"spacing": [2.5, 0.8, 0.7]}, f)
    paths = [str(tmp_path / f"c_000{i}.npy") for i in range(2)]
    t, j = tio.NumpyIO(), jio.NumpyIO()
    (a, pa), (b, pb) = t.read_images(paths), j.read_images(paths)
    np.testing.assert_array_equal(a, b)
    assert pa == pb == {"spacing": [2.5, 0.8, 0.7]} and a.shape == (2, 6, 8, 10)
    seg = rng.integers(0, 3, (6, 8, 10))
    t.write_seg(seg, str(tmp_path / "t_seg.npy"), {"spacing": [2.5, 0.8, 0.7]})
    j.write_seg(seg, str(tmp_path / "j_seg.npy"), {"spacing": [2.5, 0.8, 0.7]})
    for ext in (".npy", ".json"):
        with open(tmp_path / f"t_seg{ext}", "rb") as f, open(tmp_path / f"j_seg{ext}", "rb") as g:
            assert f.read() == g.read()
    (sa, spa), (sb, spb) = t.read_seg(str(tmp_path / "t_seg.npy")), \
        j.read_seg(str(tmp_path / "t_seg.npy"))
    np.testing.assert_array_equal(sa, sb)
    assert spa == spb and sa.shape == (1, 6, 8, 10)
    np.save(tmp_path / "flat.npy", np.zeros((4, 4)))
    with pytest.raises(ValueError, match="Z, H, W"):
        t.read_images([str(tmp_path / "flat.npy")])
    assert type(tio.determine_reader_writer_from_dataset_json(
        {"file_ending": ".npy"})).__name__ == "NumpyIO"
    assert type(tio.determine_reader_writer_from_dataset_json(
        {"file_ending": ".png"})).__name__ == "NaturalImage2DIO"


@pytest.mark.parametrize("reader,package", [("NibabelIO", "nibabel"),
                                            ("NibabelIOWithReorient", "nibabel"),
                                            ("SimpleITKIO", "SimpleITK"),
                                            ("Tiff3DIO", "tifffile")])
def test_gated_readers_raise_naming_their_package(reader, package):
    try:
        __import__(package)
    except ImportError:
        pass
    else:  # the package is there: the reader is made
        assert getattr(tio, reader)() is not None
        return
    with pytest.raises(ImportError, match=package):
        getattr(tio, reader)()
    with pytest.raises(ImportError, match=package):
        tio.determine_reader_writer_from_dataset_json(
            {"file_ending": ".tif", "overwrite_image_reader_writer": reader})
    if package == "nibabel":
        with pytest.raises(ValueError, match="nibabel"):
            tio.determine_reader_writer(".nii.gz")
