"""The host-side modules of the workflow after training, the port against the
JAX package on the same inputs, on the CPU: the 11 public-dataset
converters through both packages' ``python -m`` entries on the synthetic
sources of ``test_public_converters``, the dataset converters, the CLI's
``convert_msd`` / ``convert_old_dataset`` / ``move_plans`` /
``plot_overlays``, ``batch_running``'s collectors and summarizers,
``utils``, ``rgbd`` and ``core/prng``.

Tolerances: exact throughout — the same files, JSON byte for byte, arrays
and PNG pixels equal, CSV text equal — except micro-Dice (float32 sums in
another order: 1e-6) and the Laplace draws' moments (a statistical bound).
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from ldiffusion_tpu import utils as jutils
from ldiffusion_tpu.core.prng import laplace as jlaplace
from ldiffusion_tpu.data import converters as jconv
from ldiffusion_tpu.data import labels as jlabels
from ldiffusion_tpu.data import public_converters as jpc
from ldiffusion_tpu.data import rgbd as jrgbd
from ldiffusion_tpu.segmentor import batch_running as jbatch
from ldiffusion_tpu.segmentor import cli as jcli
from ldiffusion_tpu_torch import utils as tutils
from ldiffusion_tpu_torch.core import prng
from ldiffusion_tpu_torch.data import converters as tconv
from ldiffusion_tpu_torch.data import labels as tlabels
from ldiffusion_tpu_torch.data import public_converters as tpc
from ldiffusion_tpu_torch.data import rgbd as trgbd
from ldiffusion_tpu_torch.diffusion.schedulers import laplace_noise
from ldiffusion_tpu_torch.segmentor import batch_running as tbatch
from ldiffusion_tpu_torch.segmentor import cli as tcli
from test_public_converters import _make_amos, _make_mnms, _touch
from torch_port_common import two_torch_threads  # noqa: F401 (autouse)


def same_tree(a, b):
    """Two directories hold the same files: JSON and text byte for byte, .npy
    arrays and PNG pixels equal, anything else byte for byte."""
    fa = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    fb = sorted(os.path.relpath(os.path.join(r, f), b) for r, _, fs in os.walk(b) for f in fs)
    assert fa == fb and fa, (fa, fb)
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        elif f.endswith(".png"):
            with Image.open(pa) as x, Image.open(pb) as y:
                assert x.mode == y.mode and np.array_equal(np.asarray(x), np.asarray(y)), f
        else:
            with open(pa, "rb") as x, open(pb, "rb") as y:
                assert x.read() == y.read(), f


# ---------------------------------------------------------------------------
# the 11 public converters, through both entry points
# ---------------------------------------------------------------------------

def _brats(src):
    rng = np.random.default_rng(1)
    for case in ("BraTS2021_00000", "BraTS2021_00002"):
        os.makedirs(src / case)
        for mod in jpc.BRATS_MODALITIES:
            np.save(str(src / case / f"{case}_{mod}.npy"), rng.random((3, 6, 6), dtype=np.float32))
        np.save(str(src / case / f"{case}_seg.npy"),
                rng.choice([0, 1, 2, 4], size=(3, 6, 6)).astype(np.int16))


def _road(src):
    rng = np.random.default_rng(2)
    for split in ("training", "testing"):
        os.makedirs(src / split / "input")
        os.makedirs(src / split / "output")
        img = rng.integers(80, 255, (24, 24, 3)).astype(np.uint8)
        img[2:14, 2:14] = 255  # a white no-data block
        seg = np.zeros((24, 24), np.uint8)
        seg[:, 6] = 255
        Image.fromarray(img).save(src / split / "input" / "a.png")
        Image.fromarray(seg).save(src / split / "output" / "a.png")
        Image.fromarray(img).save(src / split / "input" / "b.png")  # no label: skipped


def _source(name, tmp_path):
    """Build each converter's synthetic source under tmp_path/src; returns the
    extra argv (with ``{pp}`` for the preprocessed root), or (extra argv,
    source folder) where the source is not tmp_path/src."""
    src = tmp_path / "src"
    if name == "acdc":
        for p, frames in (("patient001", (1, 12)), ("patient002", (2, 9))):
            for fr in frames:
                _touch(str(src / "training" / p / f"{p}_frame{fr:02d}.nii.gz"), p.encode())
                _touch(str(src / "training" / p / f"{p}_frame{fr:02d}_gt.nii.gz"))
            _touch(str(src / "training" / p / f"{p}_4d.nii.gz"))
        _touch(str(src / "testing" / "patient101" / "patient101_frame01.nii.gz"))
        return []
    if name == "emidec":
        for p in ("Case_P001", "Case_P002"):
            _touch(str(src / "train" / p / "Images" / f"{p}.nii.gz"), p.encode())
            _touch(str(src / "train" / p / "Contours" / f"{p}.nii.gz"))
        _touch(str(src / "test" / "Case_T001" / "Images" / "Case_T001.nii.gz"))
        return ["-t", str(src / "test")], src / "train"
    if name == "mnms":
        root, csv_name, _ = _make_mnms(tmp_path)
        os.rename(root, src)
        return ["-c", csv_name]
    if name == "fluo_c3dh":
        for seq in ("01", "02"):
            for i in range(2):
                _touch(str(src / seq / f"t{i:03d}.tif"), f"{seq}{i}".encode())
                _touch(str(src / f"{seq}_GT" / "SEG" / f"man_seg{i:03d}.tif"))
        return ["--preprocessed_root", "{pp}"]
    if name == "road":
        _road(src)
        return []
    if name == "brats21":
        _brats(src)
        return []
    if name in ("amos_task1", "amos_task2"):
        os.rename(_make_amos(tmp_path), src)
        return []
    if name == "kits2023":
        for c in ("case_00000", "case_00001", "case_00003"):
            _touch(str(src / c / "imaging.nii.gz"), c.encode())
            _touch(str(src / c / "segmentation.nii.gz"))
        return []
    if name == "autopet":
        for i in range(7):
            for acq in ("2020-01-01", "2021-06-15")[: 1 + i % 2]:
                for fn in ("CTres.nii.gz", "SUV.nii.gz", "SEG.nii.gz"):
                    _touch(str(src / f"PETCT_{i:03d}" / acq / fn), fn.encode())
        return ["--preprocessed_root", "{pp}"]
    raise KeyError(name)


# the converters whose command line reads the sources' contents as .nii.gz
# (nibabel): driven through their functions on .npy sources
NPY_ONLY = {"mnms": lambda mod, src, raw, csv: mod.convert_mnms(src, csv, raw_root=raw,
                                                                file_ending=".npy"),
            "brats21": lambda mod, src, raw: mod.convert_brats21(src, raw_root=raw,
                                                                 file_ending=".npy")}
CONVERTERS = ["acdc", "emidec", "mnms", "fluo_c3dh", "road", "brats21", "amos_task1",
              "amos_task2", "kits2023", "autopet", "filelist_dataset"]


@pytest.mark.parametrize("name", CONVERTERS)
def test_public_converter_writes_what_the_jax_one_writes(name, tmp_path, capsys):
    """Each converter through ``python -m ...public_converters`` of both
    packages (``main(argv)``) on one synthetic source: the same raw dataset
    (and the same splits_final.json where the converter writes one)."""
    out = {}
    if name == "filelist_dataset":
        src = tmp_path / "Dataset900_Source"
        jconv.generate_integration_test_dataset(str(src), n_cases=4, size=20, num_classes=3)
        for side, mod in (("j", jpc), ("t", tpc)):
            out[side] = tmp_path / side / "Dataset988_Filelist"
            mod.main(["filelist_dataset", "-i", str(src), "-o", str(out[side])])
        same_tree(str(out["j"]), str(out["t"]))
        return
    made = _source(name, tmp_path)
    extra, src = (made if isinstance(made, tuple) else (made, tmp_path / "src"))
    for side, mod in (("j", jpc), ("t", tpc)):
        raw = str(tmp_path / side / "raw")
        if name in NPY_ONLY:  # their entry reads .nii.gz through nibabel: .npy by function
            NPY_ONLY[name](mod, str(src), raw, *extra[1:])
            continue
        argv = [name, "-i", str(src), "--raw_root", raw]
        argv += [a.replace("{pp}", str(tmp_path / side / "pp")) for a in extra]
        mod.main(argv)
        assert "done:" in capsys.readouterr().out
    for sub in ("raw", "pp"):
        if os.path.isdir(tmp_path / "j" / sub):
            same_tree(str(tmp_path / "j" / sub), str(tmp_path / "t" / sub))


def test_brats_back_conversion_and_mnms_splits_equal_jax(tmp_path):
    _brats(tmp_path / "src")
    raw = tmp_path / "raw"
    out = tpc.convert_brats21(str(tmp_path / "src"), raw_root=str(raw), file_ending=".npy")
    labels = os.path.join(out, "labelsTr")
    assert jpc.convert_folder_with_preds_back_to_brats(labels, str(tmp_path / "bj"), ".npy") == \
        tpc.convert_folder_with_preds_back_to_brats(labels, str(tmp_path / "bt"), ".npy") == 2
    same_tree(str(tmp_path / "bj"), str(tmp_path / "bt"))
    tpc.main(["brats21_convert_back", "-i", labels, "-o", str(tmp_path / "bm")])
    src, csv_name, _ = _make_mnms(tmp_path, n_a=3, n_b=4)
    for side, mod in (("j", jpc), ("t", tpc)):
        with open(tmp_path / f"splits_{side}.json", "w") as f:
            json.dump([{"train": ["x"], "val": ["y"]}] * 5, f)
        mod.create_mnms_custom_splits(str(src), csv_name, str(tmp_path / f"splits_{side}.json"),
                                      num_val_patients=1)
    with open(tmp_path / "splits_j.json", "rb") as f, open(tmp_path / "splits_t.json", "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(RuntimeError):
        tpc.brats_labels_to_nnunet(np.array([0, 3]))


# ---------------------------------------------------------------------------
# data/converters.py and the CLI's converters
# ---------------------------------------------------------------------------

def test_dataset_converters_equal_jax(tmp_path):
    kw = dict(channel_names={0: "CT", 1: "MR"}, labels={"background": 0, "a": np.int64(1),
                                                        "whole": (1, 2)},
              num_training_cases=3, file_ending=".png", regions_class_order=(1, 2),
              license="L", dataset_name="D", reference="R", release="1",
              description="d", overwrite_image_reader_writer="NumpyIO", extra_key="kept")
    assert jconv.generate_dataset_json(str(tmp_path / "gj"), **kw) == \
        tconv.generate_dataset_json(str(tmp_path / "gt"), **kw)
    same_tree(str(tmp_path / "gj"), str(tmp_path / "gt"))
    with pytest.raises(ValueError):
        tconv.generate_dataset_json(str(tmp_path), {0: "CT"}, {"r": (1, 2)}, 1, ".png")
    for regime in ("plain", "ignore", "regions", "regions_ignore"):
        for side, mod in (("j", jconv), ("t", tconv)):
            mod.generate_integration_test_dataset(str(tmp_path / side / regime), n_cases=4,
                                                  size=20, num_classes=3, seed=5,
                                                  regime=regime)
        same_tree(str(tmp_path / "j" / regime), str(tmp_path / "t" / regime))
    # PUMA pixel-convention masks and the folder converter
    rng = np.random.default_rng(3)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "labs").mkdir()
    for i in range(4):
        Image.fromarray(rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)).save(
            tmp_path / "imgs" / f"roi{i}.png")
        Image.fromarray(rng.choice([0, 100, 150, 50, 200, 250, 255, 7], (16, 16))
                        .astype(np.uint8)).save(tmp_path / "labs" / f"roi{i}.png")
    for side, mod in (("j", jconv), ("t", tconv)):
        mod.convert_puma(str(tmp_path / "imgs"), str(tmp_path / "labs"),
                         str(tmp_path / side / "puma"))
        mod.convert_folder_dataset(str(tmp_path / "imgs"), str(tmp_path / "labs"),
                                   str(tmp_path / side / "folder"), 3)
        mod.create_filelist_dataset(str(tmp_path / side / "plain"),
                                    str(tmp_path / side / "filelist"))
    for sub in ("puma", "folder", "filelist"):
        same_tree(str(tmp_path / "j" / sub), str(tmp_path / "t" / sub))


def _msd_and_old(tmp_path):
    msd = tmp_path / "Task09_Spleen"
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        os.makedirs(msd / sub)
        for i in range(2):
            np.save(str(msd / sub / f"spleen_{i}.npy"), np.full((2, 3), i, np.int16))
    _touch(str(msd / "imagesTr" / ".hidden"))
    with open(msd / "dataset.json", "w") as f:
        json.dump({"name": "Spleen", "modality": {"0": "CT"}, "numTraining": 2,
                   "labels": {"0": "background", "1": "spleen"}, "training": []}, f)
    old = tmp_path / "Task02_Old"
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(old / sub)
        np.save(str(old / sub / "a.npy"), np.arange(6, dtype=np.uint8))
    with open(old / "dataset.json", "w") as f:
        json.dump({"name": "Old", "modality": {"0": "MR", "1": "T2"}, "tensorImageSize": "4D",
                   "labels": {"0": "background", "1": "tumor", "2": "edema"},
                   "numTraining": 1, "numTest": 0, "training": [{"image": "x"}],
                   "test": []}, f)
    return msd, old


def test_cli_converters_and_move_plans_equal_jax(tmp_path):
    msd, old = _msd_and_old(tmp_path)
    for side, cli in (("j", jcli.main), ("t", lambda a: tcli.main(a, device="cpu"))):
        cli(["convert_msd", "-i", str(msd), "-o", str(tmp_path / side / "Dataset009_Spleen")])
        cli(["convert_old_dataset", "-i", str(old), "-o",
             str(tmp_path / side / "Dataset002_Old"), "--file_ending", ".npy"])
    for sub in ("Dataset009_Spleen", "Dataset002_Old"):
        same_tree(str(tmp_path / "j" / sub), str(tmp_path / "t" / sub))
    raw = tmp_path / "raw"
    for i in (5, 6):
        jconv.generate_integration_test_dataset(str(raw / f"Dataset{i:03d}_Test"), n_cases=2,
                                                size=20, num_classes=2)
    for side, cli in (("j", jcli.main), ("t", lambda a: tcli.main(a, device="cpu"))):
        pp = tmp_path / side / "pp"
        os.makedirs(pp / "Dataset005_Test")
        with open(pp / "Dataset005_Test" / "plans.json", "w") as f:
            f.write('{"patch_size": [16, 16]}')
        cli(["move_plans", "-s", "5", "-t", "6", "--raw", str(raw), "--preprocessed", str(pp)])
    same_tree(str(tmp_path / "j" / "pp"), str(tmp_path / "t" / "pp"))


def test_plot_overlays_pixel_equal_jax(tmp_path):
    rng = np.random.default_rng(9)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "segs").mkdir()
    for case in ("a", "b"):
        Image.fromarray(rng.integers(0, 255, (12, 14, 3)).astype(np.uint8)).save(
            tmp_path / "imgs" / f"{case}_0000.png")
        Image.fromarray(rng.integers(0, 14, (12, 14)).astype(np.uint8)).save(
            tmp_path / "segs" / f"{case}.png")
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(tmp_path / "imgs" / "c.png")  # no mask
    jcli.main(["plot_overlays", str(tmp_path / "imgs"), str(tmp_path / "segs"), "-o",
               str(tmp_path / "oj")])
    tcli.main(["plot_overlays", str(tmp_path / "imgs"), str(tmp_path / "segs"), "-o",
               str(tmp_path / "ot")], device="cpu")
    same_tree(str(tmp_path / "oj"), str(tmp_path / "ot"))
    assert sorted(os.listdir(tmp_path / "ot")) == ["a.png", "b.png"]


# ---------------------------------------------------------------------------
# batch_running
# ---------------------------------------------------------------------------

def _results(root):
    rng = np.random.default_rng(11)
    for ds in ("Dataset001_A", "Dataset002_B"):
        for tr, plans in (("nnUNetTrainer", "ldPlans"), ("nnUNetTrainerDA5", "ldPlans"),
                          ("nnUNetTrainer", "resM")):
            for config in ("2d", "3d_fullres"):
                if ds.endswith("B") and config == "3d_fullres" and plans == "resM":
                    continue
                for fold in (0, 1, 3):
                    if rng.random() < 0.2:
                        continue
                    d = tbatch.get_output_folder(str(root), ds, tr, plans, config, fold)
                    os.makedirs(os.path.join(d, "validation"))
                    with open(os.path.join(d, "validation", "summary.json"), "w") as f:
                        json.dump({"foreground_mean": {"Dice": float(rng.random())}}, f)


def test_batch_running_collectors_and_summaries_equal_jax(tmp_path):
    _results(tmp_path / "res")
    trainers = {"nnUNetTrainer": ["ldPlans", "resM"], "nnUNetTrainerDA5": ["ldPlans"]}
    datasets = ["Dataset001_A", "Dataset002_B", "Dataset003_None"]
    rows = {}
    for side, mod in (("j", jbatch), ("t", tbatch)):
        rows[side] = mod.collect_crossval_results(str(tmp_path / "res"), trainers, datasets,
                                                  str(tmp_path / f"cv_{side}.csv"))
        mod.summarize_crossval(str(tmp_path / f"cv_{side}.csv"),
                               str(tmp_path / f"sum_{side}.csv"), [0, 1, 3],
                               ["2d", "3d_fullres"], datasets, trainers)
    assert json.dumps(rows["j"]) == json.dumps(rows["t"])
    for stem in ("cv", "sum"):
        with open(tmp_path / f"{stem}_j.csv") as f, open(tmp_path / f"{stem}_t.csv") as g:
            assert f.read() == g.read()
    dirs = [tbatch.get_output_folder(str(tmp_path / "res"), "Dataset001_A", "nnUNetTrainer",
                                     "ldPlans", "2d", f) for f in range(5)]
    assert jbatch.collect_results(dirs) == tbatch.collect_results(dirs)
    assert tbatch.get_output_folder("r", "D", "T", "P", "2d") == \
        jbatch.get_output_folder("r", "D", "T", "P", "2d")
    for i, line in enumerate(('{"value": 3.5, "metric": "x"}', "noise",
                              '{"value": 7.25}\n{"value": 1}')):
        (tmp_path / f"b{i}.jsonl").write_text(line + "\n")
    paths = [str(tmp_path / f"b{i}.jsonl") for i in range(3)]
    assert jbatch.summarize_benchmarks(paths, str(tmp_path / "bj.json")) == \
        tbatch.summarize_benchmarks(paths, str(tmp_path / "bt.json"))
    with open(tmp_path / "bj.json", "rb") as f, open(tmp_path / "bt.json", "rb") as g:
        assert f.read() == g.read()


def test_training_commands_and_local_runs(tmp_path):
    """The local launcher's commands are the JAX package's with the port's
    module; the gcloud launcher raises; ``run_local`` runs and logs each."""
    want = jbatch.generate_training_commands(["D1", "D2"], ["default", "da5"], [0, 1],
                                             launcher="local")
    got = tbatch.generate_training_commands(["D1", "D2"], ["default", "da5"], [0, 1])
    assert got == [c.replace("ldiffusion_tpu.ldiffusion", "ldiffusion_tpu_torch.ldiffusion")
                   for c in want] and len(got) == 8
    with pytest.raises(ValueError, match="gcloud"):
        tbatch.generate_training_commands(["D1"], launcher="gcloud")
    cmds = ["echo one", "exit 3", "echo three"]
    recs = tbatch.run_local(cmds, str(tmp_path / "t"), stop_on_error=True, env={"X": "1"})
    jrecs = jbatch.run_local(cmds, str(tmp_path / "j"), stop_on_error=True, env={"X": "1"})
    strip = [{k: r[k] for k in ("cmd", "returncode")} for r in recs]
    assert strip == [{k: r[k] for k in ("cmd", "returncode")} for r in jrecs]
    assert [r["returncode"] for r in recs] == [0, 3]
    with open(tmp_path / "t" / "run_000.log") as f:
        assert f.read() == "$ echo one\none\n"


# ---------------------------------------------------------------------------
# utils, rgbd, prng
# ---------------------------------------------------------------------------

def test_utils_equal_jax(tmp_path):
    rng = np.random.default_rng(12)
    masks = np.zeros((2, 32, 32), np.int64)
    masks[0, 5:10, 5:10] = 1
    masks[0, 20:26, 20:26] = 2
    masks[1, 3:30, 12:14] = 2
    hm = tutils.generate_multi_class_heatmaps(masks, 3, sigma=2)
    np.testing.assert_array_equal(hm, jutils.generate_multi_class_heatmaps(masks, 3, sigma=2))
    for k, thr in ((3, 0.5), (2, 2.0)):
        got, want = tutils.extract_topk_points(hm, k, score_threshold=thr), \
            jutils.extract_topk_points(hm, k, score_threshold=thr)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    logits = rng.normal(size=(2, 12, 12, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 12, 12))
    for pred in (logits, np.moveaxis(logits, -1, 1), labels):
        s_t, m_t = tutils.micro_dice(pred, labels, 4)
        s_j, m_j = jutils.micro_dice(pred, labels, 4)
        np.testing.assert_allclose(s_t, s_j, atol=1e-6)
        assert abs(m_t - m_j) <= 1e-6
    for pred in (logits, np.moveaxis(logits, -1, 1), labels, np.zeros_like(labels)):
        assert tutils.mean_iou_and_per_class(pred, labels, 4) == \
            jutils.mean_iou_and_per_class(pred, labels, 4)
    img = rng.integers(0, 255, (6, 5, 3)).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "x.png")
    for inp in (str(tmp_path / "x.png"), Image.fromarray(img), img, img[..., 0]):
        np.testing.assert_array_equal(tutils.load_image_to_numpy(inp),
                                      jutils.load_image_to_numpy(inp))
    for arr in (img.astype(np.float32), img[..., 0].astype(np.float32)):
        np.testing.assert_array_equal(tutils.prepare_image_for_predictor(arr),
                                      jutils.prepare_image_for_predictor(arr))
    seg = rng.integers(0, 15, (6, 5))
    for image in (img, img / 255.0):
        tutils.save_segmentation_overlay(image, seg, str(tmp_path / "t" / "o.png"))
        jutils.save_segmentation_overlay(image, seg, str(tmp_path / "j" / "o.png"))
        same_tree(str(tmp_path / "j"), str(tmp_path / "t"))


def test_rgbd_canny_mask_and_dataset_equal_jax(tmp_path):
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[:48, :48]
    img = (((xx > 20) * 200 + (yy - 24) ** 2 / 4 + rng.normal(0, 8, (48, 48)))
           .clip(0, 255).astype(np.uint8))
    for lo, hi in ((100, 200), (20, 60)):
        np.testing.assert_array_equal(trgbd.canny_edges(img, lo, hi),
                                      jrgbd.canny_edges(img, lo, hi))
    assert trgbd.canny_edges(img, 20, 60).any()
    mask = rng.choice([0, 60, 120, 180, 255, 7], (9, 9)).astype(np.uint8)
    np.testing.assert_array_equal(trgbd.map_mask(mask), jrgbd.map_mask(mask))
    np.testing.assert_array_equal(tlabels.label_lut("rgbd"), jlabels.label_lut("rgbd"))
    for sub in ("rgb", "dtm", "masks"):
        os.makedirs(tmp_path / "train" / sub)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (40, 40, 3)).astype(np.uint8)).save(
            tmp_path / "train" / "rgb" / f"{i}.tif")
        Image.fromarray(img[:40, :40]).save(tmp_path / "train" / "dtm" / f"{i}.tif")
        Image.fromarray(mask).save(tmp_path / "train" / "masks" / f"{i}.tif")
    tds = trgbd.RgbDtmMaskDataset(str(tmp_path), image_size=32, mask_size=16)
    jds = jrgbd.RgbDtmMaskDataset(str(tmp_path), image_size=32, mask_size=16)
    assert len(tds) == len(jds) == 2
    for k, v in jds[1].items():
        np.testing.assert_array_equal(tds[1][k], v, err_msg=k)


def test_prng_laplace_and_fold_in():
    """Laplace(0, scale) by the JAX package's inverse CDF (``laplace_noise``),
    scaled; ``fold_in_step`` gives reproducible, distinct streams."""
    g = prng.fold_in_step(7, 3, 11)
    x = prng.laplace(g, (200_000,), 0.5)
    np.testing.assert_array_equal(
        x.numpy(), (laplace_noise((200_000,), prng.fold_in_step(7, 3, 11)) * 0.5).numpy())
    assert abs(float(x.mean())) < 0.01 and abs(float(x.abs().mean()) - 0.5) < 0.01
    per_t = torch.tensor([0.1, 1.0, 4.0])
    y = prng.laplace(prng.fold_in_step(0), (4000, 3), per_t)
    np.testing.assert_allclose(y.abs().mean(0).numpy(), per_t.numpy(), rtol=0.1)
    a = [prng.laplace(prng.fold_in_step(1, e, s), (8,), 1.0) for e, s in ((0, 0), (0, 1), (1, 0))]
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert torch.equal(a[1], prng.laplace(prng.fold_in_step(1, 0, 1), (8,), 1.0))
    # the JAX sampler's moments at the same scale (its own key)
    j = np.asarray(jlaplace(jax.random.key(0), (200_000,), 0.5))
    assert abs(float(np.abs(j).mean()) - float(x.abs().mean())) < 0.01
