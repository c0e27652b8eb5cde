"""The segmentor workflow after training, the port against the JAX package on
the CPU: ``find_best_configuration`` at the function level (three synthetic
configurations and their pairwise ensembles, in the plain, regions and
ignore-label regimes), and the command line on the same trained folders —
``accumulate_crossval_results``, ``find_best_configuration``,
``predict_from_modelfolder``, ``ensemble``, the model zip round trip
(``export_model`` / ``install_model`` / ``download_model`` with a
``file://`` URL) — and the refusal of volumetric configurations. The tiny
folds (two a regime) are trained once by the port; the JAX CLI reads its
checkpoints.

Tolerances:
- scores within 1e-6 (float64 sums in both; the same masks); the best
  configuration, its members and postprocessing equal;
- masks equal and the CLIs' JSON equal within 1e-6: both packages'
  predictors are patched to float32 (the CLIs' bf16 predictors disagree
  with their own f32 masks on ~1% of pixels, ROADMAP queue 3), and on these
  folds the f32 logits of the two packages give the same masks;
- float16 probabilities of the two predictors within one float16 ulp: their
  f32 logits differ by ~1e-6, which carries a value across a float16
  rounding boundary now and then (0.5-0.7% of the values here); the
  ensemble's, computed from the same files, equal;
- zip name lists equal.
"""
import json
import os
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from ldiffusion_tpu.segmentor import best_config as jbest
from ldiffusion_tpu.segmentor import cli as jcli
from ldiffusion_tpu.segmentor import model_sharing as jshare
from ldiffusion_tpu.segmentor.label_manager import label_manager_from_dataset_json as j_lm
from ldiffusion_tpu.segmentor.predictor import SlidingWindowPredictor as JPredictor
from ldiffusion_tpu_torch.segmentor import best_config as tbest
from ldiffusion_tpu_torch.segmentor import cli as tcli
from ldiffusion_tpu_torch.segmentor import model_sharing as tshare
from ldiffusion_tpu_torch.segmentor.label_manager import label_manager_from_dataset_json as t_lm
from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor as TPredictor

SCORE_TOL = 1e-6
SIZE = 24
REGIMES = {  # dataset id → (labels, regions_class_order, name)
    1: ({"background": 0, "a": 1, "b": 2, "c": 3, "ignore": 4}, None, "Ignore"),
    2: ({"background": 0, "abc": [1, 2, 3], "ab": [1, 2], "a": [1]}, [3, 2, 1], "Regions"),
    3: ({"background": 0, "a": 1, "b": 2, "c": 3}, None, "Plain"),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file: the suite runs several workers on
    one host, where tiny CPU ops lose more to oversubscribed threads than
    they gain; the previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dataset_json(did):
    labels, order, _ = REGIMES[did]
    dj = {"channel_names": {"0": "R", "1": "G", "2": "B"}, "labels": labels,
          "numTraining": 6, "file_ending": ".png"}
    if order:
        dj["regions_class_order"] = order
    return dj


def _lm(make, did):
    dj = _dataset_json(did)
    dj["labels"] = {k: tuple(v) if isinstance(v, list) else v for k, v in dj["labels"].items()}
    return make(dj)


def _blocks(rng):
    return np.kron(rng.integers(0, 4, (SIZE // 8, SIZE // 8)), np.ones((8, 8), np.int64))


# ---------------------------------------------------------------------------
# find_best_configuration at the function level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("did", sorted(REGIMES))
def test_find_best_configuration_matches_jax(did, tmp_path):
    """Three configurations whose probabilities are the ground truth blurred
    by noise of three levels (so the pairwise ensembles score differently),
    with spurious specks for the postprocessing to weigh."""
    rng = np.random.default_rng(did)
    lm_t, lm_j = _lm(t_lm, did), _lm(j_lm, did)
    heads = lm_t.num_segmentation_heads
    gts, configs = [], {"2d": [], "3d_fullres": [], "3d_lowres": []}
    for _ in range(4):
        g = _blocks(rng)
        if lm_t.has_ignore_label:
            g[:2] = lm_t.ignore_label
        gts.append(g)
        base = np.eye(heads)[np.minimum(g, heads - 1)] if not lm_t.has_regions else \
            np.stack([np.isin(g, r) for r in lm_t.regions], -1).astype(np.float64)
        for level, name in zip((0.6, 0.9, 1.2), configs):
            p = base + rng.normal(0, level, base.shape)
            p[rng.random(g.shape) < 0.02] += 3.0  # specks
            if lm_t.has_regions:
                p = 1 / (1 + np.exp(-4 * (p - 0.5)))
            else:
                e = np.exp(3 * p)
                p = e / e.sum(-1, keepdims=True)
            configs[name].append(p.astype(np.float32))
    want = jbest.find_best_configuration(configs, gts, heads, label_manager=lm_j,
                                         output_json=str(tmp_path / "j.json"))
    got = tbest.find_best_configuration(configs, gts, heads, label_manager=lm_t,
                                        output_json=str(tmp_path / "t.json"))
    assert len(got["all_results"]) == 6  # three configurations, three pairs
    for k in ("best_configuration", "ensembling_used", "members", "postprocessing"):
        assert got[k] == want[k], k
    assert got["all_results"].keys() == want["all_results"].keys()
    for k, v in want["all_results"].items():
        assert abs(got["all_results"][k] - v) <= SCORE_TOL, k
    # the plain pooled-confusion-matrix rule, without a label manager
    if did == 3:
        want = jbest.find_best_configuration(configs, gts, heads)
        got = tbest.find_best_configuration(configs, gts, heads)
        assert got["best_configuration"] == want["best_configuration"]
        assert got["postprocessing"] == want["postprocessing"]
        assert abs(got["score"] - want["score"]) <= SCORE_TOL
    np.testing.assert_array_equal(
        tbest.ensemble_probabilities(configs["2d"][:2]),
        np.asarray(jbest.ensemble_probabilities(configs["2d"][:2])))


# ---------------------------------------------------------------------------
# the command line on trained folds
# ---------------------------------------------------------------------------

def _write_dataset(raw, did):
    _, _, name = REGIMES[did]
    ds = raw / f"Dataset{did:03d}_{name}"
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        (ds / sub).mkdir(parents=True)
    rng = np.random.default_rng(did + 10)
    for i in range(6):
        lab = _blocks(rng).astype(np.uint8)
        img = np.stack([lab * 50 + 20, 200 - lab * 40, lab * 10 + 90], -1) \
            + rng.normal(0, 12, (SIZE, SIZE, 3))
        img = img.clip(0, 255).astype(np.uint8)
        if did == 1:
            lab[:3] = 4
        Image.fromarray(img).save(ds / "imagesTr" / f"case_{i:03d}_0000.png")
        Image.fromarray(lab).save(ds / "labelsTr" / f"case_{i:03d}.png")
        if i < 2:
            Image.fromarray(img[:, :SIZE - 4]).save(ds / "imagesTs" / f"ts_{i:03d}_0000.png")
    with open(ds / "dataset.json", "w") as f:
        json.dump(_dataset_json(did), f)
    return ds


@pytest.fixture(scope="module")
def folds(tmp_path_factory):
    """The port's plan_and_preprocess and folds 0 and 1 (1 epoch × 2
    iterations, --npz) of every regime."""
    root = tmp_path_factory.mktemp("workflow")
    roots = ["--raw", str(root / "raw"), "--preprocessed", str(root / "pp")]
    for did in REGIMES:
        _write_dataset(root / "raw", did)
        tcli.main(["plan_and_preprocess", "-d", str(did), *roots], device="cpu")
        for f in ("0", "1"):
            tcli.main(["train", "-d", str(did), "-f", f, "--epochs", "1", "--iters", "2", "--npz",
                       *roots, "--results", str(root / "res")], device="cpu")
    return root


def _f32(monkeypatch):
    """Both packages' predictors in float32."""
    t_from, j_init = TPredictor.from_checkpoints.__func__, JPredictor.__init__

    def t_ck(cls, plan, paths, **kw):
        return t_from(cls, plan, paths, **{**kw, "dtype": torch.float32})

    def j_new(self, plan, params, **kw):
        j_init(self, plan, params, **{**kw, "dtype": jnp.float32})

    monkeypatch.setattr(TPredictor, "from_checkpoints", classmethod(t_ck))
    monkeypatch.setattr(JPredictor, "__init__", j_new)


def _json_close(a, b, path="$"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _json_close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _json_close(x, y, f"{path}[{i}]")
    elif isinstance(b, float) and not isinstance(a, bool):
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= SCORE_TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _same_predictions(a, b, ulp=0):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for f in names:
        if f.endswith(".png"):
            with Image.open(os.path.join(a, f)) as x, Image.open(os.path.join(b, f)) as y:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
        elif f.endswith(".npz"):
            with np.load(os.path.join(a, f)) as x, np.load(os.path.join(b, f)) as y:
                assert x["probabilities"].dtype == y["probabilities"].dtype == np.float16
                np.testing.assert_array_max_ulp(x["probabilities"], y["probabilities"], ulp)


@pytest.mark.parametrize("did", sorted(REGIMES))
def test_workflow_commands_match_the_jax_cli(did, folds, monkeypatch):
    root = folds
    _f32(monkeypatch)
    name = f"Dataset{did:03d}_{REGIMES[did][2]}"
    cfg_dir = root / "res" / name / "nnUNetTrainer__ldPlans__2d"
    roots = ["--raw", str(root / "raw"), "--preprocessed", str(root / "pp"),
             "--results", str(root / "res")]

    def both(argv, out=None):
        """Each CLI on the same inputs; ``out`` names the output flag's folder."""
        res = {}
        for side, run in (("t", lambda a: tcli.main(a, device="cpu")), ("j", jcli.main)):
            res[side] = run([a.replace("{side}", side) for a in argv])
        return res

    # accumulate_crossval_results: the two folds' validation summaries
    acc = both(["accumulate_crossval_results", "-m", str(cfg_dir),
                "-o", str(root / f"cv_{did}_{{side}}.json")])
    _json_close(acc["t"], acc["j"])
    assert len(acc["t"]["metric_per_case"]) == 2 + 1  # fold 0 validates 2 cases, fold 1 one
    # find_best_configuration: each fold predicts its own validation cases
    info = {}
    for side, run in (("t", lambda a: tcli.main(a, device="cpu")), ("j", jcli.main)):
        run(["find_best_configuration", "-d", str(did), *roots])
        with open(root / "res" / name / "inference_information.json") as f:
            info[side] = json.load(f)
    _json_close(info["t"], info["j"])
    assert info["t"]["best_configuration"] == "2d" and np.isfinite(info["t"]["score"])
    # predict_from_modelfolder over both folds, and fold 0 alone
    inp = str(root / "raw" / name / "imagesTs")
    for folds_, tag in ((["0", "1"], "01"), (["0"], "0")):
        both(["predict_from_modelfolder", "-i", inp, "-o", str(root / f"pm{tag}_{did}_{{side}}"),
              "-m", str(cfg_dir), "-f", *folds_, "--save_probabilities"])
        _same_predictions(str(root / f"pm{tag}_{did}_t"), str(root / f"pm{tag}_{did}_j"), ulp=1)
    # ensemble of the two folders (-d paints the regions through the label manager)
    both(["ensemble", "-i", str(root / f"pm01_{did}_t"), str(root / f"pm0_{did}_t"),
          "-o", str(root / f"ens_{did}_{{side}}"), "--save_npz",
          *(["-d", str(did), "--raw", str(root / "raw")] if did == 2 else [])])
    _same_predictions(str(root / f"ens_{did}_t"), str(root / f"ens_{did}_j"))


def test_model_zip_round_trip(folds, tmp_path, monkeypatch):
    """A flat model folder exports the JAX package's names; a results folder
    (checkpoints in fold_*), which the JAX export refuses, exports its folds,
    and its installed copy predicts the masks the original does."""
    _f32(monkeypatch)
    home = tmp_path / "home"  # the downloads' temporary files land here, then go
    home.mkdir()
    monkeypatch.setenv("HOME", str(home))
    cfg_dir = folds / "res" / "Dataset003_Plain" / "nnUNetTrainer__ldPlans__2d"
    flat = tmp_path / "flat"
    flat.mkdir()
    for f in ("plans.json", "fold_0/checkpoint_final.pkl", "fold_0/training_log.txt",
              "fold_0/postprocessing.json"):
        (flat / os.path.basename(f)).write_bytes((cfg_dir / f).read_bytes())
    names = {}
    for side, share in (("t", tshare), ("j", jshare)):
        z = share.export_model(str(flat), str(tmp_path / f"flat_{side}.zip"))
        with zipfile.ZipFile(z) as zf:
            names[side] = zf.namelist()
        share.import_model(z, str(tmp_path / f"inst_{side}"))
        share.download_and_install_from_url("file://" + z, str(tmp_path / f"dl_{side}"))
    assert names["t"] == names["j"] and "checkpoint_final.pkl" in names["t"]
    for sub in ("inst", "dl"):
        assert sorted(os.listdir(tmp_path / f"{sub}_t")) == sorted(os.listdir(tmp_path / f"{sub}_j"))
    assert os.listdir(home) == []
    with pytest.raises(AssertionError, match="no checkpoint"):
        jshare.export_model(str(cfg_dir), str(tmp_path / "cfg_j.zip"))
    zpath = str(tmp_path / "model.zip")
    tcli.main(["export_model", str(cfg_dir), "-o", zpath], device="cpu")
    with zipfile.ZipFile(zpath) as zf:
        got = set(zf.namelist())
    assert {"plans.json", "dataset.json", "fold_0/checkpoint_final.pkl",
            "fold_1/checkpoint_final.pkl", "fold_1/postprocessing.json"} <= got
    assert not any("validation" in n for n in got)
    installed = tmp_path / "installed" / cfg_dir.name
    tcli.main(["install_model", zpath, "-o", str(installed)], device="cpu")
    tcli.main(["download_model", "file://" + zpath, "-o", str(tmp_path / "downloaded")],
              device="cpu")
    assert sorted(os.listdir(tmp_path / "downloaded")) == sorted(os.listdir(installed))
    inp = str(folds / "raw" / "Dataset003_Plain" / "imagesTs")
    for src, out in ((cfg_dir, "orig"), (installed, "inst")):
        tcli.main(["predict_from_modelfolder", "-i", inp, "-o", str(tmp_path / out), "-m",
                   str(src), "-f", "0", "1"], device="cpu")
    _same_predictions(str(tmp_path / "orig"), str(tmp_path / "inst"))
    bad = tmp_path / "notazip.bin"
    bad.write_bytes(b"garbage")
    for share in (tshare, jshare):
        with pytest.raises(zipfile.BadZipFile):
            share.download_and_install_from_url("file://" + str(bad), str(tmp_path / "x"))
    assert os.listdir(home) == []


def test_volumetric_configurations_are_refused_as_jax_cannot_score_them(tmp_path):
    """The JAX command reads the 2D store (ldPlans_2d) and loads every
    configuration's plans as a 2D plan: on a volumetric dataset it fails
    with FileNotFoundError; the port refuses ``-c 3d_*`` naming the reason,
    and with ``-c 2d`` fails as JAX does."""
    ds = tmp_path / "raw" / "Dataset311_Vol3D"
    (ds / "imagesTr").mkdir(parents=True)
    with open(ds / "dataset.json", "w") as f:
        json.dump({"channel_names": {"0": "CT"}, "labels": {"background": 0, "a": 1},
                   "numTraining": 0, "file_ending": ".npy"}, f)
    argv = ["find_best_configuration", "-d", "311", "--raw", str(tmp_path / "raw"),
            "--preprocessed", str(tmp_path / "pp"), "--results", str(tmp_path / "res")]
    for configs in (["3d_fullres"], ["2d", "3d_lowres"]):
        with pytest.raises(FileNotFoundError, match="ldPlans_2d"):
            jcli.main(argv + ["-c", *configs])
        with pytest.raises(SystemExit, match="only the 2d configuration"):
            tcli.main(argv + ["-c", *configs], device="cpu")
    for run in (jcli.main, lambda a: tcli.main(a, device="cpu")):
        with pytest.raises(FileNotFoundError, match="ldPlans_2d"):
            run(argv + ["-c", "2d"])
