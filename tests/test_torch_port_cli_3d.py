"""The volumetric segmentor command line of the port against the JAX
package's, on the CPU on a tiny ``.npy`` dataset (three 16x32x32 volumes with
an anisotropic spacing sidecar, and a small ``--hbm_budget`` so that every 3D
configuration is planned): ``plan_and_preprocess`` of both CLIs, then the
port's ``train -c 3d_lowres`` → ``train -c 3d_cascade_fullres`` (two
iterations each) and ``predict -c 3d_cascade_fullres`` (inline lowres stage
and ``-prev_stage_predictions``), against the JAX CLI's ``predict`` reading
the port's results (its checkpoints hold ``dynunet3d_to_flax``'s tree), and
``evaluate_folder`` on the validation ``.npy`` cases.

Tolerances:
- plans_3d.json, dataset_fingerprint.json and the preprocessed stores: equal;
- masks of the JAX CLI reading the port's checkpoints against the port's own,
  both predictors patched to float32: equal on >= 99.5% of voxels, the
  2D CLI's slice tolerance (``test_torch_port_cli``); the inline and
  ``-prev_stage_predictions`` cascade routes of the port: equal;
- ``summary.json`` of the same folders: equal.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldiffusion_tpu.core.checkpoint import load_pytree as j_load_pytree
from ldiffusion_tpu.segmentor import cli as jcli
from ldiffusion_tpu.segmentor.predictor import SlidingWindowPredictor as JPredictor
from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
from ldiffusion_tpu_torch.models.convert import dynunet3d_to_flax, flatten_tree
from ldiffusion_tpu_torch.segmentor import cli as tcli
from ldiffusion_tpu_torch.segmentor.planner3d import SegPlan3D
from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor as TPredictor
from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer

DSID = 311
NAME = f"Dataset{DSID}_Vol3D"
BUDGET = str(16 << 20)  # a 16 MiB planning budget: every 3D configuration
SPACING = [2.5, 0.8, 0.8]
MASK_AGREEMENT = 0.995


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_dataset(root):
    ds = root / "raw" / NAME
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        (ds / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        lab = np.zeros((16, 32, 32), np.uint8)
        z0, y0 = rng.integers(2, 6), rng.integers(4, 12)
        lab[z0:z0 + 8, y0:y0 + 14, 8:24] = 1
        lab[z0 + 2:z0 + 5, y0 + 3:y0 + 8, 12:18] = 2
        vol = (rng.random((16, 32, 32)) + 0.1 + lab).astype(np.float32)
        split, case = ("Ts", f"t{i}") if i == 3 else ("Tr", f"case{i}")
        np.save(ds / f"images{split}" / f"{case}_0000.npy", vol)
        np.save(ds / f"labels{split}" / f"{case}.npy", lab)
        with open(ds / f"images{split}" / f"{case}_0000.json", "w") as f:
            json.dump({"spacing": SPACING}, f)
    with open(ds / "dataset.json", "w") as f:
        json.dump({"channel_names": {"0": "CT"}, "labels": {"background": 0, "a": 1, "b": 2},
                   "numTraining": 3, "file_ending": ".npy"}, f)


def _port(args, root, *extra):
    flags = {"plan_and_preprocess": ["--raw", "--preprocessed"],
             "train": ["--raw", "--preprocessed", "--results"],
             "predict": ["--raw", "--results"]}.get(args[0], [])
    where = {"--raw": root / "raw", "--preprocessed": root / "pp_t", "--results": root / "res"}
    return tcli.main(list(args) + [x for f in flags for x in (f, str(where[f]))] + list(extra),
                     device="cpu")


def _jax(args, root):
    flags = {"plan_and_preprocess": ["--raw", "--preprocessed"],
             "predict": ["--raw", "--results"]}.get(args[0], [])
    where = {"--raw": root / "raw", "--preprocessed": root / "pp_j", "--results": root / "res"}
    return jcli.main(list(args) + [x for f in flags for x in (f, str(where[f]))])


def _tree_equal(a, b):
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if os.path.isdir(pa):
            _tree_equal(pa, pb)
        elif f.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert za.files == zb.files
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{f}:{k}")
        else:
            with open(pa) as x, open(pb) as y:
                assert json.load(x) == json.load(y), f


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both CLIs' plan_and_preprocess; the port's lowres → cascade training."""
    root = tmp_path_factory.mktemp("cli3d")
    _write_dataset(root)
    for cli in (_port, _jax):
        cli(["plan_and_preprocess", "-d", str(DSID), "--hbm_budget", BUDGET], root)
    with pytest.raises(SystemExit, match="3d_lowres"):  # the cascade needs the lowres stage
        _port(["train", "-d", str(DSID), "-c", "3d_cascade_fullres", "-f", "0"], root)
    folds = {cfg: _port(["train", "-d", str(DSID), "-c", cfg, "-f", "0", "--epochs", "1",
                         "--iters", "2"], root)
             for cfg in ("3d_lowres", "3d_cascade_fullres")}
    return root, folds


def test_plans_and_stores_equal_jax(run):
    root, _ = run
    t, j = root / "pp_t" / NAME, root / "pp_j" / NAME
    for name in ("plans_3d.json", "dataset_fingerprint.json", "dataset.json"):
        with open(t / name) as f, open(j / name) as g:
            assert json.load(f) == json.load(g), name
    with open(t / "plans_3d.json") as f:
        configs = json.load(f)["configurations"]
    assert set(configs) == {"3d_fullres", "3d_lowres", "3d_cascade_fullres"}
    for store in ("ldPlans_3d_fullres", "ldPlans_3d_lowres"):
        _tree_equal(str(t / store), str(j / store))
    assert not (t / "ldPlans_3d_cascade_fullres").exists()


def test_training_outputs(run):
    root, folds = run
    pp = root / "pp_t" / NAME
    cached = pp / "predicted_next_stage" / "3d_cascade_fullres"
    assert sorted(os.listdir(cached)) == ["case0.npy", "case1.npy", "case2.npy"]
    for cfg, fold in folds.items():
        for rel in ("checkpoint_final.pkl", "validation/summary.json", "postprocessing.json"):
            assert os.path.exists(os.path.join(fold, rel)), (cfg, rel)
        assert any(f.endswith(".npy") for f in os.listdir(os.path.join(fold, "validation")))
        plan = SegPlan3D.load(os.path.join(os.path.dirname(fold), "plans.json"))
        ck = j_load_pytree(os.path.join(fold, "checkpoint_final.pkl"))
        assert ck["params"]["enc_0_0"]["conv"]["kernel"].shape[3] == \
            plan.network_config().in_channels
        assert np.isfinite(ck["logger"]["data"]["train_loss"]).all()
    cascade_in = j_load_pytree(os.path.join(folds["3d_cascade_fullres"], "checkpoint_final.pkl"))
    assert cascade_in["params"]["enc_0_0"]["conv"]["kernel"].shape[3] == 1 + 2
    # evaluate_folder on the validation cases: both packages score alike
    fold = folds["3d_cascade_fullres"]
    dj = str(root / "raw" / NAME / "dataset.json")
    args = ["evaluate_folder", os.path.join(fold, "validation_gt"),
            os.path.join(fold, "validation"), "-djfile", dj]
    got = tcli.main(args + ["-o", str(root / "t_summary.json")])
    want = jcli.main(args + ["-o", str(root / "j_summary.json")])
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def _f32(monkeypatch):
    t_from, j_init = TPredictor.from_checkpoints.__func__, JPredictor.__init__

    def t_ck(cls, plan, paths, **kw):
        return t_from(cls, plan, paths, **{**kw, "dtype": torch.float32})

    def j_new(self, plan, params, **kw):
        j_init(self, plan, params, **{**kw, "dtype": jnp.float32})

    monkeypatch.setattr(TPredictor, "from_checkpoints", classmethod(t_ck))
    monkeypatch.setattr(JPredictor, "__init__", j_new)


def test_cascade_predict_masks_equal_the_jax_cli(run, monkeypatch, capsys):
    root, folds = run
    _f32(monkeypatch)
    images = str(root / "raw" / NAME / "imagesTs")
    common = ["-i", images, "-d", str(DSID), "-f", "0"]
    _port(["predict", "-o", str(root / "t_casc"), "-c", "3d_cascade_fullres", *common], root)
    assert "consumed the lowres stage" in capsys.readouterr().out
    _jax(["predict", "-o", str(root / "j_casc"), "-c", "3d_cascade_fullres", *common], root)
    _port(["predict", "-o", str(root / "t_low"), "-c", "3d_lowres", *common], root)
    _port(["predict", "-o", str(root / "t_prev"), "-c", "3d_cascade_fullres", *common,
           "-prev_stage_predictions", str(root / "t_low")], root)
    got = np.load(root / "t_casc" / "t3.npy")
    assert got.shape == (16, 32, 32) and got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1, 2}
    want = np.load(root / "j_casc" / "t3.npy")
    assert float((got == want).mean()) >= MASK_AGREEMENT
    np.testing.assert_array_equal(np.load(root / "t_prev" / "t3.npy"), got)
    with open(root / "t_casc" / "t3.json") as f:
        assert json.load(f) == {"spacing": SPACING}
    # the checkpoint's tree is the trainer's state carried by dynunet3d_to_flax
    fold = folds["3d_cascade_fullres"]
    plan = SegPlan3D.load(os.path.join(os.path.dirname(fold), "plans.json"))
    tr = SegmentorTrainer(plan, SegmentorTrainConfig(), output_dir=str(root / "reload"),
                          device="cpu")
    tr.load_checkpoint(os.path.join(fold, "checkpoint_final.pkl"))
    ck = flatten_tree(j_load_pytree(os.path.join(fold, "checkpoint_final.pkl"))["params"])
    back = flatten_tree(dynunet3d_to_flax(tr.net.state_dict(), plan.network_config()))
    assert back.keys() == ck.keys()
    for k in ck:
        np.testing.assert_array_equal(back[k], ck[k], err_msg=k)
