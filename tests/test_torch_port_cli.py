"""The 2D segmentor command line of the port against the JAX package's, on the
CPU on tiny PNG datasets: ``plan_and_preprocess → train → predict →
evaluate_folder`` for the plain, ignore-label, regions and regions+ignore
regimes, both planners, the trainer recipes through ``train -tr``,
``-pretrained_weights``, the workflow subcommands on bad input (the same
exception type as the JAX CLI), and ``api.parse_args``.

Tolerances:
- plans.json, splits_final.json, the preprocessed store (npz arrays and
  json), dataset.json, ``summary.json`` of the same folders: exact;
- masks of the JAX predictor reading the port's checkpoint against the
  port's own, both float32 (the CLIs' bf16 predictors are patched to f32):
  equal on >= 99.5% of pixels, the slice tolerance of ``test_torch_port_api``.
  A BatchNorm checkpoint is read by the JAX predictor with a BatchNorm net:
  its own predictor builds the net from the plan alone and so evaluates
  with InstanceNorm (ROADMAP queue 3), which the port does not copy.
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

from ldiffusion_tpu import api as japi
from ldiffusion_tpu.core.checkpoint import load_pytree as j_load_pytree
from ldiffusion_tpu.models.dynunet import DynUNet as JDynUNet
from ldiffusion_tpu.segmentor import cli as jcli
from ldiffusion_tpu.segmentor import splits as jsplits
from ldiffusion_tpu.segmentor.planner import SegPlan as JPlan
from ldiffusion_tpu.segmentor.predictor import SlidingWindowPredictor as JPredictor
from ldiffusion_tpu.segmentor.pretrained import transfer_pretrained_weights as j_transfer
from ldiffusion_tpu_torch import api as tapi
from ldiffusion_tpu_torch import ldiffusion as tldiffusion
from ldiffusion_tpu_torch.models.convert import dynunet_to_flax, flatten_tree
from ldiffusion_tpu_torch.segmentor import cli as tcli
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor as TPredictor
from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
from ldiffusion_tpu_torch.segmentor.variants import lr_at_epoch, get_variant

MASK_AGREEMENT = 0.995
SIZE = 24
REGIMES = {  # dataset id → (labels, regions_class_order, name)
    1: ({"background": 0, "a": 1, "b": 2, "c": 3, "ignore": 4}, None, "Ignore"),
    2: ({"background": 0, "abc": [1, 2, 3], "ab": [1, 2], "a": [1]}, [3, 2, 1], "Regions"),
    3: ({"background": 0, "a": 1, "b": 2, "c": 3}, None, "Plain"),
    4: ({"background": 0, "abc": [1, 2, 3], "c": [3], "ignore": 4}, [1, 3], "RegionsIgnore"),
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


def _write_dataset(raw, did):
    labels, order, name = REGIMES[did]
    ds = raw / f"Dataset{did:03d}_{name}"
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        (ds / sub).mkdir(parents=True)
    rng = np.random.default_rng(did)
    for i in range(6):
        lab = np.kron(rng.integers(0, 4, (SIZE // 8, SIZE // 8)),
                      np.ones((8, 8), np.int64)).astype(np.uint8)
        img = np.stack([lab * 50 + 20, 200 - lab * 40, lab * 10 + 90], -1) \
            + rng.normal(0, 12, (SIZE, SIZE, 3))
        img = img.clip(0, 255).astype(np.uint8)
        if "ignore" in labels:
            lab[:3] = 4
        Image.fromarray(img).save(ds / "imagesTr" / f"case_{i:03d}_0000.png")
        Image.fromarray(lab).save(ds / "labelsTr" / f"case_{i:03d}.png")
        if i < 2:
            Image.fromarray(img[:, :SIZE - 4]).save(ds / "imagesTs" / f"ts_{i:03d}_0000.png")
    dj = {"channel_names": {"0": "R", "1": "G", "2": "B"}, "labels": labels,
          "numTraining": 6, "file_ending": ".png"}
    if order:
        dj["regions_class_order"] = order
    with open(ds / "dataset.json", "w") as f:
        json.dump(dj, f)
    return ds


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    for did in REGIMES:
        _write_dataset(root / "raw", did)
    return root


def _port(args, root, *extra):
    """The port's CLI on the CPU with the test's roots."""
    cmd = args[0]
    flags = {"plan_and_preprocess": ["--raw", "--preprocessed"],
             "train": ["--raw", "--preprocessed", "--results"],
             "predict": ["--raw", "--results"]}.get(cmd, [])
    where = {"--raw": root / "raw", "--preprocessed": root / "pp_t", "--results": root / "res_t"}
    argv = list(args) + [x for f in flags for x in (f, str(where[f]))] + list(extra)
    return tcli.main(argv, device="cpu")


def _jax(args, root):
    cmd = args[0]
    flags = {"plan_and_preprocess": ["--raw", "--preprocessed"],
             "predict": ["--raw", "--results"]}.get(cmd, [])
    where = {"--raw": root / "raw", "--preprocessed": root / "pp_j", "--results": root / "res_t"}
    return jcli.main(list(args) + [x for f in flags for x in (f, str(where[f]))])


def _tree_equal(a, b):
    """Two directories hold the same files with the same content (npz by array)."""
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
        elif f.endswith(".json"):
            with open(pa) as x, open(pb) as y:
                assert json.load(x) == json.load(y), f
        else:
            with open(pa, "rb") as x, open(pb, "rb") as y:
                assert x.read() == y.read(), f


@pytest.fixture(scope="module")
def preprocessed(roots):
    """Both CLIs' plan_and_preprocess of every dataset, the default planner,
    and for dataset 2 also the ResEnc-M plan under its own name."""
    for did in REGIMES:
        args = ["plan_and_preprocess", "-d", str(did), "--verify_dataset_integrity"]
        _port(args, roots)
        _jax(args, roots)
    resenc = ["plan_and_preprocess", "-d", "2", "-pl", "nnUNetPlannerResEncM",
              "-overwrite_plans_name", "nnUNetResEncUNetMPlans"]
    _port(resenc, roots)
    _jax(resenc, roots)
    return roots


def test_plans_and_preprocessed_store_equal_jax(preprocessed):
    root = preprocessed
    _tree_equal(str(root / "pp_t"), str(root / "pp_j"))
    plan = SegPlan.load(str(root / "pp_t" / "Dataset002_Regions" / "nnUNetResEncUNetMPlans.json"))
    assert plan.block_type == "residual" and plan.num_classes == 3
    with open(root / "pp_t" / "Dataset001_Ignore" / "plans.json", "rb") as f, \
            open(root / "pp_j" / "Dataset001_Ignore" / "plans.json", "rb") as g:
        assert f.read() == g.read()


@pytest.fixture(scope="module")
def trained(preprocessed):
    """``train`` (1 epoch × 2 iterations, --npz) on every dataset, the ResEnc-M
    plans on dataset 2 with Adan + cosine, and BatchNorm on dataset 1."""
    root = preprocessed
    runs = {}
    for did in REGIMES:
        runs[did] = _port(["train", "-d", str(did), "-c", "2d", "-f", "0", "--epochs", "1",
                           "--iters", "2", "--npz"], root)
    runs["resenc"] = _port(["train", "-d", "2", "-c", "2d", "-f", "0", "--epochs", "1",
                            "--iters", "2", "-tr", "nnUNetTrainerAdanCosAnneal",
                            "-p", "nnUNetResEncUNetMPlans"], root)
    runs["bn"] = _port(["train", "-d", "1", "-c", "2d", "-f", "0", "--epochs", "1",
                        "--iters", "2", "-tr", "nnUNetTrainerBN"], root)
    return root, runs


def test_splits_and_training_outputs(trained):
    root, runs = trained
    for did in REGIMES:
        name = f"Dataset{did:03d}_{REGIMES[did][2]}"
        split = root / "pp_t" / name / "splits_final.json"
        keys = [f"case_{i:03d}" for i in range(6)]
        jsplits.do_split(keys, 0, str(root / f"j_splits_{did}.json"))
        with open(split, "rb") as f, open(root / f"j_splits_{did}.json", "rb") as g:
            assert f.read() == g.read()
        fold = runs[did]
        for rel in ("checkpoint_final.pkl", "validation/summary.json", "postprocessing.json",
                    "validation/case_000.npz"):
            assert os.path.exists(os.path.join(fold, rel)), rel
        with open(os.path.join(fold, "validation", "summary.json")) as f:
            summary = json.load(f)
        lm = tcli._label_manager(os.path.dirname(fold))[0]
        assert set(summary["mean"]) == {str(r) for r in lm.labels_or_regions_for_eval}
        with np.load(os.path.join(fold, "validation", "case_000.npz")) as z:
            assert z["probabilities"].dtype == np.float16  # the JAX layout
            p = z["probabilities"].astype(np.float32)
        assert p.shape[-1] == lm.num_segmentation_heads
        if lm.has_regions:
            assert p.min() >= 0 and p.max() <= 1
        else:
            np.testing.assert_allclose(p.sum(-1), 1.0, atol=4e-3)
    ck = j_load_pytree(os.path.join(runs["bn"], "checkpoint_final.pkl"))
    assert ck["batch_stats"] and set(ck["opt_state"]) == {"learning_rate", "momentum"}
    ck = j_load_pytree(os.path.join(runs["resenc"], "checkpoint_final.pkl"))
    assert set(ck["opt_state"]) == {"learning_rate", "m", "v", "n", "prev_grad"}
    assert "enc_2_3" in ck["params"] and "downsample_conv" in ck["params"]["enc_1_0"]


def _f32(monkeypatch):
    """Both packages' predictors in float32; a BatchNorm checkpoint read by the
    JAX predictor through a BatchNorm net."""
    t_from, j_init = TPredictor.from_checkpoints.__func__, JPredictor.__init__

    def t_ck(cls, plan, paths, **kw):
        return t_from(cls, plan, paths, **{**kw, "dtype": torch.float32})

    def j_new(self, plan, params, **kw):
        j_init(self, plan, params, **{**kw, "dtype": jnp.float32})
        if any(isinstance(p, dict) and p.get("batch_stats") for p in self.params_list):
            self.net = JDynUNet(dataclasses.replace(plan.network_config(), norm="batch"),
                                dtype=jnp.float32)

    monkeypatch.setattr(TPredictor, "from_checkpoints", classmethod(t_ck))
    monkeypatch.setattr(JPredictor, "__init__", j_new)


@pytest.mark.parametrize("run", [1, 2, 3, 4, "resenc", "bn"])
def test_predict_masks_equal_the_jax_cli(trained, run, monkeypatch):
    root, runs = trained
    _f32(monkeypatch)
    did = {"resenc": 2, "bn": 1}.get(run, run)
    name = f"Dataset{did:03d}_{REGIMES[did][2]}"
    extra = {"resenc": ["-tr", "nnUNetTrainerAdanCosAnneal", "-p", "nnUNetResEncUNetMPlans"],
             "bn": ["-tr", "nnUNetTrainerBN"]}.get(run, [])
    inp = str(root / "raw" / name / "imagesTs")
    out_t, out_j = root / f"pred_t_{run}", root / f"pred_j_{run}"
    _port(["predict", "-i", inp, "-o", str(out_t), "-d", str(did), "-f", "0",
           "--save_probabilities", *extra], root)
    _jax(["predict", "-i", inp, "-o", str(out_j), "-d", str(did), "-f", "0",
          "--save_probabilities", *extra], root)
    for f in ("ts_000.png", "ts_001.png"):
        a = np.asarray(Image.open(out_t / f))
        b = np.asarray(Image.open(out_j / f))
        assert a.shape == b.shape == (SIZE, SIZE - 4)
        assert (a == b).mean() >= MASK_AGREEMENT, (f, (a == b).mean())
        with np.load(out_t / f.replace(".png", ".npz")) as z:
            assert z["probabilities"].shape[:2] == (SIZE, SIZE - 4)
            assert z["probabilities"].dtype == np.float16
    # evaluate_folder -djfile: the port's and the JAX CLI's summaries of one folder
    gt = root / f"gt_{run}"
    gt.mkdir()
    rng = np.random.default_rng(0)
    for f in ("ts_000.png", "ts_001.png"):
        Image.fromarray(rng.integers(0, 5 if did in (1, 4) else 4,
                                     (SIZE, SIZE - 4)).astype(np.uint8)).save(gt / f)
    dj = str(root / "raw" / name / "dataset.json")
    got = tcli.main(["evaluate_folder", str(gt), str(out_t), "-djfile", dj,
                     "-o", str(root / f"sum_t_{run}.json")])
    want = jcli.main(["evaluate_folder", str(gt), str(out_t), "-djfile", dj,
                      "-o", str(root / f"sum_j_{run}.json")])
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def test_validation_postprocessing_and_checkpoint_flags(trained):
    root, runs = trained
    fold = runs["bn"]
    _port(["train", "-d", "1", "-c", "2d", "-f", "0", "-tr", "nnUNetTrainerBN", "--val"], root)
    out = root / "pred_chk"
    _port(["predict", "-i", str(root / "raw" / "Dataset001_Ignore" / "imagesTs"), "-o", str(out),
           "-d", "1", "-f", "0", "-tr", "nnUNetTrainerBN", "-chk", "checkpoint_final.pkl"], root)
    val, gt = os.path.join(fold, "validation"), os.path.join(fold, "validation_gt")
    tcli.main(["determine_postprocessing", "-i", val, "-ref", gt,
               "-o", str(root / "pp.json")])
    tcli.main(["apply_postprocessing", "-i", str(out), "-o", str(root / "pp_out"),
               "-pp_pkl_file", str(root / "pp.json")])
    assert sorted(os.listdir(root / "pp_out")) == ["ts_000.png", "ts_001.png"]
    with pytest.raises(FileNotFoundError):
        _port(["predict", "-i", str(out), "-o", str(root / "x"), "-d", "1", "-f", "0",
               "-chk", "checkpoint_missing.pkl"], root)


def test_pretrained_weights_copy_the_jax_selection(trained, tmp_path):
    """Dataset 3 (4 heads) initialised from dataset 2's checkpoint (3 region
    heads): the port copies exactly the tensors JAX's transfer picks, with
    the source's values bit for bit, and leaves the rest at their initial
    values; ``train -pretrained_weights`` logs that count."""
    root, runs = trained
    src = os.path.join(runs[2], "checkpoint_final.pkl")
    res = root / "res_pre"
    fold = tcli.main(["train", "-d", "3", "-c", "2d", "-f", "1", "--epochs", "1", "--iters", "1",
                      "--raw", str(root / "raw"), "--preprocessed", str(root / "pp_t"),
                      "--results", str(res), "-pretrained_weights", src], device="cpu")
    with open(os.path.join(fold, "training_log.txt")) as f:
        line = next(x for x in f if "pretrained weights" in x)
    plan = JPlan.load(str(root / "pp_j" / "Dataset003_Plain" / "plans.json"))
    target = jax.tree_util.tree_map(np.asarray, jax.jit(JDynUNet(plan.network_config()).init)(
        jax.random.key(0), jnp.zeros((1, *plan.patch_size, 3)))["params"])
    source = j_load_pytree(src)["params"]
    _, want, skipped = j_transfer(target, source, verbose=False)
    assert f"transferred {len(want)} tensors" in line
    assert skipped and all(p.startswith("seg_") for p in skipped)
    # a fresh trainer of the same plan: which tensors, and their values
    t_plan = SegPlan.load(str(root / "pp_t" / "Dataset003_Plain" / "plans.json"))
    variant = get_variant("nnUNetTrainer")
    tr = SegmentorTrainer(t_plan, variant.config, output_dir=str(tmp_path), variant=variant,
                          label_manager=tcli._label_manager(os.path.dirname(fold))[0],
                          device="cpu")
    before = flatten_tree(dynunet_to_flax(tr.net.state_dict(), tr.net_config))
    got = tr.load_pretrained(src)
    after = flatten_tree(dynunet_to_flax(tr.net.state_dict(), tr.net_config))
    assert set(got) == set(want) and len(got) == len(want)
    assert set(after) == set(want) | set(skipped)
    flat_src = flatten_tree(source)
    for path in want:
        np.testing.assert_array_equal(after[path], flat_src[path], err_msg=path)
    for path in skipped:
        np.testing.assert_array_equal(after[path], before[path], err_msg=path)


@pytest.mark.parametrize("name", [
    "nnUNetTrainerDiceLoss", "nnUNetTrainerCELoss", "nnUNetTrainerTopk10Loss",
    "nnUNetTrainerTopk10LossLS01", "nnUNetTrainerDiceTopK10Loss",
    "nnUNetTrainerDiceCELoss_noSmooth", "nnUNetTrainerAdam", "nnUNetTrainerAdan",
    "nnUNetTrainerCosAnneal", "nnUNetTrainerBN", "nnUNetTrainerDA5", "nnUNetTrainerNoDA",
    "nnUNetTrainerDAOrd0", "nnUNetTrainer_probabilisticOversampling_033",
    "nnUNetTrainerNoDeepSupervision", "nnUNetTrainerBenchmark_5epochs_noDataLoading",
    "nnUNetTrainer_onlyMirror01"])
def test_each_recipe_trains_through_the_cli(preprocessed, name):
    """One iteration of each distinct recipe through ``train -tr`` (dataset 1,
    the ignore label), its checkpoint, validation and logged learning rate."""
    root = preprocessed
    fold = _port(["train", "-d", "1", "-c", "2d", "-f", "0", "--epochs", "1", "--iters", "1",
                  "-tr", name], root)
    v = get_variant(name)
    ck = j_load_pytree(os.path.join(fold, "checkpoint_final.pkl"))
    assert bool(ck["batch_stats"]) == (v.norm == "batch")
    n_epochs = 5 if v.benchmark else 1
    assert ck["epoch"] == n_epochs
    logged = ck["logger"]["data"]
    assert logged["lr"] == [lr_at_epoch(v, e, n_epochs) for e in range(n_epochs)]
    assert np.isfinite(logged["train_loss"]).all()
    assert os.path.exists(os.path.join(fold, "validation", "summary.json"))


@pytest.mark.parametrize("argv", [
    ["ensemble", "-i", "a", "b", "-o", "c"], ["find_best_configuration", "-d", "1"],
    ["predict_from_modelfolder", "-i", "a", "-o", "b", "-m", "c"],
    ["accumulate_crossval_results", "-m", "a"], ["export_model", "a", "-o", "b"],
    ["install_model", "a.zip", "-o", "b"], ["download_model", "file:///x", "-o", "b"],
    ["convert_msd", "-i", "a", "-o", "b"], ["convert_old_dataset", "-i", "a", "-o", "b"],
    ["plot_overlays", "a", "b", "-o", "c"], ["move_plans", "-s", "1", "-t", "2"],
    ["train", "-d", "1", "-c", "3d_fullres"], ["predict", "-i", "a", "-o", "b", "-d", "1",
                                              "-c", "3d_lowres"]])
def test_unported_subcommands_raise_naming_the_roadmap(argv, monkeypatch, tmp_path):
    """The subcommands of the workflow after training raised before they were
    ported; now they run (``test_torch_port_workflow``), and on the same bad
    input (folders that do not exist, roots that are unset) the port's CLI
    raises the exception type the JAX CLI raises. The 3D configurations are
    ported (``test_torch_port_cli_3d``): ``train -c 3d_fullres`` and
    ``predict -c 3d_lowres`` go on to look for their dataset's roots, which
    are unset here."""
    for name in ("LDIFFUSION_RAW", "nnUNet_raw", "LDIFFUSION_PREPROCESSED",
                 "nnUNet_preprocessed", "LDIFFUSION_RESULTS", "nnUNet_results"):
        monkeypatch.delenv(name, raising=False)
    if "-c" in argv and argv[argv.index("-c") + 1].startswith("3d_"):
        with pytest.raises(SystemExit, match="LDIFFUSION_(RAW|RESULTS) is not set"):
            tcli.main(argv, device="cpu")
        return
    for side in ("j", "t"):  # relative folders land in a directory of each side's own
        (tmp_path / side).mkdir()
    monkeypatch.chdir(tmp_path / "j")
    with pytest.raises(BaseException) as want:  # SystemExit included
        jcli.main(list(argv))
    monkeypatch.chdir(tmp_path / "t")
    with pytest.raises(want.type):
        tcli.main(list(argv), device="cpu")


def test_volumetric_dataset_raises(tmp_path):
    """A volumetric dataset is planned (``test_torch_port_cli_3d``); a NIfTI
    one needs nibabel (or SimpleITK), which this machine lacks: the reader
    raises naming it."""
    ds = tmp_path / "raw" / "Dataset009_Vol"
    ds.mkdir(parents=True)
    with open(ds / "dataset.json", "w") as f:
        json.dump({"labels": {"background": 0, "a": 1}, "file_ending": ".nii.gz"}, f)
    with pytest.raises(ValueError, match="nibabel"):
        tcli.main(["plan_and_preprocess", "-d", "9", "--raw", str(tmp_path / "raw"),
                   "--preprocessed", str(tmp_path / "pp")], device="cpu")


def test_parsers_have_the_jax_flags_and_defaults():
    argv = ["--diffusion-path", "p", "--image-dir", "i", "--label-dir", "l", "--num-epochs",
            "3", "--batch-size", "2", "--num-inference-steps", "25", "--num-classes", "7"]
    assert vars(tapi.parse_args(argv)) == vars(japi.parse_args(argv))
    assert vars(tldiffusion.parse_args(argv + ["--level", "cell", "--component",
                                               "segmentor"])) == \
        vars(japi.parse_args(argv + ["--level", "cell", "--component", "segmentor"]))
    with pytest.raises(SystemExit):
        tapi.parse_args(argv[:2])

    def surface(parser):
        out = {}
        sub = next(a for a in parser._actions if a.dest == "command")
        for name, sp in sub.choices.items():
            out[name] = sorted((tuple(a.option_strings), a.dest, repr(a.default))
                               for a in sp._actions if a.dest != "help")
        return out

    assert surface(tcli.build_parser()) == surface(jcli.build_parser())
