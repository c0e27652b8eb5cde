"""nnU-Net-style segmentor command line, 2D (counterpart of
``ldiffusion_tpu/segmentor/cli.py``; reference ``nnUNetv2_plan_and_preprocess``
/ ``nnUNetv2_train`` / ``nnUNetv2_predict``, ``run_training.py:212-271``,
``plan_and_preprocess_entrypoints.py:8-204``,
``predict_from_raw_data.py:637-767``):

    python -m ldiffusion_tpu_torch.segmentor plan_and_preprocess -d 1 [-pl nnUNetPlannerResEncM]
    python -m ldiffusion_tpu_torch.segmentor train -d 1 -c 2d -f 0 [-tr NAME] [-p NAME] [--npz]
    python -m ldiffusion_tpu_torch.segmentor predict -i IN -o OUT -d 1 -f 0 [--save_probabilities]

The dataset layout, the flags and every file written are the JAX CLI's:
``$LDIFFUSION_RAW/DatasetXXX_Name/{imagesTr,labelsTr,dataset.json}`` (PNG,
channel files ``<case>_NNNN.png``), the preprocessed store under
``$LDIFFUSION_PREPROCESSED``, results under
``$LDIFFUSION_RESULTS/DatasetXXX_Name/<trainer>__<plans>__2d/fold_<f>``
(``core/paths.py``; the ``nnUNet_*`` names as fallbacks). Training and
prediction run on the card unless ``main(argv, device="cpu")``.

Also here: ``extract_fingerprint`` / ``plan_experiment`` / ``preprocess``,
``evaluate_folder``, ``determine_postprocessing``, ``apply_postprocessing``.
The other subcommands are in the parser and raise ``NotImplementedError``
(ROADMAP queue 1, *The remaining CLI commands*), as do the ``3d_*``
configurations and volumetric datasets (*The 3D / cascade pathway*).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

import numpy as np

from ldiffusion_tpu_torch.core import paths as env_paths

VOLUMETRIC_CONFIGS = ("3d_fullres", "3d_lowres", "3d_cascade_fullres")
_LATER_3D = "is not ported yet (ROADMAP queue 1, *The 3D / cascade pathway*)"


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------

def find_dataset_dir(root: str, dataset_id: int) -> str:
    """``DatasetXXX_Name`` by id (reference ``dataset_name_id_conversion.py``)."""
    pattern = os.path.join(root, f"Dataset{int(dataset_id):03d}_*")
    hits = sorted(glob.glob(pattern))
    if not hits:
        exact = os.path.join(root, f"Dataset{int(dataset_id):03d}")
        if os.path.isdir(exact):
            return exact
        raise FileNotFoundError(f"no dataset matching {pattern}")
    if len(hits) > 1:
        raise RuntimeError(f"ambiguous dataset id {dataset_id}: {hits}")
    return hits[0]


def _require(value: Optional[str], flag: str, env: str) -> str:
    if not value:
        raise SystemExit(f"{env} is not set — export it or pass {flag}")
    return value


def _roots(args, *which):
    """The raw / preprocessed / results roots: the flag, else the variable."""
    table = {"raw": ("--raw", "LDIFFUSION_RAW", env_paths.raw_dir),
             "preprocessed": ("--preprocessed", "LDIFFUSION_PREPROCESSED",
                              env_paths.preprocessed_dir),
             "results": ("--results", "LDIFFUSION_RESULTS", env_paths.results_dir)}
    out = []
    for name in which:
        flag, env, fn = table[name]
        out.append(_require(getattr(args, name) or fn(warn=False), flag, env))
    return out if len(out) > 1 else out[0]


def _load_png_channels(paths):
    """[0, 1] float (H, W, C) from a case's channel files: one file as RGB;
    several concatenate their own channels in file-name order
    (NaturalImage2DIO, reference ``natural_image_reader_writer.py:22-45``)."""
    from PIL import Image

    if len(paths) == 1:
        with Image.open(paths[0]) as f:
            return np.asarray(f.convert("RGB"), np.float32) / 255.0
    chans = []
    for p in paths:
        with Image.open(p) as f:
            arr = np.asarray(f, np.float32) / 255.0
        chans.append(arr[..., None] if arr.ndim == 2 else arr)
    return np.concatenate(chans, axis=-1)


def _load_label(path: str):
    from PIL import Image

    if not os.path.exists(path):
        return None
    with Image.open(path) as f:
        return np.asarray(f, np.uint8).astype(np.int32)


def load_png_cases(ds_dir: str, split: str = "Tr"):
    """(case ids, images [0, 1] float (H, W, C), labels int32 (H, W) or None)
    of imagesTr/labelsTr (or Ts); for Tr a ``"dataset"`` file list in
    dataset.json comes first."""
    from ldiffusion_tpu_torch.data.io import get_train_images_and_targets, group_channel_files

    if split == "Tr":
        dj_path = os.path.join(ds_dir, "dataset.json")
        if os.path.exists(dj_path):
            with open(dj_path) as f:
                dj = json.load(f)
            if "dataset" in dj:
                ids, images, labels = [], [], []
                for case, entry in sorted(get_train_images_and_targets(ds_dir, dj).items()):
                    ids.append(case)
                    images.append(_load_png_channels(entry["images"]))
                    labels.append(_load_label(entry["label"]))
                return ids, images, labels
    img_dir = os.path.join(ds_dir, f"images{split}")
    lbl_dir = os.path.join(ds_dir, f"labels{split}")
    ids, images, labels = [], [], []
    if not os.path.isdir(img_dir):
        return ids, images, labels
    for case, files in sorted(group_channel_files(img_dir, ".png").items()):
        ids.append(case)
        images.append(_load_png_channels([os.path.join(img_dir, f) for f in files]))
        labels.append(_load_label(os.path.join(lbl_dir, f"{case}.png")))
    return ids, images, labels


def _read_dataset_json(path: str) -> dict:
    """dataset.json with the regions' lists as tuples (the label manager's form)."""
    with open(path) as f:
        dj = json.load(f)
    dj["labels"] = {k: tuple(v) if isinstance(v, list) else v for k, v in dj["labels"].items()}
    return dj


def _label_manager(ds_dir: str):
    from ldiffusion_tpu_torch.segmentor.label_manager import label_manager_from_dataset_json

    dj = _read_dataset_json(os.path.join(ds_dir, "dataset.json"))
    if dj.get("file_ending", ".png").lower() != ".png":
        raise NotImplementedError(f"volumetric datasets ({dj['file_ending']}) {_LATER_3D}")
    return label_manager_from_dataset_json(dj), dj


def _pp_dataset_dir(pp_root: str, raw_ds_dir: str) -> str:
    return os.path.join(pp_root, os.path.basename(raw_ds_dir))


def _results_config_dir(results_root: str, raw_ds_name: str, trainer: str, config: str,
                        plans_name: str = "ldPlans") -> str:
    """``Dataset/<trainer>__<plans>__<config>`` (reference ``get_output_folder``)."""
    return os.path.join(results_root, raw_ds_name, f"{trainer}__{plans_name}__{config}")


def _plans_filename(args) -> str:
    """``-p``: the default identifier reads plans.json, ``-p NAME`` NAME.json."""
    p = getattr(args, "p", None) or "ldPlans"
    return "plans.json" if p == "ldPlans" else f"{p}.json"


def _max_label_value(lm) -> int:
    return max(list(lm.all_labels) + ([lm.ignore_label] if lm.has_ignore_label else []))


def _planner_kind(name: str) -> str:
    """``-pl``: "default"/"resenc", or a reference planner class name
    (nnUNetPlannerResEncM/L/XL → resenc, all three the M schedule, as in the
    JAX package; ExperimentPlanner → default). Unknown names raise."""
    n = (name or "default").lower()
    if "resenc" in n:
        return "resenc"
    if n in ("default", "experimentplanner", "nnunetplanner"):
        return "default"
    raise SystemExit(f"unknown planner {name!r} — use 'default', 'resenc', or a reference "
                     "planner class name (nnUNetPlannerResEncM/L/XL, ExperimentPlanner)")


def _check_2d(config: str):
    if config in VOLUMETRIC_CONFIGS:
        raise NotImplementedError(f"-c {config} {_LATER_3D}")
    if config != "2d":
        raise SystemExit(f"unknown configuration {config!r} — use 2d, "
                         f"{', '.join(VOLUMETRIC_CONFIGS)}")


def _write_fingerprint(path: str, fp: dict):
    with open(path, "w") as f:
        json.dump({k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in fp.items()},
                  f, indent=2)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_plan_and_preprocess(args) -> str:
    """fingerprint → plan → preprocess (reference
    ``plan_and_preprocess_entrypoints.py:8-204``)."""
    from ldiffusion_tpu_torch.segmentor.fingerprint import (
        extract_fingerprint,
        verify_dataset_integrity,
    )
    from ldiffusion_tpu_torch.segmentor.planner import plan_experiment
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset, get_preprocessor

    raw_root, pp_root = _roots(args, "raw", "preprocessed")
    ds_dir = find_dataset_dir(raw_root, args.d)
    lm, dataset_json = _label_manager(ds_dir)
    try:
        preprocessor = get_preprocessor(args.preprocessor_name)
    except KeyError as e:
        raise SystemExit(str(e))
    plans_name = args.overwrite_plans_name or "ldPlans"
    if args.overwrite_target_spacing is not None:
        raise SystemExit("-overwrite_target_spacing only applies to the 3D configurations "
                         f"(reference help) — dataset {args.d} is 2D")
    ids, images, labels = load_png_cases(ds_dir, "Tr")
    if not ids:
        raise SystemExit(f"no training cases under {ds_dir}/imagesTr")
    if args.verify_dataset_integrity:
        n_expected = dataset_json.get("numTraining")
        if n_expected is not None and n_expected != len(ids):
            raise SystemExit(f"dataset.json numTraining={n_expected} but {len(ids)} cases found")
        problems = verify_dataset_integrity(images, labels, _max_label_value(lm) + 1)
        if problems:
            raise SystemExit(f"dataset integrity check failed: {problems}")
    out = _pp_dataset_dir(pp_root, ds_dir)
    os.makedirs(out, exist_ok=True)
    fp_path = os.path.join(out, "dataset_fingerprint.json")
    if os.path.exists(fp_path) and not args.clean:  # plan_and_preprocess_api.py:22-33
        print(f"fingerprint exists, reusing {fp_path} (--clean re-extracts)")
        with open(fp_path) as f:
            fp = json.load(f)
    else:
        fp = extract_fingerprint(images, labels)
        _write_fingerprint(fp_path, fp)
    plan = plan_experiment(fp, lm.num_segmentation_heads, planner=_planner_kind(args.pl))
    plan.save(os.path.join(out, "plans.json" if plans_name == "ldPlans"
                           else f"{plans_name}.json"))
    with open(os.path.join(out, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    if args.no_pp:
        print(f"plans written to {out} (--no_pp: preprocessing skipped)")
        return out
    if args.c is not None and "2d" not in args.c:
        print(f"plans written to {out}; no requested configuration in {args.c} exists for "
              "this 2d dataset — preprocessing skipped (reference -c skip semantics)")
        return out
    PreprocessedDataset.build(images, labels, _max_label_value(lm) + 1, case_ids=ids,
                              preprocessor=preprocessor,
                              directory=os.path.join(out, "ldPlans_2d"))
    print(f"plans + preprocessed data written to {out}")
    return out


def _load_preprocessed(args):
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset

    raw_root, pp_root = _roots(args, "raw", "preprocessed")
    ds_dir = find_dataset_dir(raw_root, args.d)
    pp_dir = _pp_dataset_dir(pp_root, ds_dir)
    if not os.path.isdir(pp_dir):
        raise SystemExit(f"{pp_dir} missing — run plan_and_preprocess first")
    plan = SegPlan.load(os.path.join(pp_dir, _plans_filename(args)))
    lm, _ = _label_manager(pp_dir)
    ds = PreprocessedDataset.load(os.path.join(pp_dir, "ldPlans_2d"))
    return ds_dir, pp_dir, plan, lm, ds


def cmd_train(args) -> str:
    """One fold (reference ``run_training.py:212-271``): the variant's recipe,
    ``--c`` resume, ``-pretrained_weights`` (ignored under ``--c``), ``--val``
    (``--val_best``), then the final validation (``--npz``)."""
    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.segmentor.splits import do_split
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    _check_2d(args.c)
    ds_dir, pp_dir, plan, lm, ds = _load_preprocessed(args)
    results_root = _roots(args, "results")
    overrides = {}
    if args.epochs:
        overrides["num_epochs"] = args.epochs
    if args.iters:
        overrides["iters_per_epoch"] = args.iters
        overrides["val_iters_per_epoch"] = max(1, args.iters // 5)
    variant = get_variant(args.tr, base=SegmentorTrainConfig(**overrides))
    fold = args.f if args.f == "all" else int(args.f)
    tr_keys, va_keys = do_split(ds.keys(), fold, os.path.join(pp_dir, "splits_final.json"))
    cfg_dir = _results_config_dir(results_root, os.path.basename(ds_dir), args.tr, args.c,
                                  plans_name=args.p or "ldPlans")
    os.makedirs(cfg_dir, exist_ok=True)
    plan.save(os.path.join(cfg_dir, "plans.json"))
    with open(os.path.join(pp_dir, "dataset.json")) as f:
        dj = f.read()
    with open(os.path.join(cfg_dir, "dataset.json"), "w") as f:
        f.write(dj)
    fold_dir = os.path.join(cfg_dir, f"fold_{fold}")
    trainer = SegmentorTrainer(plan, variant.config, output_dir=fold_dir, variant=variant,
                               label_manager=lm, device=args.device)
    trainer.disable_checkpointing = args.disable_checkpointing
    if args.val:
        names = ("checkpoint_best.pkl",) if args.val_best else \
            ("checkpoint_final.pkl", "checkpoint_best.pkl", "checkpoint_latest.pkl")
        ck = next((os.path.join(fold_dir, n) for n in names
                   if os.path.exists(os.path.join(fold_dir, n))), None)
        if ck is None:
            raise SystemExit(f"--val: no checkpoint under {fold_dir}"
                             + (" (--val_best needs checkpoint_best.pkl)"
                                if args.val_best else ""))
        trainer.load_checkpoint(ck)
    else:
        if args.pretrained_weights:
            if args.c_continue:  # run_training.py:76-86: resuming wins
                print("WARNING: --c resume requested — ignoring -pretrained_weights "
                      "(reference semantics)")
            else:
                trainer.load_pretrained(args.pretrained_weights)
        trainer.run_training(ds.subset(tr_keys), ds.subset(va_keys),
                             continue_training=args.c_continue)
    # the store's cases are z-scored already
    trainer.perform_actual_validation([ds[k].data for k in va_keys],
                                      [np.maximum(ds[k].seg, 0) for k in va_keys],
                                      save_npz=args.npz, normalize=False)
    print(f"fold {fold} done → {fold_dir}")
    return fold_dir


def cmd_predict(args) -> str:
    """Folder prediction (reference ``predict_from_raw_data.py:637-767``): the
    folds' ensemble, the variant's mirror axes, the regime's mask, and
    ``--save_probabilities``."""
    from PIL import Image

    from ldiffusion_tpu_torch.data.io import group_channel_files
    from ldiffusion_tpu_torch.segmentor.export import save_probabilities_npz
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.predictor import (
        SlidingWindowPredictor,
        find_fold_checkpoints,
    )
    from ldiffusion_tpu_torch.segmentor.variants import get_variant, inference_mirror_config

    _check_2d(args.c)
    if args.prev_stage_predictions:
        raise NotImplementedError(f"-prev_stage_predictions (the cascade) {_LATER_3D}")
    results_root = _roots(args, "results")
    raw_root = args.raw or env_paths.raw_dir(warn=False)
    ds_name = os.path.basename(find_dataset_dir(raw_root, args.d)) if raw_root \
        else f"Dataset{int(args.d):03d}"
    cfg_dir = _results_config_dir(results_root, ds_name, args.tr, args.c,
                                  plans_name=args.p or "ldPlans")
    if not os.path.isdir(cfg_dir):
        raise SystemExit(f"{cfg_dir} missing — train first")
    plan = SegPlan.load(os.path.join(cfg_dir, "plans.json"))
    lm, _ = _label_manager(cfg_dir)
    ckpts = find_fold_checkpoints(cfg_dir, folds=args.f, checkpoint_name=args.chk)
    mirror, axes = inference_mirror_config(get_variant(args.tr), len(plan.patch_size))
    predictor = SlidingWindowPredictor.from_checkpoints(
        plan, ckpts, use_mirroring=(not args.disable_tta) and mirror, mirror_axes=axes,
        label_manager=lm, tile_step_size=args.step_size, device=args.device)
    os.makedirs(args.o, exist_ok=True)
    n = 0
    cases = sorted(group_channel_files(args.i, ".png").items())
    for case, files in cases[args.part_id::args.num_parts]:  # :226-231
        out_png = os.path.join(args.o, f"{case}.png")
        if args.continue_prediction and os.path.exists(out_png):
            continue
        img = _load_png_channels([os.path.join(args.i, f) for f in files])
        logits = predictor.predict_logits(img)
        Image.fromarray(lm.convert_logits_to_segmentation(logits).astype(np.uint8)).save(out_png)
        if args.save_probabilities:
            save_probabilities_npz(logits, os.path.join(args.o, f"{case}.npz"),
                                   label_manager=lm)
        n += 1
    print(f"{n} predictions → {args.o}")
    return args.o


def cmd_extract_fingerprint(args) -> str:
    """The fingerprint, reused when it exists unless ``--clean``
    (``fingerprint_extractor.py:107-114``)."""
    from ldiffusion_tpu_torch.segmentor.fingerprint import extract_fingerprint

    raw_root, pp_root = _roots(args, "raw", "preprocessed")
    ds_dir = find_dataset_dir(raw_root, args.d)
    _label_manager(ds_dir)  # a volumetric dataset raises here
    out = _pp_dataset_dir(pp_root, ds_dir)
    path = os.path.join(out, "dataset_fingerprint.json")
    if os.path.exists(path) and not getattr(args, "clean", False):
        print(f"fingerprint exists, reusing {path} (--clean re-extracts)")
        return path
    _, images, labels = load_png_cases(ds_dir, "Tr")
    os.makedirs(out, exist_ok=True)
    _write_fingerprint(path, extract_fingerprint(images, labels))
    print(f"fingerprint → {path}")
    return path


def cmd_plan_experiment(args) -> str:
    from ldiffusion_tpu_torch.segmentor.planner import plan_experiment

    raw_root, pp_root = _roots(args, "raw", "preprocessed")
    ds_dir = find_dataset_dir(raw_root, args.d)
    out = _pp_dataset_dir(pp_root, ds_dir)
    fp_path = os.path.join(out, "dataset_fingerprint.json")
    if not os.path.exists(fp_path):
        cmd_extract_fingerprint(args)
    with open(fp_path) as f:
        fp = json.load(f)
    lm, dataset_json = _label_manager(ds_dir)
    plan = plan_experiment(fp, lm.num_segmentation_heads,
                           planner=_planner_kind(getattr(args, "pl", None)))
    plan.save(os.path.join(out, "plans.json"))
    with open(os.path.join(out, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    print(f"plans → {os.path.join(out, 'plans.json')}")
    return out


def cmd_preprocess(args) -> str:
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset

    raw_root, pp_root = _roots(args, "raw", "preprocessed")
    ds_dir = find_dataset_dir(raw_root, args.d)
    out = _pp_dataset_dir(pp_root, ds_dir)
    configurations = getattr(args, "c", None) or ["2d"]
    if "2d" not in configurations:
        print(f"no requested configuration in {configurations} exists for this 2d "
              "dataset — nothing to preprocess")
        return out
    if not os.path.exists(os.path.join(out, "plans.json")):
        cmd_plan_experiment(args)
    lm, _ = _label_manager(ds_dir)
    ids, images, labels = load_png_cases(ds_dir, "Tr")
    PreprocessedDataset.build(images, labels, _max_label_value(lm) + 1, case_ids=ids,
                              directory=os.path.join(out, "ldPlans_2d"))
    print(f"preprocessed {len(ids)} cases → {out}/ldPlans_2d")
    return out


def _load_seg_folder(folder):
    from PIL import Image

    files = sorted(f for f in os.listdir(folder) if f.lower().endswith(".png"))
    segs = []
    for f in files:
        with Image.open(os.path.join(folder, f)) as im:
            segs.append(np.asarray(im, np.uint8))
    return files, segs


def cmd_evaluate_folder(args):
    """Folder metrics (``evaluate_predictions.py:222-232``): ``-djfile``
    takes the labels or regions and the ignore label from a dataset.json,
    ``-l`` lists the labels."""
    from ldiffusion_tpu_torch.evaluate import compute_metrics_on_folder
    from ldiffusion_tpu_torch.segmentor.label_manager import label_manager_from_dataset_json

    ignore = args.il
    if args.djfile:
        lm = label_manager_from_dataset_json(_read_dataset_json(args.djfile))
        labels = lm.labels_or_regions_for_eval
        if ignore is None and lm.has_ignore_label:
            ignore = lm.ignore_label
        flat = [v for e in labels for v in (e if isinstance(e, (tuple, list)) else (e,))]
    elif args.l:
        labels = flat = [int(x) for x in args.l]
    else:
        raise SystemExit("evaluate_folder needs -l labels or -djfile dataset.json")
    summary = compute_metrics_on_folder(
        args.pred_folder, args.gt_folder, num_classes=int(max(flat)) + 1,
        output_file=args.o or os.path.join(args.pred_folder, "summary.json"),
        regions_or_labels=labels, ignore_label=ignore)
    print(f"foreground mean Dice {summary['foreground_mean']['Dice']:.4f}")
    return summary


def cmd_determine_postprocessing(args):
    """reference ``remove_connected_components.py``'s folder entry point."""
    from ldiffusion_tpu_torch.segmentor.postprocess import (
        determine_postprocessing,
        save_postprocessing,
    )

    _, preds = _load_seg_folder(args.i)
    _, gts = _load_seg_folder(args.ref)
    n = int(max(int(p.max()) for p in preds + gts)) + 1
    steps = determine_postprocessing(preds, gts, n)
    out = args.o or os.path.join(args.i, "postprocessing.json")
    save_postprocessing(steps, out)
    print(f"{len(steps)} postprocessing step(s) → {out}")
    return steps


def cmd_apply_postprocessing(args):
    from PIL import Image

    from ldiffusion_tpu_torch.segmentor.postprocess import (
        apply_postprocessing,
        load_postprocessing,
    )

    steps = load_postprocessing(args.pp_pkl_file)
    os.makedirs(args.o, exist_ok=True)
    files, segs = _load_seg_folder(args.i)
    for f, s in zip(files, segs):
        Image.fromarray(apply_postprocessing(s, steps)).save(os.path.join(args.o, f))
    print(f"{len(files)} files postprocessed → {args.o}")


def _not_ported(name: str):
    def cmd(args):
        raise NotImplementedError(f"the {name} subcommand is not ported yet "
                                  "(ROADMAP queue 1, *The remaining CLI commands*)")

    return cmd


# ---------------------------------------------------------------------------
# argument surface (the JAX CLI's, ``ldiffusion_tpu/segmentor/cli.py:1306-1556``)
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m ldiffusion_tpu_torch.segmentor",
                                description="nnUNet-style segmentor pipeline CLI")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("-d", type=int, required=True, help="dataset id")
        sp.add_argument("--raw", default=None, help="override LDIFFUSION_RAW")
        sp.add_argument("--preprocessed", default=None, help="override LDIFFUSION_PREPROCESSED")

    pp = sub.add_parser("plan_and_preprocess",
                        help="fingerprint + plan + preprocess (nnUNetv2_plan_and_preprocess)")
    common(pp)
    pp.add_argument("--verify_dataset_integrity", action="store_true")
    pp.add_argument("--hbm_budget", type=int, default=None,
                    help="volumetric planning memory budget in bytes (3D only)")
    pp.add_argument("-pl", default="default",
                    help="planner: default | resenc (reference planner class names like "
                         "nnUNetPlannerResEncM accepted)")
    pp.add_argument("--no_pp", action="store_true",
                    help="plan only, skip preprocessing (reference --no_pp)")
    pp.add_argument("-overwrite_target_spacing", nargs="+", type=float, default=None,
                    help="custom target spacing (z y x) for the 3D configurations")
    pp.add_argument("-preprocessor_name", default=None,
                    help="custom preprocessor class (registered via "
                         "@register('preprocessor') or found in "
                         "ldiffusion_tpu_torch.segmentor; default DefaultPreprocessor)")
    pp.add_argument("-overwrite_plans_name", default=None,
                    help="write plans under a custom identifier (consume with -p NAME in "
                         "train/predict)")
    pp.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"],
                    help="configurations to preprocess (reference -c; configurations that "
                         "do not exist for a dataset are skipped)")
    pp.add_argument("--clean", action="store_true",
                    help="re-extract the dataset fingerprint even if a cached "
                         "dataset_fingerprint.json exists (reference --clean)")
    pp.set_defaults(fn=cmd_plan_and_preprocess)

    tr = sub.add_parser("train", help="train one fold (nnUNetv2_train)")
    common(tr)
    tr.add_argument("-c", default="2d",
                    help="configuration: 2d | 3d_fullres | 3d_lowres | 3d_cascade_fullres")
    tr.add_argument("-f", default="0", help="fold index or 'all'")
    tr.add_argument("-tr", default="nnUNetTrainer", help="trainer variant name")
    tr.add_argument("-p", default="ldPlans",
                    help="plans identifier (custom NAME reads NAME.json from the "
                         "preprocessed dir and names the results dir trainer__NAME__config)")
    tr.add_argument("-pretrained_weights", default=None,
                    help="checkpoint .pkl whose shape-matched tensors initialize the fresh "
                         "model (nnUNetv2_train -pretrained_weights)")
    tr.add_argument("--c", dest="c_continue", action="store_true",
                    help="continue from latest checkpoint")
    tr.add_argument("--val", action="store_true",
                    help="validation only (needs a trained checkpoint)")
    tr.add_argument("--val_best", action="store_true",
                    help="with --val: validate checkpoint_best instead of final")
    tr.add_argument("--npz", action="store_true",
                    help="save validation probabilities as npz")
    tr.add_argument("--disable_checkpointing", action="store_true",
                    help="skip every checkpoint save (testing)")
    tr.add_argument("--epochs", type=int, default=None,
                    help="override epoch count (tests/smoke runs)")
    tr.add_argument("--iters", type=int, default=None,
                    help="override iterations/epoch (tests/smoke runs)")
    tr.add_argument("--results", default=None, help="override LDIFFUSION_RESULTS")
    tr.set_defaults(fn=cmd_train)

    pr = sub.add_parser("predict", help="predict a folder (nnUNetv2_predict)")
    pr.add_argument("-i", required=True, help="input folder of PNGs")
    pr.add_argument("-o", required=True, help="output folder")
    pr.add_argument("-d", type=int, required=True)
    pr.add_argument("-c", default="2d",
                    help="configuration: 2d | 3d_fullres | 3d_lowres | 3d_cascade_fullres")
    pr.add_argument("-f", nargs="+", default=["0", "1", "2", "3", "4"],
                    help="folds to ensemble (default: all five; untrained folds are skipped "
                         "with a warning)")
    pr.add_argument("-tr", default="nnUNetTrainer")
    pr.add_argument("-p", default="ldPlans", help="plans identifier")
    pr.add_argument("-chk", default=None,
                    help="exact checkpoint file name (e.g. checkpoint_final.pkl); default "
                         "prefers best, falling back to final")
    pr.add_argument("-step_size", type=float, default=0.5,
                    help="sliding-window step as a fraction of patch size")
    pr.add_argument("-num_parts", type=int, default=1,
                    help="split the input folder into this many parts")
    pr.add_argument("-part_id", type=int, default=0,
                    help="which part this invocation predicts (files[part_id::num_parts])")
    pr.add_argument("-prev_stage_predictions", default=None,
                    help="3d_cascade_fullres: folder of lowres-stage segmentations")
    pr.add_argument("--save_probabilities", action="store_true")
    pr.add_argument("--continue_prediction", action="store_true")
    pr.add_argument("--disable_tta", action="store_true")
    pr.add_argument("--raw", default=None)
    pr.add_argument("--results", default=None)
    pr.set_defaults(fn=cmd_predict)

    for name, fn in (("extract_fingerprint", cmd_extract_fingerprint),
                     ("plan_experiment", cmd_plan_experiment),
                     ("preprocess", cmd_preprocess)):
        sp = sub.add_parser(name, help=f"nnUNetv2_{name} analog")
        common(sp)
        if name == "plan_experiment":
            sp.add_argument("-pl", default="default", help="planner: default | resenc")
        if name == "extract_fingerprint":
            sp.add_argument("--clean", action="store_true",
                            help="overwrite an existing cached fingerprint")
        if name == "preprocess":
            sp.add_argument("-c", nargs="+", default=["2d", "3d_fullres", "3d_lowres"],
                            help="configurations to preprocess (reference -c)")
        sp.set_defaults(fn=fn)

    ev = sub.add_parser("evaluate_folder",
                        help="region-aware folder metrics (nnUNetv2_evaluate_simple)")
    ev.add_argument("gt_folder")
    ev.add_argument("pred_folder")
    ev.add_argument("-l", nargs="+", default=None, help="labels to score")
    ev.add_argument("-djfile", default=None,
                    help="dataset.json: labels/regions + ignore label come from the label "
                         "manager (nnUNetv2_evaluate_folder)")
    ev.add_argument("-il", type=int, default=None, help="ignore label")
    ev.add_argument("-o", default=None)
    ev.set_defaults(fn=cmd_evaluate_folder)

    dp = sub.add_parser("determine_postprocessing",
                        help="nnUNetv2_determine_postprocessing analog")
    dp.add_argument("-i", required=True, help="prediction folder")
    dp.add_argument("-ref", required=True, help="ground-truth folder")
    dp.add_argument("-o", default=None)
    dp.set_defaults(fn=cmd_determine_postprocessing)

    ap = sub.add_parser("apply_postprocessing", help="nnUNetv2_apply_postprocessing analog")
    ap.add_argument("-i", required=True)
    ap.add_argument("-o", required=True)
    ap.add_argument("-pp_pkl_file", required=True,
                    help="postprocessing.json from determine_postprocessing")
    ap.set_defaults(fn=cmd_apply_postprocessing)

    # not ported: the parser keeps their flags (ROADMAP queue 1, *The remaining
    # CLI commands*)
    en = sub.add_parser("ensemble", help="nnUNetv2_ensemble analog")
    en.add_argument("-i", nargs="+", required=True, help="prediction folders")
    en.add_argument("-o", required=True)
    en.add_argument("-d", type=int, default=None)
    en.add_argument("--raw", default=None)
    en.add_argument("--save_npz", action="store_true")
    bc = sub.add_parser("find_best_configuration",
                        help="nnUNetv2_find_best_configuration analog")
    common(bc)
    bc.add_argument("-c", nargs="+", default=["2d"])
    bc.add_argument("-tr", default="nnUNetTrainer")
    bc.add_argument("--results", default=None)
    bc.add_argument("--disable_tta", action="store_true")
    pm = sub.add_parser("predict_from_modelfolder",
                        help="nnUNetv2_predict_from_modelfolder analog")
    pm.add_argument("-i", required=True)
    pm.add_argument("-o", required=True)
    pm.add_argument("-m", required=True, help="model (config) folder")
    pm.add_argument("-f", nargs="+", default=["0", "1", "2", "3", "4"])
    pm.add_argument("-chk", default=None, help="exact checkpoint file name")
    pm.add_argument("-step_size", type=float, default=0.5)
    pm.add_argument("--save_probabilities", action="store_true")
    pm.add_argument("--disable_tta", action="store_true")
    ac = sub.add_parser("accumulate_crossval_results",
                        help="nnUNetv2_accumulate_crossval_results analog")
    ac.add_argument("-m", required=True, help="model (config) folder with fold_*")
    ac.add_argument("-o", default=None)
    ex = sub.add_parser("export_model", help="nnUNetv2_export_model_to_zip analog")
    ex.add_argument("model_dir")
    ex.add_argument("-o", required=True)
    im = sub.add_parser("install_model", help="nnUNetv2_install_pretrained_model_from_zip analog")
    im.add_argument("zip")
    im.add_argument("-o", required=True)
    dl = sub.add_parser("download_model", help="nnUNetv2_download_pretrained_model_by_url analog")
    dl.add_argument("url")
    dl.add_argument("-o", required=True, help="install target directory")
    ms = sub.add_parser("convert_msd", help="nnUNetv2_convert_MSD_dataset analog")
    ms.add_argument("-i", required=True)
    ms.add_argument("-o", required=True)
    co = sub.add_parser("convert_old_dataset", help="nnUNetv2_convert_old_nnUNet_dataset analog")
    co.add_argument("-i", required=True, help="old-format dataset folder")
    co.add_argument("-o", required=True, help="target DatasetXXX_Name folder")
    co.add_argument("--file_ending", default=".nii.gz")
    ov = sub.add_parser("plot_overlays", help="nnUNetv2_plot_overlay_pngs analog")
    ov.add_argument("image_folder")
    ov.add_argument("seg_folder")
    ov.add_argument("-o", required=True)
    mv = sub.add_parser("move_plans", help="nnUNetv2_move_plans_between_datasets analog")
    mv.add_argument("-s", type=int, required=True, help="source dataset id")
    mv.add_argument("-t", type=int, required=True, help="target dataset id")
    mv.add_argument("--raw", default=None)
    mv.add_argument("--preprocessed", default=None)
    for name, sp in (("ensemble", en), ("find_best_configuration", bc),
                     ("predict_from_modelfolder", pm), ("accumulate_crossval_results", ac),
                     ("export_model", ex), ("install_model", im), ("download_model", dl),
                     ("convert_msd", ms), ("convert_old_dataset", co),
                     ("plot_overlays", ov), ("move_plans", mv)):
        sp.set_defaults(fn=_not_ported(name))
    return p


def main(argv=None, device=None):
    """Parse ``argv`` and run the subcommand; training and prediction run on
    ``device`` (None: the card, raising when there is none)."""
    args = build_parser().parse_args(argv)
    args.device = device
    return args.fn(args)


if __name__ == "__main__":
    main()
