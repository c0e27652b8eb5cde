"""nnU-Net-style segmentor command line (counterpart of
``ldiffusion_tpu/segmentor/cli.py``; reference ``nnUNetv2_plan_and_preprocess``
/ ``nnUNetv2_train`` / ``nnUNetv2_predict``, ``run_training.py:212-271``,
``plan_and_preprocess_entrypoints.py:8-204``,
``predict_from_raw_data.py:637-767``):

    python -m ldiffusion_tpu_torch.segmentor plan_and_preprocess -d 1 [-pl nnUNetPlannerResEncM]
    python -m ldiffusion_tpu_torch.segmentor train -d 1 -c 2d -f 0 [-tr NAME] [-p NAME] [--npz]
    python -m ldiffusion_tpu_torch.segmentor predict -i IN -o OUT -d 1 -f 0 [--save_probabilities]

The dataset layout, the flags and every file written are the JAX CLI's:
``$LDIFFUSION_RAW/DatasetXXX_Name/{imagesTr,labelsTr,dataset.json}``
(channel files ``<case>_NNNN<ending>``), the preprocessed store under
``$LDIFFUSION_PREPROCESSED``, results under
``$LDIFFUSION_RESULTS/DatasetXXX_Name/<trainer>__<plans>__<config>/fold_<f>``
(``core/paths.py``; the ``nnUNet_*`` names as fallbacks). Training and
prediction run on the card unless ``main(argv, device="cpu")``.

A PNG dataset takes the 2D configuration (``-c 2d``). A volumetric one (any
other ``file_ending``: ``.npy`` with its spacing sidecar, or the gated
NIfTI/SimpleITK/TIFF readers of ``data/io.py``) is planned in every 3D
configuration (``plans_3d.json``: ``3d_fullres``, and ``3d_lowres`` +
``3d_cascade_fullres`` when the fullres patch covers under a quarter of the
median volume); ``train -c 3d_cascade_fullres`` reads the fullres store with
the lowres stage's segmentations appended as one-hot channels (cached under
``predicted_next_stage/3d_cascade_fullres``), and ``predict`` reads,
z-scores, resamples to the plan's spacing, predicts (the cascade runs the
lowres stage first, or reads ``-prev_stage_predictions``), resamples the mask
back and writes it through the dataset's reader.

Also here: ``extract_fingerprint`` / ``plan_experiment`` / ``preprocess``
(2D datasets, as in the JAX package), ``evaluate_folder``,
``determine_postprocessing``, ``apply_postprocessing``, and the workflow
after training: ``accumulate_crossval_results`` (the folds' validation
summaries merged), ``find_best_configuration`` (the 2D configurations and
their pairwise ensembles scored by cross-validation predictions on the
card, ``inference_information.json``), ``predict_from_modelfolder``,
``ensemble`` (the mean of ``--save_probabilities`` folders),
``export_model`` / ``install_model`` / ``download_model`` (zip archives),
``convert_msd``, ``convert_old_dataset``, ``plot_overlays`` and
``move_plans``.
"""
from __future__ import annotations

import argparse
import glob
import json
import math
import os
import time
from typing import Optional

import numpy as np

from ldiffusion_tpu_torch.core import paths as env_paths

VOLUMETRIC_CONFIGS = ("3d_fullres", "3d_lowres", "3d_cascade_fullres")


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
    return label_manager_from_dataset_json(dj), dj


def _is_volumetric_dataset(dataset_json) -> bool:
    return dataset_json.get("file_ending", ".png").lower() != ".png"


def load_volume_cases(ds_dir: str, split: str, dataset_json):
    """(case ids, volumes (Z, H, W, C) float32, labels (Z, H, W) int16 or
    None, spacings) of imagesTr/labelsTr (or Ts) through the dataset's
    reader; for Tr a ``"dataset"`` file list in dataset.json comes first
    (``ldiffusion_tpu/segmentor/cli.py:144-182``)."""
    from ldiffusion_tpu_torch.data.io import (
        determine_reader_writer_from_dataset_json,
        get_train_images_and_targets,
        group_channel_files,
    )

    rw = determine_reader_writer_from_dataset_json(dataset_json)
    ending = dataset_json.get("file_ending", ".npy").lower()
    if split == "Tr" and "dataset" in dataset_json:
        entries = sorted(get_train_images_and_targets(ds_dir, dataset_json).items())
    else:
        img_dir = os.path.join(ds_dir, f"images{split}")
        lbl_dir = os.path.join(ds_dir, f"labels{split}")
        groups = group_channel_files(img_dir, ending) if os.path.isdir(img_dir) else {}
        entries = [(case, {"images": [os.path.join(img_dir, f) for f in sorted(files)],
                           "label": os.path.join(lbl_dir, case + ending)})
                   for case, files in sorted(groups.items())]
    ids, vols, labs, spacings = [], [], [], []
    for case, entry in entries:
        data, props = rw.read_images(entry["images"])
        vols.append(np.moveaxis(data, 0, -1).astype(np.float32))
        labs.append(rw.read_seg(entry["label"])[0][0].astype(np.int16)
                    if os.path.exists(entry["label"]) else None)
        ids.append(case)
        spacings.append(tuple(props.get("spacing", (1.0, 1.0, 1.0))))
    return ids, vols, labs, spacings


def _pp_dataset_dir(pp_root: str, raw_ds_dir: str) -> str:
    return os.path.join(pp_root, os.path.basename(raw_ds_dir))


def _results_config_dir(results_root: str, raw_ds_name: str, trainer: str, config: str,
                        plans_name: str = "ldPlans") -> str:
    """``Dataset/<trainer>__<plans>__<config>`` (reference ``get_output_folder``)."""
    return os.path.join(results_root, raw_ds_name, f"{trainer}__{plans_name}__{config}")


def _plans_filename(args, volumetric: bool = False) -> str:
    """``-p``: the default identifier reads plans.json (plans_3d.json for a
    volumetric dataset), ``-p NAME`` NAME.json (NAME_3d.json)."""
    p = getattr(args, "p", None) or "ldPlans"
    if volumetric:
        return "plans_3d.json" if p == "ldPlans" else f"{p}_3d.json"
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
    spacing = args.overwrite_target_spacing
    if spacing is not None and len(spacing) != 3:
        raise SystemExit("-overwrite_target_spacing must be three numbers (z y x) — "
                         "reference plan_and_preprocess_entrypoints.py:54-62")
    if _is_volumetric_dataset(dataset_json):
        return _plan_and_preprocess_volumetric(args, ds_dir, pp_root, lm, dataset_json,
                                               preprocessor, plans_name)
    if spacing is not None:
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


def _plan_and_preprocess_volumetric(args, ds_dir, pp_root, lm, dataset_json, preprocessor,
                                    plans_name) -> str:
    """Fingerprint → every 3D configuration → each configuration's store
    ``ldPlans_<config>`` (the cascade shares the fullres one) and
    ``plans_3d.json`` (``NAME_3d.json`` under ``-overwrite_plans_name``)
    (``ldiffusion_tpu/segmentor/cli.py:345-401``). ``--hbm_budget`` plans
    for another memory budget than the JAX package's 8 GiB."""
    from ldiffusion_tpu_torch.segmentor.fingerprint import extract_fingerprint_3d
    from ldiffusion_tpu_torch.segmentor.planner3d import HBM_BUDGET_BYTES, plan_and_preprocess_3d
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset

    ids, vols, labs, spacings = load_volume_cases(ds_dir, "Tr", dataset_json)
    if not ids:
        raise SystemExit(f"no volumetric training cases under {ds_dir}/imagesTr")
    out = _pp_dataset_dir(pp_root, ds_dir)
    os.makedirs(out, exist_ok=True)
    fp_path = os.path.join(out, "dataset_fingerprint.json")
    if os.path.exists(fp_path) and not args.clean:
        print(f"fingerprint exists, reusing {fp_path} (--clean re-extracts)")
        with open(fp_path) as f:
            fingerprint = json.load(f)
    else:
        fingerprint = extract_fingerprint_3d(vols, labs, spacings=spacings, save_path=fp_path)
    plans_file = "plans_3d.json" if plans_name == "ldPlans" else f"{plans_name}_3d.json"
    configs, datasets = plan_and_preprocess_3d(
        vols, labs, lm.num_segmentation_heads, spacings=spacings,
        planner=_planner_kind(args.pl), hbm_budget=args.hbm_budget or HBM_BUDGET_BYTES,
        plans_path=os.path.join(out, plans_file), preprocess=not args.no_pp,
        target_spacing=args.overwrite_target_spacing, preprocessor=preprocessor,
        configurations=args.c, fingerprint=fingerprint)
    for name, ds in datasets.items():
        keyed = {cid: ds[f"case_{i:03d}"] for i, cid in enumerate(ids)}
        PreprocessedDataset(cases=keyed).save(os.path.join(out, f"ldPlans_{name}"))
    with open(os.path.join(out, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    print(f"3D plans ({', '.join(sorted(configs))}) + preprocessed data written to {out}")
    return out


def _load_preprocessed_3d(args):
    """The configuration's plan from plans_3d.json and its store (the
    cascade reads the fullres store) (``cli.py:403-436``)."""
    from ldiffusion_tpu_torch.segmentor.plans_file import PlansFile
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset

    raw_root, pp_root = _roots(args, "raw", "preprocessed")
    ds_dir = find_dataset_dir(raw_root, args.d)
    pp_dir = _pp_dataset_dir(pp_root, ds_dir)
    plans_path = os.path.join(pp_dir, _plans_filename(args, volumetric=True))
    if not os.path.exists(plans_path):
        raise SystemExit(f"{plans_path} missing — run plan_and_preprocess on this "
                         "(volumetric) dataset first")
    pf = PlansFile(plans_path)
    if args.c not in pf.configuration_names():
        raise SystemExit(
            f"configuration {args.c!r} was not planned for this dataset (planned: "
            f"{sorted(pf.configuration_names())}; 3d_lowres/3d_cascade_fullres only exist "
            "when the fullres patch covers <25% of the median volume, reference "
            "default_experiment_planner.py:371-500)")
    plan = pf.get_configuration(args.c)
    lm, _ = _label_manager(pp_dir)
    base = "3d_fullres" if args.c == "3d_cascade_fullres" else args.c
    store = os.path.join(pp_dir, f"ldPlans_{base}")
    if not os.path.isdir(store):
        raise SystemExit(f"{store} missing — run plan_and_preprocess first")
    return ds_dir, pp_dir, plan, lm, PreprocessedDataset.load(store)


def _ensure_prev_stage_predictions(pp_dir: str, results_root: str, ds_name: str,
                                   trainer_name: str, lowres_plan, ds, device=None) -> str:
    """The lowres stage's segmentations on the fullres grid, cached as
    ``predicted_next_stage/3d_cascade_fullres/<case>.npy``
    (``cli.py:438-507``): each trained lowres fold predicts its own
    validation cases (``splits_final.json``); cases whose fold is untrained
    are predicted by the ensemble of the trained folds, which saw them in
    training, with a warning."""
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset
    from ldiffusion_tpu_torch.segmentor.resample import resample_data_3d
    from ldiffusion_tpu_torch.segmentor.splits import do_split

    out = os.path.join(pp_dir, "predicted_next_stage", "3d_cascade_fullres")
    missing = [cid for cid in ds.keys() if not os.path.exists(os.path.join(out, f"{cid}.npy"))]
    if not missing:
        return out
    low_dir = _results_config_dir(results_root, ds_name, trainer_name, "3d_lowres")
    fold_ckpts = {}
    for f in range(5):
        for name in ("checkpoint_best.pkl", "checkpoint_final.pkl"):
            p = os.path.join(low_dir, f"fold_{f}", name)
            if os.path.exists(p):
                fold_ckpts[f] = p
                break
    if not fold_ckpts:
        raise SystemExit("3d_cascade_fullres requires a trained 3d_lowres stage — run "
                         f"`train -d ... -c 3d_lowres` first (no checkpoints under {low_dir})")
    low_ds = PreprocessedDataset.load(os.path.join(pp_dir, "ldPlans_3d_lowres"))
    splits_file = os.path.join(pp_dir, "splits_final.json")
    os.makedirs(out, exist_ok=True)

    def write(predictor, cid):
        seg = np.asarray(predictor.predict(low_ds[cid].data, normalize=False))
        tgt = tuple(ds[cid].seg.shape)
        if tuple(seg.shape) != tgt:
            seg = resample_data_3d(seg, tgt, lowres_plan.spacing, is_seg=True)
        np.save(os.path.join(out, f"{cid}.npy"), seg.astype(np.int16))

    remaining = set(missing)
    for f, ckpt in sorted(fold_ckpts.items()):
        _, va_keys = do_split(ds.keys(), f, splits_file)
        mine = remaining & set(va_keys)
        if not mine:
            continue
        predictor = SlidingWindowPredictor.from_checkpoints(lowres_plan, [ckpt], device=device)
        for cid in sorted(mine):
            write(predictor, cid)
        remaining -= mine
    if remaining:
        print(f"WARNING: lowres folds {sorted(set(range(5)) - set(fold_ckpts))} are untrained "
              f"— {len(remaining)} case(s) predicted with an ensemble of the trained folds, "
              "which SAW them in training (train/inference leak for the cascade stage; train "
              "all 5 lowres folds to avoid this)")
        predictor = SlidingWindowPredictor.from_checkpoints(
            lowres_plan, sorted(fold_ckpts.values()), device=device)
        for cid in sorted(remaining):
            write(predictor, cid)
    print(f"3d_cascade_fullres: {len(missing)} lowres-stage prediction(s) → {out}")
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
    (``--val_best``), then the final validation (``--npz``).

    Under ``torch.distributed.run`` the fold trains over the largest number
    of processes that divides the planned batch and the world, ``k = gcd``
    (``ldiffusion_tpu/segmentor/cli.py:589-598``): the first ``k`` ranks
    train under DDP in a subgroup; the others write nothing and return once
    the subgroup is made, so that none of them waits in a collective for the
    length of a fold. The split, the configuration folder and the cascade's
    lowres predictions are made on rank 0."""
    from ldiffusion_tpu_torch.core.config import MeshConfig, SegmentorTrainConfig
    from ldiffusion_tpu_torch.core.dist import (
        make_mesh,
        maybe_init_distributed,
        on_main,
        process_count,
    )
    from ldiffusion_tpu_torch.segmentor.splits import do_split
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    maybe_init_distributed(args.device)
    if args.c in VOLUMETRIC_CONFIGS:
        ds_dir, pp_dir, plan, lm, ds = _load_preprocessed_3d(args)
    elif args.c == "2d":
        ds_dir, pp_dir, plan, lm, ds = _load_preprocessed(args)
    else:
        raise SystemExit(f"unknown configuration {args.c!r} — use 2d, "
                         f"{', '.join(VOLUMETRIC_CONFIGS)}")
    results_root = _roots(args, "results")
    overrides = {}
    if args.epochs:
        overrides["num_epochs"] = args.epochs
    if args.iters:
        overrides["iters_per_epoch"] = args.iters
        overrides["val_iters_per_epoch"] = max(1, args.iters // 5)
    variant = get_variant(args.tr, base=SegmentorTrainConfig(**overrides))
    fold = args.f if args.f == "all" else int(args.f)
    tr_keys, va_keys = on_main(do_split, ds.keys(), fold,
                               os.path.join(pp_dir, "splits_final.json"))
    cfg_dir = _results_config_dir(results_root, os.path.basename(ds_dir), args.tr, args.c,
                                  plans_name=args.p or "ldPlans")

    def write_config_dir():
        os.makedirs(cfg_dir, exist_ok=True)
        plan.save(os.path.join(cfg_dir, "plans.json"))
        with open(os.path.join(pp_dir, "dataset.json")) as f:
            dj = f.read()
        with open(os.path.join(cfg_dir, "dataset.json"), "w") as f:
            f.write(dj)

    on_main(write_config_dir)
    if args.c == "3d_cascade_fullres":  # the fullres store + the lowres stage's one-hot
        from ldiffusion_tpu_torch.segmentor.plans_file import PlansFile
        from ldiffusion_tpu_torch.segmentor.preprocess import (
            PreprocessedDataset,
            append_prev_stage_channels,
        )

        lowres_plan = PlansFile(os.path.join(pp_dir, "plans_3d.json")) \
            .get_configuration("3d_lowres")
        prev_dir = on_main(_ensure_prev_stage_predictions, pp_dir, results_root,
                           os.path.basename(ds_dir), args.tr, lowres_plan, ds,
                           device=args.device)
        ds = PreprocessedDataset(cases={
            cid: append_prev_stage_channels(ds[cid], np.load(os.path.join(prev_dir, f"{cid}.npy")),
                                            plan.num_classes)
            for cid in ds.keys()})
    fold_dir = os.path.join(cfg_dir, f"fold_{fold}")
    k = math.gcd(plan.batch_size, process_count())  # the batch splits over k ranks
    mesh = make_mesh(MeshConfig(data=k, fsdp=1, tensor=1), args.device, ranks=range(k))
    if not mesh.member:
        return fold_dir
    trainer = SegmentorTrainer(plan, variant.config, output_dir=fold_dir, variant=variant,
                               label_manager=lm, device=args.device, mesh=mesh)
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
    # the store's cases are z-scored already (and the cascade's one-hot stays {0, 1})
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

    if args.c in VOLUMETRIC_CONFIGS:
        return _cmd_predict_volumetric(args)
    if args.c != "2d":
        raise SystemExit(f"unknown configuration {args.c!r} — use 2d, "
                         f"{', '.join(VOLUMETRIC_CONFIGS)}")
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


def _cmd_predict_volumetric(args) -> str:
    """Volumetric folder prediction (``cli.py:642-785``): read → z-score →
    resample to the plan's spacing → sliding window (the cascade first runs
    the lowres stage on its grid and brings its mask to the input's grid, as
    ``predict -c 3d_lowres`` writes it, or reads ``-prev_stage_predictions``;
    then appends it as one-hot channels) → the mask resampled back to the
    input's grid → written through the dataset's reader. Whole volumes are
    predicted (no crop to nonzero), as in the JAX CLI. Prints one ``timing
    predict {json}`` line: the host seconds of each case's steps and the
    network's forwards."""
    from ldiffusion_tpu_torch.data.io import (
        determine_reader_writer_from_dataset_json,
        group_channel_files,
    )
    from ldiffusion_tpu_torch.segmentor.export import save_probabilities_npz
    from ldiffusion_tpu_torch.segmentor.planner3d import SegPlan3D
    from ldiffusion_tpu_torch.segmentor.predictor import (
        SlidingWindowPredictor,
        find_fold_checkpoints,
    )
    from ldiffusion_tpu_torch.segmentor.resample import compute_new_shape, resample_data_3d
    from ldiffusion_tpu_torch.segmentor.variants import get_variant, inference_mirror_config

    results_root = _roots(args, "results")
    raw_root = args.raw or env_paths.raw_dir(warn=False)
    ds_name = os.path.basename(find_dataset_dir(raw_root, args.d)) if raw_root \
        else f"Dataset{int(args.d):03d}"
    plans_name = args.p or "ldPlans"
    cfg_dir = _results_config_dir(results_root, ds_name, args.tr, args.c, plans_name)
    if not os.path.isdir(cfg_dir):
        raise SystemExit(f"{cfg_dir} missing — train first")
    plan = SegPlan3D.load(os.path.join(cfg_dir, "plans.json"))
    lm, dataset_json = _label_manager(cfg_dir)
    ckpts = find_fold_checkpoints(cfg_dir, folds=args.f, checkpoint_name=args.chk)
    mirror, axes = inference_mirror_config(get_variant(args.tr), 3)
    use_mirroring = (not args.disable_tta) and mirror
    predictor = SlidingWindowPredictor.from_checkpoints(
        plan, ckpts, use_mirroring=use_mirroring, mirror_axes=axes, label_manager=lm,
        tile_step_size=args.step_size, device=args.device)
    prev_predictor = prev_plan = None
    if args.c == "3d_cascade_fullres" and not args.prev_stage_predictions:
        low_dir = _results_config_dir(results_root, ds_name, args.tr, "3d_lowres", plans_name)
        if not os.path.isdir(low_dir):
            raise SystemExit(f"cascade prediction requires the trained 3d_lowres stage "
                             f"({low_dir} missing) or an explicit -prev_stage_predictions "
                             "folder")
        prev_plan = SegPlan3D.load(os.path.join(low_dir, "plans.json"))
        prev_predictor = SlidingWindowPredictor.from_checkpoints(
            prev_plan, find_fold_checkpoints(low_dir, folds=args.f),
            use_mirroring=use_mirroring, mirror_axes=axes, device=args.device)

    rw = determine_reader_writer_from_dataset_json(dataset_json)
    ending = dataset_json.get("file_ending", ".npy").lower()
    os.makedirs(args.o, exist_ok=True)

    def to_grid(vol, spacing, target_spacing):
        if tuple(spacing) == tuple(target_spacing):
            return vol
        return resample_data_3d(vol, compute_new_shape(vol.shape[:3], spacing, target_spacing),
                                spacing, order=3)

    timing = []
    cases = sorted(group_channel_files(args.i, ending).items())
    for case, files in cases[args.part_id::args.num_parts]:
        out_path = os.path.join(args.o, f"{case}{ending}")
        if args.continue_prediction and os.path.exists(out_path):
            continue
        t = {"case": case}
        t0 = time.perf_counter()
        data, props = rw.read_images([os.path.join(args.i, f) for f in sorted(files)])
        vol = np.moveaxis(data, 0, -1).astype(np.float32)  # (Z, H, W, c)
        spacing = tuple(props.get("spacing", (1.0, 1.0, 1.0)))
        mean = vol.mean(axis=(0, 1, 2), keepdims=True)
        std = vol.std(axis=(0, 1, 2), keepdims=True)
        vol_n = (vol - mean) / np.maximum(std, 1e-8)
        t["read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        grid = to_grid(vol_n, spacing, plan.spacing)  # z-scored: predict with normalize=False
        t["resample_s"] = time.perf_counter() - t0
        if args.c == "3d_cascade_fullres":
            t0 = time.perf_counter()
            if args.prev_stage_predictions:  # predict_from_raw_data.py:676-727
                pf = os.path.join(args.prev_stage_predictions, f"{case}{ending}")
                if not os.path.exists(pf):
                    raise SystemExit(f"-prev_stage_predictions: {pf} missing")
                seg_low = rw.read_seg(pf)[0][0].astype(np.int32)
            else:  # what `predict -c 3d_lowres` writes, bit for bit
                low = to_grid(vol_n, spacing, prev_plan.spacing)
                seg_low = np.asarray(prev_predictor.predict(low, normalize=False))
                if tuple(seg_low.shape) != tuple(vol.shape[:3]):
                    seg_low = resample_data_3d(seg_low, vol.shape[:3], prev_plan.spacing,
                                               is_seg=True)
                seg_low = seg_low.astype(np.uint8).astype(np.int32)
            if tuple(seg_low.shape) != tuple(grid.shape[:3]):
                seg_low = resample_data_3d(seg_low, grid.shape[:3], spacing, is_seg=True)
            onehot = np.eye(plan.num_classes, dtype=np.float32)[np.maximum(seg_low, 0)][..., 1:]
            grid = np.concatenate([grid, onehot], axis=-1)
            print(f"3d_cascade_fullres: {case} consumed the lowres stage's segmentation "
                  f"({'-prev_stage_predictions' if args.prev_stage_predictions else 'predicted'}"
                  f", labels {sorted(int(v) for v in np.unique(seg_low))})")
            t["previous_stage_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        forwards = predictor.network_forwards
        logits = predictor.predict_logits(grid, normalize=False)
        t["sliding_window_s"] = time.perf_counter() - t0
        t["network_forwards"] = predictor.network_forwards - forwards
        t0 = time.perf_counter()
        seg = lm.convert_logits_to_segmentation(logits)
        if tuple(seg.shape) != tuple(vol.shape[:3]):
            seg = resample_data_3d(np.asarray(seg), vol.shape[:3], plan.spacing, is_seg=True)
        rw.write_seg(np.asarray(seg).astype(np.uint8), out_path, properties=props)
        if args.save_probabilities:
            save_probabilities_npz(logits, os.path.join(args.o, f"{case}.npz"),
                                   label_manager=lm)
        t["export_s"] = time.perf_counter() - t0
        timing.append(t)
    print(f"{len(timing)} volumetric predictions → {args.o}")
    print("timing predict " + json.dumps(timing))
    return args.o


def _require_2d_dataset(ds_dir: str, command: str):
    _, dj = _label_manager(ds_dir)
    if _is_volumetric_dataset(dj):
        raise SystemExit(f"{command} takes 2D (PNG) datasets, as in the JAX package; plan a "
                         "volumetric dataset with plan_and_preprocess")


def cmd_extract_fingerprint(args) -> str:
    """The fingerprint, reused when it exists unless ``--clean``
    (``fingerprint_extractor.py:107-114``)."""
    from ldiffusion_tpu_torch.segmentor.fingerprint import extract_fingerprint

    raw_root, pp_root = _roots(args, "raw", "preprocessed")
    ds_dir = find_dataset_dir(raw_root, args.d)
    _require_2d_dataset(ds_dir, "extract_fingerprint")
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
    _require_2d_dataset(ds_dir, "plan_experiment")
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
    _require_2d_dataset(ds_dir, "preprocess")
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


def cmd_ensemble(args):
    """The mean of the ``--save_probabilities`` npz payloads of several
    prediction folders (reference ``ensemble.py:entry_point_ensemble_folders``):
    ``-d`` paints the mean through the dataset's label manager (the regions
    need it), else its argmax is the mask; ``--save_npz`` keeps the mean."""
    from PIL import Image

    from ldiffusion_tpu_torch.segmentor.best_config import ensemble_probabilities

    lm = None
    if args.d is not None:
        lm, _ = _label_manager(find_dataset_dir(_roots(args, "raw"), args.d))
    os.makedirs(args.o, exist_ok=True)
    names = sorted(f for f in os.listdir(args.i[0]) if f.endswith(".npz"))
    if not names:
        raise SystemExit(f"no .npz probability files in {args.i[0]} — predict with "
                         "--save_probabilities first")
    for n in names:
        probs = []
        for d in args.i:
            with np.load(os.path.join(d, n)) as z:
                probs.append(z["probabilities"].astype(np.float32))
        mean = ensemble_probabilities(probs)
        seg = lm.convert_probabilities_to_segmentation(mean) if lm is not None \
            else np.argmax(mean, axis=-1)
        Image.fromarray(seg.astype(np.uint8)).save(os.path.join(args.o, n[:-4] + ".png"))
        if args.save_npz:
            np.savez_compressed(os.path.join(args.o, n), probabilities=mean.astype(np.float16))
    print(f"ensembled {len(names)} cases from {len(args.i)} folders → {args.o}")


def cmd_find_best_configuration(args):
    """Score the trained 2D configurations by their cross-validation
    predictions, each fold predicting its own validation cases on the card,
    and their pairwise ensembles; write ``inference_information.json``
    (reference ``find_best_configuration_entry_point``). The JAX command
    reads the 2D store and loads each configuration's plans as a 2D plan,
    so a volumetric configuration is refused here."""
    import shutil

    from ldiffusion_tpu_torch.segmentor.best_config import find_best_configuration_from_folds
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset
    from ldiffusion_tpu_torch.segmentor.variants import get_variant, inference_mirror_config

    volumetric = [c for c in args.c if c != "2d"]
    if volumetric:
        raise SystemExit(f"find_best_configuration -c {' '.join(volumetric)}: only the 2d "
                         "configuration is scored, as in the JAX package, which reads the 2D "
                         "store ldPlans_2d and each configuration's plans as a 2D plan")
    raw_root, pp_root, results_root = _roots(args, "raw", "preprocessed", "results")
    ds_dir = find_dataset_dir(raw_root, args.d)
    pp_dir = _pp_dataset_dir(pp_root, ds_dir)
    ds = PreprocessedDataset.load(os.path.join(pp_dir, "ldPlans_2d"))
    lm, _ = _label_manager(pp_dir)
    configs = {}
    for c in args.c:
        cfg_dir = _results_config_dir(results_root, os.path.basename(ds_dir), args.tr, c)
        src = os.path.join(pp_dir, "splits_final.json")  # the folds' validation cases
        if os.path.exists(src):
            shutil.copy(src, os.path.join(cfg_dir, "splits_final.json"))
        configs[c] = (SegPlan.load(os.path.join(cfg_dir, "plans.json")), cfg_dir)
    mirror, axes = inference_mirror_config(get_variant(args.tr), 2)
    info = find_best_configuration_from_folds(
        configs, ds, num_classes=lm.num_segmentation_heads,
        output_json=os.path.join(results_root, os.path.basename(ds_dir),
                                 "inference_information.json"),
        use_mirroring=(not args.disable_tta) and mirror, mirror_axes=axes, label_manager=lm,
        device=args.device)
    print(f"best configuration: {info['best_configuration']} (fg dice {info['score']:.4f})")
    return info


def cmd_predict_from_modelfolder(args):
    """Predict a PNG folder from an explicit model folder holding plans.json,
    dataset.json and ``fold_*`` checkpoints (reference
    ``predict_entry_point_modelfolder``): the trainer's mirror restrictions
    come from the folder's name (``<trainer>__<plans>__<config>``), ``-f``
    skips untrained folds with a warning."""
    from PIL import Image

    from ldiffusion_tpu_torch.data.io import group_channel_files
    from ldiffusion_tpu_torch.segmentor.export import save_probabilities_npz
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.predictor import (
        SlidingWindowPredictor,
        find_fold_checkpoints,
    )
    from ldiffusion_tpu_torch.segmentor.variants import (
        KNOWN_VARIANT_NAMES,
        get_variant,
        inference_mirror_config,
    )

    cfg_dir = args.m
    plan = SegPlan.load(os.path.join(cfg_dir, "plans.json"))
    lm, _ = _label_manager(cfg_dir)
    ckpts = find_fold_checkpoints(cfg_dir, folds=args.f, checkpoint_name=args.chk)
    tr_name = os.path.basename(os.path.normpath(cfg_dir)).split("__")[0]
    variant = get_variant(tr_name) if tr_name in KNOWN_VARIANT_NAMES else None
    mirror, axes = inference_mirror_config(variant, len(plan.patch_size))
    predictor = SlidingWindowPredictor.from_checkpoints(
        plan, ckpts, use_mirroring=(not args.disable_tta) and mirror, mirror_axes=axes,
        label_manager=lm, tile_step_size=args.step_size, device=args.device)
    os.makedirs(args.o, exist_ok=True)
    n = 0
    for case, files in sorted(group_channel_files(args.i, ".png").items()):
        logits = predictor.predict_logits(_load_png_channels([os.path.join(args.i, f)
                                                              for f in files]))
        Image.fromarray(lm.convert_logits_to_segmentation(logits).astype(np.uint8)).save(
            os.path.join(args.o, f"{case}.png"))
        if args.save_probabilities:
            save_probabilities_npz(logits, os.path.join(args.o, f"{case}.npz"),
                                   label_manager=lm)
        n += 1
    print(f"{n} predictions → {args.o}")
    return args.o


def cmd_accumulate_crossval_results(args):
    """The folds' validation summaries merged into one cross-validation
    summary (reference ``accumulate_cv_results``): the per-case entries
    concatenated, each entry's Dice and IoU averaged without NaNs."""
    cfg_dir = args.m
    folds = sorted(d for d in os.listdir(cfg_dir) if d.startswith("fold_"))
    per_case = []
    for d in folds:
        p = os.path.join(cfg_dir, d, "validation", "summary.json")
        if os.path.exists(p):
            with open(p) as f:
                per_case.extend(json.load(f)["metric_per_case"])
    if not per_case:
        raise SystemExit(f"no fold validation summaries under {cfg_dir}")
    entries = list(per_case[0]["metrics"].keys())
    mean = {}
    for e in entries:
        mean[e] = {}
        for key in ("Dice", "IoU"):
            vals = [c["metrics"][e][key] for c in per_case
                    if not (isinstance(c["metrics"][e][key], float)
                            and np.isnan(c["metrics"][e][key]))]
            mean[e][key] = float(np.mean(vals)) if vals else float("nan")
    fg = [mean[e]["Dice"] for e in entries if e != "0" and not np.isnan(mean[e]["Dice"])]
    summary = {"metric_per_case": per_case, "mean": mean,
               "foreground_mean": {"Dice": float(np.mean(fg)) if fg else float("nan")}}
    out = args.o or os.path.join(cfg_dir, "crossval_results_summary.json")
    with open(out, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"CV summary over {len(folds)} folds ({len(per_case)} cases) → {out}")
    return summary


def cmd_export_model(args):
    from ldiffusion_tpu_torch.segmentor.model_sharing import export_model

    export_model(args.model_dir, args.o)
    print(f"model exported → {args.o}")


def cmd_install_model(args):
    from ldiffusion_tpu_torch.segmentor.model_sharing import import_model

    print(f"model installed → {import_model(args.zip, args.o)}")


def cmd_download_model(args):
    from ldiffusion_tpu_torch.segmentor.model_sharing import download_and_install_from_url

    print(f"model downloaded and installed → {download_and_install_from_url(args.url, args.o)}")


def cmd_convert_msd(args):
    from ldiffusion_tpu_torch.data.converters import convert_msd_dataset

    print(f"MSD dataset converted → {convert_msd_dataset(args.i, args.o)}")


def cmd_convert_old_dataset(args):
    """An old (v1) nnU-Net raw dataset in the current layout (reference
    ``convert_raw_dataset_from_old_nnunet_format.py:8-40``): the image and
    label folders copied, dataset.json translated (``modality`` →
    ``channel_names``, id → name labels → name → id, the case lists dropped,
    ``file_ending`` added)."""
    import shutil

    src, dst = args.i, args.o
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        s = os.path.join(src, sub)
        if os.path.isdir(s):
            shutil.copytree(s, os.path.join(dst, sub), dirs_exist_ok=True)
    with open(os.path.join(src, "dataset.json")) as f:
        dj = json.load(f)
    for k in ("tensorImageSize", "numTest", "training", "test"):
        dj.pop(k, None)
    if "modality" in dj:
        dj["channel_names"] = dj.pop("modality")
    if dj.get("labels") and all(str(k).lstrip("-").isdigit() for k in dj["labels"]):
        dj["labels"] = {v: int(k) for k, v in dj["labels"].items()}
    dj.setdefault("file_ending", args.file_ending)
    os.makedirs(dst, exist_ok=True)
    with open(os.path.join(dst, "dataset.json"), "w") as f:
        json.dump(dj, f, indent=2)
    print(f"old-format dataset converted → {dst}")
    return dst


def cmd_plot_overlays(args):
    """Each image (``<case>_0000.png`` or ``<case>.png``) with its case's mask
    blended over it (reference ``overlay_plots.py``)."""
    from PIL import Image

    from ldiffusion_tpu_torch.utils import save_segmentation_overlay

    os.makedirs(args.o, exist_ok=True)
    segs = {f[:-4]: f for f in os.listdir(args.seg_folder) if f.lower().endswith(".png")}
    n = 0
    for f in sorted(os.listdir(args.image_folder)):
        if not f.lower().endswith(".png"):
            continue
        case = f[:-9] if f.endswith("_0000.png") else f[:-4]
        if case not in segs:
            continue
        with Image.open(os.path.join(args.image_folder, f)) as im:
            img = np.asarray(im.convert("RGB"))
        with Image.open(os.path.join(args.seg_folder, segs[case])) as im:
            seg = np.asarray(im, np.uint8)
        save_segmentation_overlay(img, seg, os.path.join(args.o, f"{case}.png"))
        n += 1
    print(f"{n} overlays → {args.o}")


def cmd_move_plans(args):
    """Copy a dataset's plans.json into another dataset's preprocessed folder
    (reference ``move_plans_between_datasets``)."""
    import shutil

    pp_root, raw_root = _roots(args, "preprocessed", "raw")
    src = _pp_dataset_dir(pp_root, find_dataset_dir(raw_root, args.s))
    dst = _pp_dataset_dir(pp_root, find_dataset_dir(raw_root, args.t))
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(src, "plans.json"), os.path.join(dst, "plans.json"))
    print(f"plans moved {src} → {dst}")


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
    pr.add_argument("-i", required=True,
                    help="input folder (PNGs, or volumes in the dataset's file ending)")
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

    en = sub.add_parser("ensemble", help="nnUNetv2_ensemble analog")
    en.add_argument("-i", nargs="+", required=True, help="prediction folders")
    en.add_argument("-o", required=True)
    en.add_argument("-d", type=int, default=None)
    en.add_argument("--raw", default=None)
    en.add_argument("--save_npz", action="store_true")
    en.set_defaults(fn=cmd_ensemble)
    bc = sub.add_parser("find_best_configuration",
                        help="nnUNetv2_find_best_configuration analog")
    common(bc)
    bc.add_argument("-c", nargs="+", default=["2d"])
    bc.add_argument("-tr", default="nnUNetTrainer")
    bc.add_argument("--results", default=None)
    bc.add_argument("--disable_tta", action="store_true")
    bc.set_defaults(fn=cmd_find_best_configuration)
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
    pm.set_defaults(fn=cmd_predict_from_modelfolder)
    ac = sub.add_parser("accumulate_crossval_results",
                        help="nnUNetv2_accumulate_crossval_results analog")
    ac.add_argument("-m", required=True, help="model (config) folder with fold_*")
    ac.add_argument("-o", default=None)
    ac.set_defaults(fn=cmd_accumulate_crossval_results)
    ex = sub.add_parser("export_model", help="nnUNetv2_export_model_to_zip analog")
    ex.add_argument("model_dir")
    ex.add_argument("-o", required=True)
    ex.set_defaults(fn=cmd_export_model)
    im = sub.add_parser("install_model", help="nnUNetv2_install_pretrained_model_from_zip analog")
    im.add_argument("zip")
    im.add_argument("-o", required=True)
    im.set_defaults(fn=cmd_install_model)
    dl = sub.add_parser("download_model", help="nnUNetv2_download_pretrained_model_by_url analog")
    dl.add_argument("url")
    dl.add_argument("-o", required=True, help="install target directory")
    dl.set_defaults(fn=cmd_download_model)
    ms = sub.add_parser("convert_msd", help="nnUNetv2_convert_MSD_dataset analog")
    ms.add_argument("-i", required=True)
    ms.add_argument("-o", required=True)
    ms.set_defaults(fn=cmd_convert_msd)
    co = sub.add_parser("convert_old_dataset", help="nnUNetv2_convert_old_nnUNet_dataset analog")
    co.add_argument("-i", required=True, help="old-format dataset folder")
    co.add_argument("-o", required=True, help="target DatasetXXX_Name folder")
    co.add_argument("--file_ending", default=".nii.gz")
    co.set_defaults(fn=cmd_convert_old_dataset)
    ov = sub.add_parser("plot_overlays", help="nnUNetv2_plot_overlay_pngs analog")
    ov.add_argument("image_folder")
    ov.add_argument("seg_folder")
    ov.add_argument("-o", required=True)
    ov.set_defaults(fn=cmd_plot_overlays)
    mv = sub.add_parser("move_plans", help="nnUNetv2_move_plans_between_datasets analog")
    mv.add_argument("-s", type=int, required=True, help="source dataset id")
    mv.add_argument("-t", type=int, required=True, help="target dataset id")
    mv.add_argument("--raw", default=None)
    mv.add_argument("--preprocessed", default=None)
    mv.set_defaults(fn=cmd_move_plans)
    return p


def main(argv=None, device=None):
    """Parse ``argv`` and run the subcommand; training and prediction run on
    ``device`` (None: the card, raising when there is none)."""
    args = build_parser().parse_args(argv)
    args.device = device
    return args.fn(args)


if __name__ == "__main__":
    main()
