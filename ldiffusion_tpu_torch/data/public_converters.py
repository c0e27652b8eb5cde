"""Public-dataset converters (counterpart of
``ldiffusion_tpu/data/public_converters.py``): nnU-Net's 11
``DatasetXXX_*.py`` scripts (``dataset_conversion/Dataset{027,073,114,115,
120,137,218,219,220,221,988}_*.py``) as functions, each laying a downloaded
public dataset out as a raw dataset (imagesTr/labelsTr[/imagesTs] +
dataset.json), and their command line:

    python -m ldiffusion_tpu_torch.data.public_converters acdc -i SRC [-d 27] [--raw_root R]

As in the JAX package:

* the functions take explicit source and output roots (``raw_root``
  defaults to ``$LDIFFUSION_RAW`` / ``$nnUNet_raw``, ``core/paths.py``);
* file contents (label remapping, 4D frame extraction) go through the
  reader/writer registry of ``data/io.py`` by file ending, so ``.npy``
  sources convert without nibabel or SimpleITK, and ``.nii.gz`` ones where
  nibabel is installed;
* plain loops, no process pools;
* the M&Ms vendor splits, which the reference shuffles with the unseeded
  global RNG, take a ``seed``.

The integration-test generators and the MSD converter are in
``data/converters.py``.
"""
from __future__ import annotations

import csv
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ldiffusion_tpu_torch.data.converters import generate_dataset_json


def _raw_root(raw_root: Optional[str]) -> str:
    if raw_root is not None:
        return raw_root
    from ldiffusion_tpu_torch.core.paths import raw_dir

    root = raw_dir()
    if not root:
        raise SystemExit("no raw-dataset root: pass raw_root or set "
                         "LDIFFUSION_RAW / nnUNet_raw")
    return root


def make_out_dirs(dataset_id: int, task_name: str = "ACDC",
                  raw_root: Optional[str] = None,
                  with_labels_ts: bool = False) -> Tuple[str, str, str, str]:
    """DatasetXXX_<task> skeleton (reference ``Dataset027_ACDC.py:9-22``)."""
    out_dir = os.path.join(_raw_root(raw_root),
                           f"Dataset{int(dataset_id):03d}_{task_name}")
    dirs = [os.path.join(out_dir, "imagesTr"),
            os.path.join(out_dir, "labelsTr"),
            os.path.join(out_dir, "imagesTs")]
    if with_labels_ts:
        dirs.append(os.path.join(out_dir, "labelsTs"))
    for d in dirs:
        os.makedirs(d, exist_ok=True)
    return (out_dir, *dirs[:3])


# ---------------------------------------------------------------------------
# Dataset027 ACDC / Dataset115 EMIDEC — cardiac MRI, copy + rename
# ---------------------------------------------------------------------------

def convert_acdc(src_data_folder: str, dataset_id: int = 27,
                 raw_root: Optional[str] = None) -> str:
    """ACDC cardiac MRI (reference ``Dataset027_ACDC.py:25-68``): per-patient
    dirs under training/ and testing/; ``*.nii.gz`` frames become cases
    (``_4d`` stacks excluded), ``*_gt*`` files are the labels (suffix
    stripped)."""
    out_dir, train_dir, labels_dir, test_dir = make_out_dirs(
        dataset_id, "ACDC", raw_root)

    def _is_image(fn: str) -> bool:
        return fn.endswith(".gz") and "_gt" not in fn and "_4d" not in fn

    num_training = 0
    train_root = os.path.join(src_data_folder, "training")
    for patient in sorted(os.listdir(train_root)):
        pdir = os.path.join(train_root, patient)
        if not os.path.isdir(pdir):
            continue
        for fn in sorted(os.listdir(pdir)):
            if _is_image(fn):
                stem = fn.split(".")[0]
                shutil.copy(os.path.join(pdir, fn),
                            os.path.join(train_dir, f"{stem}_0000.nii.gz"))
                num_training += 1
            elif fn.endswith(".gz") and "_gt" in fn:
                shutil.copy(os.path.join(pdir, fn),
                            os.path.join(labels_dir, fn.replace("_gt", "")))
    test_root = os.path.join(src_data_folder, "testing")
    if os.path.isdir(test_root):
        for patient in sorted(os.listdir(test_root)):
            pdir = os.path.join(test_root, patient)
            if not os.path.isdir(pdir):
                continue
            for fn in sorted(os.listdir(pdir)):
                if _is_image(fn):
                    stem = fn.split(".")[0]
                    shutil.copy(os.path.join(pdir, fn),
                                os.path.join(test_dir, f"{stem}_0000.nii.gz"))

    generate_dataset_json(out_dir, channel_names={0: "cineMRI"},
                          labels={"background": 0, "RV": 1, "MLV": 2, "LVC": 3},
                          file_ending=".nii.gz",
                          num_training_cases=num_training)
    return out_dir


def convert_emidec(src_data_dir: str, src_test_dir: str, dataset_id: int = 115,
                   raw_root: Optional[str] = None) -> str:
    """EMIDEC myocardial infarction (reference ``Dataset115_EMIDEC.py:8-46``):
    per-patient ``Images/<P>.nii.gz`` + ``Contours/<P>.nii.gz``."""
    out_dir, train_dir, labels_dir, test_dir = make_out_dirs(
        dataset_id, "EMIDEC", raw_root)
    patients = sorted(p for p in os.listdir(src_data_dir)
                      if os.path.isdir(os.path.join(src_data_dir, p)))
    for p in patients:
        stem = p.split(".")[0]
        shutil.copy(os.path.join(src_data_dir, p, "Images", f"{p}.nii.gz"),
                    os.path.join(train_dir, f"{stem}_0000.nii.gz"))
        shutil.copy(os.path.join(src_data_dir, p, "Contours", f"{p}.nii.gz"),
                    os.path.join(labels_dir, f"{stem}.nii.gz"))
    for p in sorted(os.listdir(src_test_dir)):
        pdir = os.path.join(src_test_dir, p)
        if not os.path.isdir(pdir):
            continue
        stem = p.split(".")[0]
        shutil.copy(os.path.join(pdir, "Images", f"{p}.nii.gz"),
                    os.path.join(test_dir, f"{stem}_0000.nii.gz"))

    generate_dataset_json(out_dir, channel_names={0: "cineMRI"},
                          labels={"background": 0, "cavity": 1,
                                  "normal_myocardium": 2,
                                  "myocardial_infarction": 3, "no_reflow": 4},
                          file_ending=".nii.gz",
                          num_training_cases=len(patients))
    return out_dir


# ---------------------------------------------------------------------------
# Dataset114 MNMs — 4D cine MRI: extract ED/ES frames + vendor splits
# ---------------------------------------------------------------------------

def read_mnms_csv(csv_file: str) -> Dict[str, Dict]:
    """patient -> {ed, es, vendor} from the M&Ms info csv (reference
    ``Dataset114_MNMs.py:14-32``)."""
    info: Dict[str, Dict] = {}
    with open(csv_file) as f:
        reader = csv.reader(f)
        headers = next(reader)
        pi = headers.index("External code")
        ed = headers.index("ED")
        es = headers.index("ES")
        vi = headers.index("Vendor")
        for row in reader:
            info[row[pi]] = {"ed": int(row[ed]), "es": int(row[es]),
                             "vendor": row[vi]}
    return info


def _load_4d(path: str) -> Tuple[np.ndarray, object]:
    """(H, W, D, T) volume + an affine/props token, dispatched by ending."""
    if path.endswith(".npy"):
        return np.load(path), None
    import nibabel as nib  # gated: medical-IO path

    img = nib.load(path)
    return np.asanyarray(img.dataobj), img.affine


def _save_3d(vol: np.ndarray, affine, path: str) -> None:
    if path.endswith(".npy"):
        np.save(path, vol)
        return
    import nibabel as nib

    nib.save(nib.Nifti1Image(vol, affine), path)


def convert_mnms(src_data_folder: str, csv_file_name: str,
                 dataset_id: int = 114, raw_root: Optional[str] = None,
                 file_ending: str = ".nii.gz") -> str:
    """M&Ms multi-vendor cardiac MRI (reference ``Dataset114_MNMs.py:38-91``):
    per patient, slice the ED and ES frames out of the 4D short-axis stack;
    labels carry no ``_0000`` channel suffix. ``file_ending=".npy"`` runs the
    same logic on numpy 4D stacks (without nibabel)."""
    out_dir, train_dir, labels_dir, test_dir = make_out_dirs(
        dataset_id, "MNMs", raw_root)
    info = read_mnms_csv(os.path.join(src_data_folder, csv_file_name))

    def _save_phases(patients_root: str, out_images: str,
                     out_labels: Optional[str]) -> int:
        n = 0
        if not os.path.isdir(patients_root):
            return n
        for patient in sorted(os.listdir(patients_root)):
            pdir = os.path.join(patients_root, patient)
            if not os.path.isdir(pdir):
                continue
            ed, es = info[patient]["ed"], info[patient]["es"]
            img4d, affine = _load_4d(
                os.path.join(pdir, f"{patient}_sa{file_ending}"))
            for frame in (ed, es):
                _save_3d(img4d[..., frame], affine,
                         os.path.join(out_images,
                                      f"{patient}_frame{frame:02d}_0000{file_ending}"))
                n += 1
            if out_labels is not None:
                lab4d, laffine = _load_4d(
                    os.path.join(pdir, f"{patient}_sa_gt{file_ending}"))
                for frame in (ed, es):
                    _save_3d(lab4d[..., frame], laffine,
                             os.path.join(out_labels,
                                          f"{patient}_frame{frame:02d}{file_ending}"))
        return n

    n_train = _save_phases(os.path.join(src_data_folder, "Training", "Labeled"),
                           train_dir, labels_dir)
    _save_phases(os.path.join(src_data_folder, "Testing"), test_dir, None)

    generate_dataset_json(out_dir, channel_names={0: "cineMRI"},
                          labels={"background": 0, "LVBP": 1, "LVM": 2, "RV": 3},
                          file_ending=file_ending,
                          num_training_cases=n_train)
    return out_dir


def create_mnms_custom_splits(src_data_folder: str, csv_file: str,
                              splits_file: str, num_val_patients: int = 25,
                              seed: int = 12345) -> List[Dict]:
    """Append the 12 vendor-combination splits from the M&Ms paper (table 3)
    to an existing splits_final.json (reference
    ``Dataset114_MNMs.py:96-136``): train on vendor A, B, or two A+B mixes;
    validate each on A, B, and A+B. The reference shuffles with the global
    unseeded RNG; here the shuffle is seeded (deviation, documented above)."""
    splits = json.load(open(splits_file))
    labeled = os.path.join(src_data_folder, "Training", "Labeled")
    patients_train = sorted(p for p in os.listdir(labeled)
                            if os.path.isdir(os.path.join(labeled, p)))
    info = {p: d for p, d in read_mnms_csv(
        os.path.join(src_data_folder, csv_file)).items() if p in patients_train}

    rng = np.random.default_rng(seed)

    def _vendor_split(patients: List[str]) -> Tuple[List[str], List[str]]:
        patients = list(patients)
        rng.shuffle(patients)
        n_train = len(patients) - num_val_patients
        if n_train <= 0:
            raise ValueError(
                f"vendor has {len(patients)} labeled patients but "
                f"num_val_patients={num_val_patients} — no training patients "
                f"would remain; pass a smaller num_val_patients")
        return patients[:n_train], patients[n_train:]

    def _frames(patients: Sequence[str]) -> List[str]:
        return [f"{p}_frame{info[p][f]:02d}" for p in patients
                for f in ("es", "ed")]

    pa = [p for p, d in info.items() if d["vendor"] == "A"]
    pb = [p for p, d in info.items() if d["vendor"] == "B"]
    train_a, val_a = _vendor_split(pa)
    train_b, val_b = _vendor_split(pb)
    train_a, train_b = _frames(train_a), _frames(train_b)
    val_a, val_b = _frames(val_a), _frames(val_b)
    mixes = [train_a, train_b,
             train_a[:len(train_a) // 2] + train_b[:len(train_b) // 2],
             train_a[len(train_a) // 2:] + train_b[len(train_b) // 2:]]
    for train_set in mixes:
        splits.append({"train": train_set, "val": val_a})
        splits.append({"train": train_set, "val": val_b})
        splits.append({"train": train_set, "val": val_a + val_b})
    with open(splits_file, "w") as f:
        json.dump(splits, f, indent=2)
    return splits


# ---------------------------------------------------------------------------
# Dataset073 Fluo-C3DH-A549-SIM — 3D tif + spacing sidecars + 2-fold split
# ---------------------------------------------------------------------------

def convert_fluo_c3dh_a549_sim(train_source: str, test_source: Optional[str],
                               dataset_id: int = 73,
                               raw_root: Optional[str] = None,
                               preprocessed_root: Optional[str] = None,
                               spacing: Sequence[float] = (1.0, 0.126, 0.126),
                               file_ending: str = ".tif") -> str:
    """Cell-tracking-challenge fluorescence volumes (reference
    ``Dataset073_Fluo_C3DH_A549_SIM.py``): sequences 01/02 with ``01_GT/SEG``
    labels; every case gets a ``{"spacing": ...}`` json sidecar (tif carries
    no reliable spacing — ``data/io.py:Tiff3DIO`` reads the same sidecar);
    plus the fixed 2-fold cross-sequence split."""
    task = "Fluo_C3DH_A549_SIM"
    out_dir, imagestr, labelstr, imagests = make_out_dirs(
        dataset_id, task, raw_root)

    def _sidecar(path: str) -> None:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump({"spacing": list(spacing)}, f)

    n_train = 0
    case_ids = []
    for seq in ("01", "02"):
        images_dir = os.path.join(train_source, seq)
        seg_dir = os.path.join(train_source, seq + "_GT", "SEG")
        images = sorted(f for f in os.listdir(images_dir)
                        if f.endswith(file_ending))
        segs = sorted(f for f in os.listdir(seg_dir)
                      if f.endswith(file_ending))
        for i, (im, se) in enumerate(zip(images, segs)):
            name = f"{seq}_image_{i:03d}"
            case_ids.append(name)
            img_out = os.path.join(imagestr, name + "_0000" + file_ending)
            seg_out = os.path.join(labelstr, name + file_ending)
            shutil.copy(os.path.join(images_dir, im), img_out)
            shutil.copy(os.path.join(seg_dir, se), seg_out)
            _sidecar(img_out)
            _sidecar(seg_out)
            n_train += 1
    if test_source:
        for seq in ("01", "02"):
            images_dir = os.path.join(test_source, seq)
            if not os.path.isdir(images_dir):
                continue
            images = sorted(f for f in os.listdir(images_dir)
                            if f.endswith(file_ending))
            for i, im in enumerate(images):
                name = f"{seq}_image_{i:03d}"
                img_out = os.path.join(imagests, name + "_0000" + file_ending)
                shutil.copy(os.path.join(images_dir, im), img_out)
                _sidecar(img_out)

    generate_dataset_json(out_dir, channel_names={0: "fluorescence_microscopy"},
                          labels={"background": 0, "cell": 1},
                          num_training_cases=n_train, file_ending=file_ending,
                          overwrite_image_reader_writer="Tiff3DIO"
                          if file_ending == ".tif" else None)

    # fixed cross-sequence 2-fold split (reference :76-85)
    splits = [
        {"train": [c for c in case_ids if c.startswith("01_")],
         "val": [c for c in case_ids if c.startswith("02_")]},
        {"train": [c for c in case_ids if c.startswith("02_")],
         "val": [c for c in case_ids if c.startswith("01_")]},
    ]
    if preprocessed_root:
        pp_dir = os.path.join(preprocessed_root, os.path.basename(out_dir))
        os.makedirs(pp_dir, exist_ok=True)
        with open(os.path.join(pp_dir, "splits_final.json"), "w") as f:
            json.dump(splits, f, indent=2)
    return out_dir


# ---------------------------------------------------------------------------
# Dataset120 RoadSegmentation — 2D PNG with white-area label cleanup
# ---------------------------------------------------------------------------

def _keep_large_components(mask: np.ndarray, min_size: int) -> np.ndarray:
    """Connected components of ``mask`` larger than ``min_size`` (the
    acvl-utils ``generic_filter_components`` call in the reference,
    ``Dataset120_RoadSegmentation.py:23-24``)."""
    from scipy import ndimage

    labeled, n = ndimage.label(mask)
    if n == 0:
        return np.zeros_like(mask, dtype=bool)
    sizes = ndimage.sum_labels(np.ones_like(labeled), labeled,
                               index=np.arange(1, n + 1))
    keep = np.flatnonzero(sizes > min_size) + 1
    return np.isin(labeled, keep)


def road_segmentation_clean_case(image: np.ndarray, seg: np.ndarray,
                                 min_component_size: int = 50) -> np.ndarray:
    """Road-label cleanup (reference ``Dataset120_RoadSegmentation.py:14-27``):
    255 → 1, then zero the label wherever the image is a large pure-white
    area (no data): white mask = channel-sum == 3*255, components >
    ``min_component_size`` kept, holes filled."""
    from scipy.ndimage import binary_fill_holes

    seg = seg.copy()
    seg[seg == 255] = 1
    white = image.astype(np.int64).sum(axis=2) == 3 * 255
    white = _keep_large_components(white, min_component_size)
    white = binary_fill_holes(white)
    seg[white] = 0
    return seg


def convert_road_segmentation(source: str, dataset_id: int = 120,
                              raw_root: Optional[str] = None,
                              min_component_size: int = 50) -> str:
    """Massachusetts roads (reference ``Dataset120_RoadSegmentation.py``):
    training/testing splits with input/ and output/ subfolders; only images
    WITH a segmentation are converted; the label is cleaned against the
    dataset's no-data white areas."""
    from PIL import Image

    task = "RoadSegmentation"
    out_dir, _, _, _ = make_out_dirs(dataset_id, task, raw_root,
                                     with_labels_ts=True)

    def _convert(split_src: str, img_sub: str, lbl_sub: str) -> int:
        out_imgs = os.path.join(out_dir, img_sub)
        out_lbls = os.path.join(out_dir, lbl_sub)
        seg_dir = os.path.join(split_src, "output")
        img_dir = os.path.join(split_src, "input")
        if not os.path.isdir(seg_dir):
            return 0
        n = 0
        for fn in sorted(os.listdir(seg_dir)):
            if not fn.endswith(".png"):
                continue
            image = np.asarray(Image.open(
                os.path.join(img_dir, fn)).convert("RGB"))
            seg = np.asarray(Image.open(os.path.join(seg_dir, fn)).convert("L"),
                             np.uint8)
            cleaned = road_segmentation_clean_case(image, seg,
                                                   min_component_size)
            Image.fromarray(cleaned).save(os.path.join(out_lbls, fn))
            shutil.copy(os.path.join(img_dir, fn),
                        os.path.join(out_imgs, fn[:-4] + "_0000.png"))
            n += 1
        return n

    n_train = _convert(os.path.join(source, "training"), "imagesTr", "labelsTr")
    _convert(os.path.join(source, "testing"), "imagesTs", "labelsTs")
    generate_dataset_json(out_dir, channel_names={0: "R", 1: "G", 2: "B"},
                          labels={"background": 0, "road": 1},
                          num_training_cases=n_train, file_ending=".png",
                          dataset_name=f"Dataset{int(dataset_id):03d}_{task}")
    return out_dir


# ---------------------------------------------------------------------------
# Dataset137 BraTS21 — label-convention remap both ways
# ---------------------------------------------------------------------------

BRATS_MODALITIES = ("t1", "t1ce", "t2", "flair")


def brats_labels_to_nnunet(seg: np.ndarray) -> np.ndarray:
    """BraTS {0,1,2,4} → continuous {0,2,1,3} (reference
    ``Dataset137_BraTS21.py:12-29``: 4→3, 2→1, 1→2; any other value is an
    error)."""
    uniques = np.unique(seg)
    bad = [int(u) for u in uniques if u not in (0, 1, 2, 4)]
    if bad:
        raise RuntimeError(f"unexpected BraTS label(s) {bad}")
    out = np.zeros_like(seg)
    out[seg == 4] = 3
    out[seg == 2] = 1
    out[seg == 1] = 2
    return out


def convert_labels_back_to_brats(seg: np.ndarray) -> np.ndarray:
    """Inverse remap for predictions (reference ``:32-37``)."""
    out = np.zeros_like(seg)
    out[seg == 1] = 2
    out[seg == 3] = 4
    out[seg == 2] = 1
    return out


def _remap_seg_file(in_file: str, out_file: str, remap) -> None:
    """Read a segmentation, remap values, write preserving geometry props —
    via the ending-dispatched reader/writer registry."""
    from ldiffusion_tpu_torch.data.io import determine_reader_writer

    ending = ".nii.gz" if in_file.endswith(".nii.gz") \
        else os.path.splitext(in_file)[1]
    rw = determine_reader_writer(ending)
    seg, props = rw.read_seg(in_file)
    rw.write_seg(remap(seg[0].astype(np.int64)), out_file, props)


def convert_brats21(brats_data_dir: str, dataset_id: int = 137,
                    raw_root: Optional[str] = None,
                    file_ending: str = ".nii.gz") -> str:
    """BraTS 2021 (reference ``Dataset137_BraTS21.py:59-98``): per-case
    ``<case>_{t1,t1ce,t2,flair}`` → channels 0000-0003, seg remapped to the
    continuous convention; region-based labels (whole/core/enhancing) with
    ``regions_class_order=(1, 2, 3)``."""
    task = "BraTS2021"
    out_dir = os.path.join(_raw_root(raw_root),
                           f"Dataset{int(dataset_id):03d}_{task}")
    imagestr = os.path.join(out_dir, "imagesTr")
    labelstr = os.path.join(out_dir, "labelsTr")
    os.makedirs(imagestr, exist_ok=True)
    os.makedirs(labelstr, exist_ok=True)

    cases = sorted(c for c in os.listdir(brats_data_dir)
                   if c.startswith("BraTS")
                   and os.path.isdir(os.path.join(brats_data_dir, c)))
    for c in cases:
        for i, mod in enumerate(BRATS_MODALITIES):
            shutil.copy(
                os.path.join(brats_data_dir, c, f"{c}_{mod}{file_ending}"),
                os.path.join(imagestr, f"{c}_{i:04d}{file_ending}"))
        _remap_seg_file(
            os.path.join(brats_data_dir, c, f"{c}_seg{file_ending}"),
            os.path.join(labelstr, c + file_ending),
            brats_labels_to_nnunet)

    generate_dataset_json(
        out_dir,
        channel_names={0: "T1", 1: "T1ce", 2: "T2", 3: "Flair"},
        labels={"background": 0, "whole tumor": (1, 2, 3),
                "tumor core": (2, 3), "enhancing tumor": (3,)},
        num_training_cases=len(cases), file_ending=file_ending,
        regions_class_order=(1, 2, 3),
        license="see https://www.synapse.org/#!Synapse:syn25829067/wiki/610863",
        reference="see https://www.synapse.org/#!Synapse:syn25829067/wiki/610863",
        dataset_release="1.0")
    return out_dir


def convert_folder_with_preds_back_to_brats(input_folder: str,
                                            output_folder: str,
                                            file_ending: str = ".nii.gz") -> int:
    """Remap every prediction in a folder back to the BraTS convention
    (reference ``Dataset137_BraTS21.py:40-56``)."""
    os.makedirs(output_folder, exist_ok=True)
    n = 0
    for fn in sorted(os.listdir(input_folder)):
        if not fn.endswith(file_ending):
            continue
        _remap_seg_file(os.path.join(input_folder, fn),
                        os.path.join(output_folder, fn),
                        convert_labels_back_to_brats)
        n += 1
    return n


# ---------------------------------------------------------------------------
# Dataset218/219 AMOS 2022 — dataset.json-driven, CT filtering for task 1
# ---------------------------------------------------------------------------

def _amos_identifiers(entries: Sequence[Dict], key: str = "image") -> List[str]:
    return [e[key].split("/")[-1][:-7] for e in entries]  # strip .nii.gz


def convert_amos(amos_base_dir: str, task: int, dataset_id: Optional[int] = None,
                 raw_root: Optional[str] = None) -> str:
    """AMOS 2022 post-challenge (reference ``Dataset218_Amos2022_task1.py`` /
    ``Dataset219_Amos2022_task2.py``): cases come from the source
    dataset.json's training/validation/test lists; the validation images are
    folded into training (5-fold CV beats a fixed split). Task 1 keeps only
    the CT acquisitions (ids ≤410 train / ≤500 test / ≤409 val); task 2 keeps
    everything (CT+MR)."""
    if task not in (1, 2):
        raise ValueError(f"AMOS task {task}: use 1 (CT) or 2 (CT and MR)")
    dataset_id = dataset_id if dataset_id is not None else (218 if task == 1 else 219)
    task_name = f"AMOS2022_postChallenge_task{task}"
    out_dir = os.path.join(_raw_root(raw_root),
                           f"Dataset{int(dataset_id):03d}_{task_name}")
    imagestr = os.path.join(out_dir, "imagesTr")
    imagests = os.path.join(out_dir, "imagesTs")
    labelstr = os.path.join(out_dir, "labelsTr")
    for d in (imagestr, imagests, labelstr):
        os.makedirs(d, exist_ok=True)

    src_json = json.load(open(os.path.join(amos_base_dir, "dataset.json")))

    def _num(ident: str) -> int:
        return int(ident.split("_")[-1])

    n_train = 0
    for tr in _amos_identifiers(src_json["training"]):
        if task == 1 and _num(tr) > 410:  # CT-only cutoff (reference :30)
            continue
        shutil.copy(os.path.join(amos_base_dir, "imagesTr", tr + ".nii.gz"),
                    os.path.join(imagestr, f"{tr}_0000.nii.gz"))
        shutil.copy(os.path.join(amos_base_dir, "labelsTr", tr + ".nii.gz"),
                    os.path.join(labelstr, f"{tr}.nii.gz"))
        n_train += 1
    for ts in _amos_identifiers(src_json["test"]):
        if task == 1 and _num(ts) > 500:  # reference :37
            continue
        shutil.copy(os.path.join(amos_base_dir, "imagesTs", ts + ".nii.gz"),
                    os.path.join(imagests, f"{ts}_0000.nii.gz"))
    for vl in _amos_identifiers(src_json.get("validation", [])):
        if task == 1 and _num(vl) > 409:  # reference :42
            continue
        shutil.copy(os.path.join(amos_base_dir, "imagesVa", vl + ".nii.gz"),
                    os.path.join(imagestr, f"{vl}_0000.nii.gz"))
        shutil.copy(os.path.join(amos_base_dir, "labelsVa", vl + ".nii.gz"),
                    os.path.join(labelstr, f"{vl}.nii.gz"))
        n_train += 1

    generate_dataset_json(
        out_dir,
        channel_names={0: "CT" if task == 1 else "either_CT_or_MR"},
        labels={v: int(k) for k, v in src_json["labels"].items()},
        num_training_cases=n_train, file_ending=".nii.gz",
        dataset_name=task_name,
        reference="https://amos22.grand-challenge.org/",
        release="https://zenodo.org/record/7262581",
        overwrite_image_reader_writer="NibabelIOWithReorient",
        description="AMOS post-challenge release; validation cases folded "
                    "into training (5-fold CV beats a fixed split).")
    return out_dir


# ---------------------------------------------------------------------------
# Dataset220 KiTS2023 — regions (kidney ⊃ masses ⊃ tumor)
# ---------------------------------------------------------------------------

def convert_kits2023(kits_base_dir: str, dataset_id: int = 220,
                     raw_root: Optional[str] = None) -> str:
    """KiTS 2023 (reference ``Dataset220_KiTS2023.py:7-36``): ``case_XXXXX``
    dirs with imaging/segmentation; region-based labels kidney=(1,2,3),
    masses=(2,3), tumor=2, painted in order (1, 3, 2)."""
    task_name = "KiTS2023"
    out_dir = os.path.join(_raw_root(raw_root),
                           f"Dataset{int(dataset_id):03d}_{task_name}")
    imagestr = os.path.join(out_dir, "imagesTr")
    labelstr = os.path.join(out_dir, "labelsTr")
    os.makedirs(imagestr, exist_ok=True)
    os.makedirs(labelstr, exist_ok=True)
    cases = sorted(c for c in os.listdir(kits_base_dir)
                   if c.startswith("case_")
                   and os.path.isdir(os.path.join(kits_base_dir, c)))
    for c in cases:
        shutil.copy(os.path.join(kits_base_dir, c, "imaging.nii.gz"),
                    os.path.join(imagestr, f"{c}_0000.nii.gz"))
        shutil.copy(os.path.join(kits_base_dir, c, "segmentation.nii.gz"),
                    os.path.join(labelstr, f"{c}.nii.gz"))
    generate_dataset_json(
        out_dir, channel_names={0: "CT"},
        labels={"background": 0, "kidney": (1, 2, 3), "masses": (2, 3),
                "tumor": 2},
        regions_class_order=(1, 3, 2),
        num_training_cases=len(cases), file_ending=".nii.gz",
        dataset_name=task_name, reference="none", release="prerelease",
        overwrite_image_reader_writer="NibabelIOWithReorient",
        description="KiTS2023")
    return out_dir


# ---------------------------------------------------------------------------
# Dataset221 AutoPET-II — two channels + patient-stratified splits
# ---------------------------------------------------------------------------

def convert_autopet(autopet_base_dir: str, dataset_id: int = 221,
                    raw_root: Optional[str] = None,
                    preprocessed_root: Optional[str] = None) -> str:
    """AutoPET-II (reference ``Dataset221_AutoPETII_2023.py:7-59``):
    ``PETCT_<patient>/<acquisition>/{CTres,SUV,SEG}.nii.gz`` → channels
    0000/0001 + label per acquisition; 5-fold splits stratified by PATIENT
    (``patients[fold::5]``) so no patient straddles train and val."""
    task_name = "AutoPETII_2023"
    foldername = f"Dataset{int(dataset_id):03d}_{task_name}"
    out_dir = os.path.join(_raw_root(raw_root), foldername)
    imagestr = os.path.join(out_dir, "imagesTr")
    labelstr = os.path.join(out_dir, "labelsTr")
    os.makedirs(imagestr, exist_ok=True)
    os.makedirs(labelstr, exist_ok=True)

    patients = sorted(p for p in os.listdir(autopet_base_dir)
                      if p.startswith("PETCT")
                      and os.path.isdir(os.path.join(autopet_base_dir, p)))
    identifiers = []
    for pat in patients:
        for acq in sorted(os.listdir(os.path.join(autopet_base_dir, pat))):
            adir = os.path.join(autopet_base_dir, pat, acq)
            if not os.path.isdir(adir):
                continue
            ident = f"{pat}_{acq}"
            identifiers.append(ident)
            shutil.copy(os.path.join(adir, "CTres.nii.gz"),
                        os.path.join(imagestr, f"{ident}_0000.nii.gz"))
            shutil.copy(os.path.join(adir, "SUV.nii.gz"),
                        os.path.join(imagestr, f"{ident}_0001.nii.gz"))
            shutil.copy(os.path.join(adir, "SEG.nii.gz"),
                        os.path.join(labelstr, f"{ident}.nii.gz"))

    generate_dataset_json(out_dir, channel_names={0: "CT", 1: "CT"},
                          labels={"background": 0, "tumor": 1},
                          num_training_cases=len(identifiers),
                          file_ending=".nii.gz", dataset_name=task_name,
                          reference="https://autopet-ii.grand-challenge.org/",
                          release="release", description=task_name)

    splits = []
    for fold in range(5):
        val_patients = patients[fold::5]
        splits.append({
            "train": [i for i in identifiers
                      if not any(i.startswith(v) for v in val_patients)],
            "val": [i for i in identifiers
                    if any(i.startswith(v) for v in val_patients)],
        })
    if preprocessed_root:
        pp_dir = os.path.join(preprocessed_root, foldername)
        os.makedirs(pp_dir, exist_ok=True)
        with open(os.path.join(pp_dir, "splits_final.json"), "w") as f:
            json.dump(splits, f, indent=2)
    return out_dir


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m ldiffusion_tpu_torch.data.public_converters",
        description="Public-dataset converters (reference DatasetXXX_*.py).")
    sub = p.add_subparsers(dest="cmd", required=True)

    def _common(sp, default_id):
        sp.add_argument("-i", "--input_folder", required=True)
        sp.add_argument("-d", "--dataset_id", type=int, default=default_id)
        sp.add_argument("--raw_root", default=None)

    _common(sub.add_parser("acdc"), 27)
    em = sub.add_parser("emidec")
    _common(em, 115)
    em.add_argument("-t", "--test_dir", required=True)
    mn = sub.add_parser("mnms")
    _common(mn, 114)
    mn.add_argument("-c", "--csv_file_name", required=True)
    mn.add_argument("-s", "--custom_splits_file", default=None,
                    help="append vendor splits to this splits_final.json "
                         "instead of converting")
    mn.add_argument("--num_val_patients", type=int, default=25,
                    help="held-out patients per vendor for the custom splits")
    fl = sub.add_parser("fluo_c3dh")
    _common(fl, 73)
    fl.add_argument("-t", "--test_dir", default=None)
    fl.add_argument("--preprocessed_root", default=None)
    _common(sub.add_parser("road"), 120)
    _common(sub.add_parser("brats21"), 137)
    bb = sub.add_parser("brats21_convert_back")
    bb.add_argument("-i", "--input_folder", required=True)
    bb.add_argument("-o", "--output_folder", required=True)
    a1 = sub.add_parser("amos_task1")
    _common(a1, 218)
    a2 = sub.add_parser("amos_task2")
    _common(a2, 219)
    _common(sub.add_parser("kits2023"), 220)
    ap = sub.add_parser("autopet")
    _common(ap, 221)
    ap.add_argument("--preprocessed_root", default=None)
    fd = sub.add_parser("filelist_dataset",
                        help="Dataset988-style no-copy dataset")
    fd.add_argument("-i", "--input_folder", required=True,
                    help="source dataset dir")
    fd.add_argument("-o", "--output_folder", required=True)

    a = p.parse_args(argv)
    if a.cmd == "acdc":
        out = convert_acdc(a.input_folder, a.dataset_id, a.raw_root)
    elif a.cmd == "emidec":
        out = convert_emidec(a.input_folder, a.test_dir, a.dataset_id,
                             a.raw_root)
    elif a.cmd == "mnms":
        if a.custom_splits_file:
            create_mnms_custom_splits(a.input_folder, a.csv_file_name,
                                      a.custom_splits_file,
                                      num_val_patients=a.num_val_patients)
            out = a.custom_splits_file
        else:
            out = convert_mnms(a.input_folder, a.csv_file_name, a.dataset_id,
                               a.raw_root)
    elif a.cmd == "fluo_c3dh":
        out = convert_fluo_c3dh_a549_sim(a.input_folder, a.test_dir,
                                         a.dataset_id, a.raw_root,
                                         a.preprocessed_root)
    elif a.cmd == "road":
        out = convert_road_segmentation(a.input_folder, a.dataset_id,
                                        a.raw_root)
    elif a.cmd == "brats21":
        out = convert_brats21(a.input_folder, a.dataset_id, a.raw_root)
    elif a.cmd == "brats21_convert_back":
        n = convert_folder_with_preds_back_to_brats(a.input_folder,
                                                    a.output_folder)
        out = f"{a.output_folder} ({n} files)"
    elif a.cmd == "amos_task1":
        out = convert_amos(a.input_folder, 1, a.dataset_id, a.raw_root)
    elif a.cmd == "amos_task2":
        out = convert_amos(a.input_folder, 2, a.dataset_id, a.raw_root)
    elif a.cmd == "kits2023":
        out = convert_kits2023(a.input_folder, a.dataset_id, a.raw_root)
    elif a.cmd == "autopet":
        out = convert_autopet(a.input_folder, a.dataset_id, a.raw_root,
                              a.preprocessed_root)
    elif a.cmd == "filelist_dataset":
        from ldiffusion_tpu_torch.data.converters import create_filelist_dataset

        create_filelist_dataset(a.input_folder, a.output_folder)
        out = a.output_folder
    print(f"done: {out}")


if __name__ == "__main__":
    main()
