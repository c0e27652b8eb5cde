"""Dataset converters: other layouts → the raw-dataset layout
(``imagesTr/labelsTr[/imagesTs/labelsTs]`` + ``dataset.json``) (counterpart
of ``ldiffusion_tpu/data/converters.py``; reference nnU-Net's
``dataset_conversion/``):

* ``generate_dataset_json`` — the public dataset.json writer;
* ``create_filelist_dataset`` — a dataset.json pointing at another
  dataset's files (no copies, Dataset988);
* ``convert_folder_dataset`` / ``convert_puma`` — an images dir + a labels
  dir (PUMA: 1024² ROIs with pixel-convention masks) → ``case_XXX``;
* ``convert_msd_dataset`` — a Medical Segmentation Decathlon task folder;
* ``generate_integration_test_dataset`` — a synthetic dataset in the four
  label regimes (plain / ignore / regions / regions + ignore, Dataset996-999).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np

from ldiffusion_tpu_torch.data.labels import NUM_CLASSES, label_lut


def generate_dataset_json(output_folder: str,
                          channel_names: Dict,
                          labels: Dict,
                          num_training_cases: int,
                          file_ending: str,
                          regions_class_order=None,
                          dataset_name: Optional[str] = None,
                          reference: Optional[str] = None,
                          release: Optional[str] = None,
                          license: Optional[str] = None,
                          description: Optional[str] = None,
                          overwrite_image_reader_writer: Optional[str] = None,
                          **kwargs) -> Dict:
    """Write ``dataset.json`` (reference ``generate_dataset_json.py:6-103``):
    channel keys as strings, label values as ints or int lists, regions need
    ``regions_class_order``, the provenance fields when given (the
    reference's ``licence`` spelling), extra keys verbatim."""
    has_regions = any(isinstance(v, (tuple, list)) and len(v) > 1 for v in labels.values())
    if has_regions and regions_class_order is None:
        raise ValueError("labels define regions but regions_class_order is not set — region "
                         "painting order is required")
    dataset_json = {
        "channel_names": {str(k): v for k, v in channel_names.items()},
        "labels": {name: [int(i) for i in value] if isinstance(value, (tuple, list))
                   else int(value) for name, value in labels.items()},
        "numTraining": int(num_training_cases),
        "file_ending": file_ending,
    }
    for key, value in (("name", dataset_name), ("reference", reference),
                       ("release", release), ("licence", license),
                       ("description", description),
                       ("overwrite_image_reader_writer", overwrite_image_reader_writer)):
        if value is not None:
            dataset_json[key] = value
    if regions_class_order is not None:
        dataset_json["regions_class_order"] = [int(i) for i in regions_class_order]
    dataset_json.update(kwargs)
    os.makedirs(output_folder, exist_ok=True)
    with open(os.path.join(output_folder, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=4)
    return dataset_json


def create_filelist_dataset(source_dataset_dir: str, target_dataset_dir: str) -> Dict:
    """A dataset.json whose ``"dataset"`` entry points at the source
    dataset's files by paths relative to the new directory (reference
    ``Dataset988_dummyDataset4.py``; read by ``data/io.py:
    get_train_images_and_targets``). Nothing is copied."""
    from ldiffusion_tpu_torch.data.io import get_train_images_and_targets

    dataset = get_train_images_and_targets(source_dataset_dir)
    os.makedirs(target_dataset_dir, exist_ok=True)
    rel = {case: {"images": [os.path.relpath(p, target_dataset_dir) for p in entry["images"]],
                  "label": os.path.relpath(entry["label"], target_dataset_dir)}
           for case, entry in dataset.items()}
    with open(os.path.join(source_dataset_dir, "dataset.json")) as f:
        dataset_json = json.load(f)
    dataset_json["dataset"] = rel
    with open(os.path.join(target_dataset_dir, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=4)
    return dataset_json


def _write_dataset_json(path: str, num_training: int, num_classes: int,
                        file_ending: str = ".png"):
    dataset_json = {
        "channel_names": {"0": "R", "1": "G", "2": "B"},
        "labels": {"background": 0, **{f"class{i}": i for i in range(1, num_classes)}},
        "numTraining": num_training,
        "file_ending": file_ending,
    }
    with open(os.path.join(path, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=4)


def convert_folder_dataset(image_dir: str, label_dir: str, out_dir: str,
                           num_classes: int, level: Optional[str] = None,
                           train_ratio: float = 1.0) -> str:
    """Images and labels paired in sorted order, labels optionally mapped
    from the PUMA pixel convention, cases renamed ``case_XXX_0000.png``; the
    first ``train_ratio`` go to imagesTr, the rest to imagesTs."""
    from PIL import Image

    images = sorted(os.listdir(image_dir))
    labels = sorted(os.listdir(label_dir))
    if len(images) != len(labels):
        raise ValueError(f"{len(images)} images but {len(labels)} labels")
    n_train = int(round(len(images) * train_ratio))
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    lut = label_lut(level) if level else None
    for idx, (imf, lbf) in enumerate(zip(images, labels)):
        train = idx < n_train
        prefix, img_sub, lbl_sub = (("case", "imagesTr", "labelsTr") if train
                                    else ("caseTs", "imagesTs", "labelsTs"))
        i = idx if train else idx - n_train
        img = Image.open(os.path.join(image_dir, imf)).convert("RGB")
        img.save(os.path.join(out_dir, img_sub, f"{prefix}_{i:03d}_0000.png"))
        lbl = np.asarray(Image.open(os.path.join(label_dir, lbf)).convert("L"), np.uint8)
        if lut is not None:
            lbl = lut[lbl]
        Image.fromarray(lbl).save(os.path.join(out_dir, lbl_sub, f"{prefix}_{i:03d}.png"))
    _write_dataset_json(out_dir, n_train, num_classes)
    return out_dir


def convert_puma(image_dir: str, label_dir: str, out_dir: str, level: str = "tissue",
                 train_ratio: float = 0.7) -> str:
    """PUMA melanoma ROIs: images + pixel-convention masks (reference
    ``README.md:40-41,92``; the mapping ``dataset.py:10-32``)."""
    return convert_folder_dataset(image_dir, label_dir, out_dir, NUM_CLASSES[level], level,
                                  train_ratio)


def convert_msd_dataset(msd_dir: str, out_dir: str) -> str:
    """A Medical Segmentation Decathlon task folder (reference
    ``convert_MSD_dataset.py``): the volumes copied as they are, the MSD
    dataset.json translated (``modality`` → ``channel_names``, id → name
    labels → name → id, ``.nii.gz``)."""
    with open(os.path.join(msd_dir, "dataset.json")) as f:
        src_json = json.load(f)
    for sub in ("imagesTr", "labelsTr", "imagesTs"):
        src = os.path.join(msd_dir, sub)
        dst = os.path.join(out_dir, sub)
        os.makedirs(dst, exist_ok=True)
        if os.path.isdir(src):
            for fn in os.listdir(src):
                if not fn.startswith("."):
                    shutil.copy(os.path.join(src, fn), os.path.join(dst, fn))
    name_to_id = {str(v): int(k) for k, v in src_json.get("labels", {}).items()}
    with open(os.path.join(out_dir, "dataset.json"), "w") as f:
        json.dump({
            "channel_names": {str(i): m for i, m in
                              enumerate(src_json.get("modality", {"0": "img"}).values())},
            "labels": name_to_id or {"background": 0},
            "numTraining": src_json.get("numTraining", 0),
            "file_ending": ".nii.gz",
        }, f, indent=4)
    return out_dir


def generate_integration_test_dataset(out_dir: str, n_cases: int = 6, size: int = 64,
                                      num_classes: int = 4, seed: int = 0,
                                      regime: str = "plain") -> str:
    """A synthetic PNG dataset in one of the four label regimes ("plain",
    "ignore", "regions", "regions_ignore"; reference
    ``datasets_for_integration_tests/``): random images, a disc of each
    class, the ignore label (= ``num_classes``) on the first two rows."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    n_train = max(1, int(n_cases * 0.7))
    for idx in range(n_cases):
        img = (rng.random((size, size, 3)) * 255).astype(np.uint8)
        lab = np.zeros((size, size), np.uint8)
        for c in range(1, num_classes):
            cy, cx = rng.integers(8, size - 8, 2)
            yy, xx = np.mgrid[:size, :size]
            lab[(yy - cy) ** 2 + (xx - cx) ** 2 < 36] = c
        if regime in ("ignore", "regions_ignore"):
            lab[:2] = num_classes
        train = idx < n_train
        prefix, img_sub, lbl_sub = (("case", "imagesTr", "labelsTr") if train
                                    else ("caseTs", "imagesTs", "labelsTs"))
        i = idx if train else idx - n_train
        Image.fromarray(img).save(os.path.join(out_dir, img_sub, f"{prefix}_{i:03d}_0000.png"))
        Image.fromarray(lab).save(os.path.join(out_dir, lbl_sub, f"{prefix}_{i:03d}.png"))
    labels: Dict = {"background": 0, **{f"class{i}": i for i in range(1, num_classes)}}
    if regime in ("regions", "regions_ignore"):
        labels = {"background": 0, "whole": list(range(1, num_classes)),
                  "core": [num_classes - 1]}
    if regime in ("ignore", "regions_ignore"):
        labels["ignore"] = num_classes
    dataset_json = {"channel_names": {"0": "R", "1": "G", "2": "B"}, "labels": labels,
                    "numTraining": n_train, "file_ending": ".png"}
    if regime in ("regions", "regions_ignore"):
        dataset_json["regions_class_order"] = list(range(1, num_classes))
    with open(os.path.join(out_dir, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=4)
    return out_dir
