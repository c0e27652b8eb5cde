"""Dataset file lists (the port's copy of ``ldiffusion_tpu/data/io.py:309-363``;
reference ``utilities/utils.py:51-66``): channel files ``<case>_NNNN<ending>``
grouped per case, and the training split's images and labels, from the
``"dataset"`` dict of dataset.json when it has one (relative paths against
the dataset directory), else from imagesTr/labelsTr. The readers of
volumetric formats wait (ROADMAP queue 1, *The 3D / cascade pathway*)."""
from __future__ import annotations

import json
import os
from typing import Dict, Optional


def group_channel_files(img_dir: str, ending: str) -> Dict[str, list]:
    """case id → its file names; a name without a 4-digit channel suffix is
    a case of its own."""
    groups: Dict[str, list] = {}
    for fn in sorted(os.listdir(img_dir)):
        if not fn.lower().endswith(ending):
            continue
        stem = fn[: -len(ending)]
        case, _, ch = stem.rpartition("_")
        key = case if (case and ch.isdigit() and len(ch) == 4) else stem
        groups.setdefault(key, []).append(fn)
    return groups


def get_train_images_and_targets(ds_dir: str,
                                 dataset_json: Optional[Dict] = None) -> Dict[str, Dict]:
    """case id → {"images": [absolute paths], "label": absolute path}."""
    if dataset_json is None:
        with open(os.path.join(ds_dir, "dataset.json")) as f:
            dataset_json = json.load(f)

    def resolve(p):
        return p if os.path.isabs(p) else os.path.abspath(os.path.join(ds_dir, p))

    if "dataset" in dataset_json:
        return {case: {"images": [resolve(i) for i in entry["images"]],
                       "label": resolve(entry["label"])}
                for case, entry in dataset_json["dataset"].items()}
    ending = dataset_json.get("file_ending", ".png").lower()
    img_dir = os.path.join(ds_dir, "imagesTr")
    lbl_dir = os.path.join(ds_dir, "labelsTr")
    groups = group_channel_files(img_dir, ending) if os.path.isdir(img_dir) else {}
    return {case: {"images": [os.path.join(img_dir, f) for f in files],
                   "label": os.path.join(lbl_dir, case + ending)}
            for case, files in groups.items()}
