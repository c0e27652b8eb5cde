"""Trained segmentor models as zip archives (counterpart of
``ldiffusion_tpu/segmentor/model_sharing.py``; reference nnU-Net's
``model_sharing/``): ``export_model`` bundles plans, checkpoints and the
files the trainer writes beside them, ``import_model`` extracts a bundle,
``download_and_install_from_url`` fetches one (``file://`` URLs too) and
installs it.

A folder with its checkpoints at the top (plans.json beside them) exports
the same names as in the JAX package. A results folder of the command line
(``<trainer>__<plans>__<config>``: plans.json and dataset.json at the top,
the checkpoints in ``fold_*``), which the JAX package refuses for want of a
checkpoint at the top, exports its dataset.json and each fold's files
under ``fold_N/``, as nnU-Net's export does, so ``predict_from_modelfolder``
runs on the installed folder."""
from __future__ import annotations

import os
import time
import zipfile
from typing import List, Optional, Sequence

EXPORT_FILES = ("plans.json", "checkpoint_best.pkl", "checkpoint_final.pkl",
                "checkpoint_latest.pkl", "postprocessing.json", "debug.json",
                "progress.png", "training_log.txt")


def _present(model_dir: str, names: Sequence[str], prefix: str = "") -> List[str]:
    return [os.path.join(prefix, f) if prefix else f for f in names
            if os.path.exists(os.path.join(model_dir, prefix, f))]


def export_model(model_dir: str, zip_path: str,
                 extra_files: Optional[Sequence[str]] = None) -> str:
    # AssertionError, as the JAX package raises, for a folder without plans or
    # checkpoints (explicit, so ``python -O`` keeps the checks)
    files = _present(model_dir, EXPORT_FILES)
    if "plans.json" not in files:
        raise AssertionError(f"{model_dir} has no plans.json")
    if not any(f.startswith("checkpoint") for f in files):  # a results folder's folds
        folds = sorted(d for d in os.listdir(model_dir)
                       if d.startswith("fold_") and os.path.isdir(os.path.join(model_dir, d)))
        files += _present(model_dir, ("dataset.json",))
        for d in folds:
            files += _present(model_dir, EXPORT_FILES[1:], prefix=d)
    if not any(os.path.basename(f).startswith("checkpoint") for f in files):
        raise AssertionError("no checkpoint to export")
    os.makedirs(os.path.dirname(zip_path) or ".", exist_ok=True)
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for f in files + list(extra_files or []):
            z.write(os.path.join(model_dir, f), arcname=f)
    return zip_path


def import_model(zip_path: str, target_dir: str) -> str:
    os.makedirs(target_dir, exist_ok=True)
    with zipfile.ZipFile(zip_path) as z:
        if "plans.json" not in z.namelist():
            raise AssertionError("not a valid exported model (no plans.json)")
        z.extractall(target_dir)
    return target_dir


def download_file(url: str, local_filename: str, chunk_size: int = 8192 * 16) -> str:
    """Stream a URL to a local file (reference ``model_download.py:37-46``,
    urllib in place of requests)."""
    from urllib.request import urlopen

    with urlopen(url, timeout=100) as r, open(local_filename, "wb") as f:
        while True:
            chunk = r.read(chunk_size)
            if not chunk:
                break
            f.write(chunk)
    return local_filename


def download_and_install_from_url(url: str, target_dir: str) -> str:
    """Download a model zip to a temporary file in ``$HOME`` and install it;
    the temporary file is removed whatever happens, and a failed fetch or a
    bad zip raises (reference ``model_download.py:11-34``)."""
    tempfile_path = os.path.join(os.path.expanduser("~"),
                                 f".lddownload_{int(time.time() * 1e7)}")
    try:
        download_file(url, tempfile_path)
        return import_model(tempfile_path, target_dir)
    finally:
        if os.path.isfile(tempfile_path):
            os.remove(tempfile_path)
