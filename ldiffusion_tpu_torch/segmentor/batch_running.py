"""Batch runs: training commands for a sweep, a local runner, and the result
collectors (counterpart of ``ldiffusion_tpu/segmentor/batch_running.py``;
reference nnU-Net's ``batch_running/``): one command per (dataset, variant,
fold), each run's log, the per-fold validation Dice of every results folder
as a CSV, its pivot by trainer, and the benchmark JSON lines merged.

The JAX package's ``launcher="gcloud"`` wraps each command in ``gcloud
compute tpus tpu-vm ssh``, which has no meaning on a GPU host: here it
raises, and commands run locally (``run_local``)."""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def generate_training_commands(
    dataset_ids: Sequence[str],
    variants: Sequence[str] = ("default",),
    folds: Sequence[int] = (0,),
    image_dir: str = "data/images",
    label_dir: str = "data/labels",
    launcher: str = "local",
) -> List[str]:
    """One ``python -m ldiffusion_tpu_torch.ldiffusion`` command per
    (dataset, variant, fold), tagged with the three (the analog of the
    reference's LSF ``bsub`` generators)."""
    if launcher != "local":
        raise ValueError(f"launcher {launcher!r}: the JAX package's 'gcloud' launcher opens "
                         "an ssh session on a TPU VM, which a GPU host does not have; use "
                         "'local' (run_local)")
    train_cmd = (f"python -m ldiffusion_tpu_torch.ldiffusion --diffusion-path $SD_PATH "
                 f"--image-dir {image_dir} --label-dir {label_dir} "
                 f"--num-epochs 100 --batch-size 8 --num-inference-steps 25 "
                 f"--num-classes 7 --component all")
    return [f"{train_cmd}  # {ds} {variant} fold{fold}"
            for ds in dataset_ids for variant in variants for fold in folds]


def run_local(commands: Sequence[str], log_dir: str, stop_on_error: bool = False,
              env: Optional[Dict[str, str]] = None) -> List[Dict]:
    """Run the commands one after the other on this host, each into its own
    ``run_NNN.log``; returns (and writes to ``runs.json``) one record per
    command: {cmd, returncode, log, seconds}."""
    os.makedirs(log_dir, exist_ok=True)
    full_env = {**os.environ, **(env or {})}
    records = []
    for i, cmd in enumerate(commands):
        log_path = os.path.join(log_dir, f"run_{i:03d}.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            log.write(f"$ {cmd}\n")
            log.flush()
            rc = subprocess.call(cmd, shell=True, stdout=log, stderr=subprocess.STDOUT,
                                 env=full_env)
        records.append({"cmd": cmd, "returncode": rc, "log": log_path,
                        "seconds": round(time.perf_counter() - t0, 3)})
        if rc != 0 and stop_on_error:
            break
    with open(os.path.join(log_dir, "runs.json"), "w") as f:
        json.dump(records, f, indent=2)
    return records


def get_output_folder(results_root: str, dataset: str, trainer: str, plans: str, config: str,
                      fold: Optional[int] = None) -> str:
    """``Dataset/trainer__plans__config[/fold_N]`` (reference
    ``file_path_utilities.py:get_output_folder``)."""
    d = os.path.join(results_root, dataset, f"{trainer}__{plans}__{config}")
    return os.path.join(d, f"fold_{fold}") if fold is not None else d


def _fold_dice(results_root, dataset, trainer, plans, config, fold) -> Optional[float]:
    summary = os.path.join(get_output_folder(results_root, dataset, trainer, plans, config,
                                             fold), "validation", "summary.json")
    if not os.path.exists(summary):
        return None
    with open(summary) as f:
        return json.load(f).get("foreground_mean", {}).get("Dice")


def collect_crossval_results(
    results_root: str,
    trainers: Dict[str, Sequence[str]],
    datasets: Sequence[str],
    output_file: str,
    configurations: Sequence[str] = ("2d", "3d_fullres", "3d_lowres", "3d_cascade_fullres"),
    folds: Sequence[int] = (0, 1, 2, 3, 4),
) -> List[List]:
    """One CSV row per existing (dataset, config, trainer, plans) results
    folder: ``dataset,config,trainer,plans,<each fold's fg-mean Dice>,nanmean``,
    blank where a fold has no summary (reference
    ``collect_results_custom_Decathlon.py:collect_results``); ``trainers``
    maps a trainer name to its plans identifiers."""
    rows = []
    with open(output_file, "w") as f:
        for ds in datasets:
            for config in configurations:
                for trainer, plans_list in trainers.items():
                    for plans in plans_list:
                        if not os.path.isdir(get_output_folder(results_root, ds, trainer, plans,
                                                               config)):
                            continue
                        dices = [_fold_dice(results_root, ds, trainer, plans, config, fl)
                                 for fl in folds]
                        cells = ["" if d is None else f"{d:02.4f}" for d in dices]
                        mean = float(np.nanmean([np.nan if d is None else d for d in dices])) \
                            if any(d is not None for d in dices) else float("nan")
                        f.write(",".join([ds, config, trainer, plans] + cells
                                         + [f"{mean:02.4f}"]) + "\n")
                        rows.append([ds, config, trainer, plans] + dices + [mean])
    return rows


def summarize_crossval(input_file: str, output_file: str, folds: Sequence[int],
                       configs: Sequence[str], datasets: Sequence[str],
                       trainers: Dict[str, Sequence[str]]) -> None:
    """Pivot the collected CSV: one row per ``trainer__plans``, one
    ``<dataset>_<config[:4]>`` column (the mean over ``folds``), and the
    row's mean (reference ``collect_results_custom_Decathlon.py:summarize``)."""
    with open(input_file) as f:
        txt = [line.rstrip("\n").split(",") for line in f if line.strip()]
    num_folds = len(txt[0]) - 5 if txt else 0
    if txt and max(folds) >= num_folds:
        raise ValueError(f"fold {max(folds)} beyond the {num_folds} collected")
    valid = {d: sorted({r[1] for r in txt if r[0] == d and r[1] in configs}) for d in datasets}
    with open(output_file, "w") as f:
        f.write("name")
        for d in datasets:
            for c in valid[d]:
                f.write(f",{d}_{c[:4]}")
        f.write(",mean\n")
        for trainer, plans_list in trainers.items():
            for plans in plans_list:
                f.write(f"{trainer}__{plans}")
                row_means = []
                for d in datasets:
                    for c in valid[d]:
                        match = [r for r in txt if r[0] == d and r[1] == c
                                 and r[2] == trainer and r[3] == plans]
                        if not match:
                            f.write(",nan")
                            row_means.append(np.nan)
                            continue
                        vals = [float(x) for x in (match[0][4 + fl] for fl in folds) if x != ""]
                        m = float(np.mean(vals)) if vals else float("nan")
                        f.write(f",{m:02.4f}")
                        row_means.append(m)
                f.write(f",{np.nanmean(row_means):02.4f}\n")


def collect_results(result_dirs: Sequence[str]) -> Dict[str, Optional[float]]:
    """Each run's foreground-mean Dice from its ``validation/summary.json``
    (None where there is none)."""
    out: Dict[str, Optional[float]] = {}
    for d in result_dirs:
        summary = os.path.join(d, "validation", "summary.json")
        if os.path.exists(summary):
            with open(summary) as f:
                out[d] = json.load(f).get("foreground_mean", {}).get("Dice")
        else:
            out[d] = None
    return out


def summarize_benchmarks(bench_jsons: Sequence[str], output: Optional[str] = None) -> Dict:
    """The JSON lines of benchmark outputs merged into one table (reference
    ``summarize_benchmark_results.py``): {n_runs, runs, best "value"}."""
    rows = []
    for p in bench_jsons:
        with open(p) as f:
            rows.extend(json.loads(line) for line in (s.strip() for s in f)
                        if line.startswith("{"))
    summary = {"n_runs": len(rows), "runs": rows,
               "best": max((r.get("value", 0) for r in rows), default=None)}
    if output:
        with open(output, "w") as f:
            json.dump(summary, f, indent=2)
    return summary
