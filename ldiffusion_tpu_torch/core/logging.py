"""Logging (counterpart of ``CSVLogger``, ``TextLogger``, ``EpochLogger``,
``dump_debug_json`` and ``profiler_trace`` in ``ldiffusion_tpu/core/logging.py``).
Under a process group (``core/dist.py``) files, CSV logs and printed lines
come from rank 0 only, as in the JAX package (``is_main_process``); in one
process every call writes."""
from __future__ import annotations

import contextlib
import csv
import json
import os
import time
from typing import Dict, List, Optional

from ldiffusion_tpu_torch.core.dist import is_main_process, process_count  # noqa: F401


class CSVLogger:
    """epoch,loss CSV identical in shape to the reference's contrast_loss.csv."""

    def __init__(self, path: str, header=("epoch", "loss")):
        self.path = path
        if is_main_process():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(list(header))

    def append(self, *row):
        if is_main_process():
            with open(self.path, "a", newline="") as f:
                csv.writer(f).writerow(list(row))


class TextLogger:
    """Timestamped text log file + stdout (rank 0 only)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path and is_main_process():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, *msg, also_print: bool = True):
        if not is_main_process():
            return
        line = " ".join(str(m) for m in msg)
        if also_print:
            print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')}: {line}\n")


class EpochLogger:
    """dict-of-lists per-epoch metrics with the EMA pseudo-dice (β = 0.9) and a
    ``progress.png`` renderer (``ldiffusion_tpu/core/logging.py:62-124``,
    reference ``nnunet_logger.py:9-103``)."""

    def __init__(self, ema_beta: float = 0.9):
        self.ema_beta = ema_beta
        self.data: Dict[str, List[float]] = {}

    def log(self, key: str, value: float, epoch: int):
        series = self.data.setdefault(key, [])
        while len(series) <= epoch:
            series.append(float("nan"))
        series[epoch] = float(value)
        if key == "mean_fg_dice":
            ema = self.data.setdefault("ema_fg_dice", [])
            prev = ema[epoch - 1] if epoch > 0 and len(ema) >= epoch else value
            while len(ema) <= epoch:
                ema.append(float("nan"))
            ema[epoch] = self.ema_beta * prev + (1 - self.ema_beta) * float(value)

    def get(self, key: str, epoch: int = -1) -> float:
        return self.data.get(key, [float("nan")])[epoch]

    def state_dict(self) -> dict:
        return {"data": self.data, "ema_beta": self.ema_beta}

    def load_state_dict(self, sd: dict):
        self.data = {k: list(v) for k, v in sd["data"].items()}
        self.ema_beta = sd.get("ema_beta", 0.9)

    def plot_progress(self, out_path: str):
        """Loss/dice, epoch-time and lr panels; a no-op without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        fig, axes = plt.subplots(3, 1, figsize=(10, 12))
        ax = axes[0]
        for key in ("train_loss", "val_loss"):
            if key in self.data:
                ax.plot(self.data[key], label=key)
        ax2 = ax.twinx()
        for key, style in (("mean_fg_dice", ":"), ("ema_fg_dice", "-")):
            if key in self.data:
                ax2.plot(self.data[key], style, color="g", label=key)
        ax.legend(loc="upper left")
        ax.set_xlabel("epoch")
        if "epoch_time" in self.data:
            axes[1].plot(self.data["epoch_time"])
            axes[1].set_ylabel("epoch time (s)")
        if "lr" in self.data:
            axes[2].plot(self.data["lr"])
            axes[2].set_ylabel("lr")
        fig.tight_layout()
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path)
        plt.close(fig)


def dump_debug_json(path: str, extra: Optional[dict] = None):
    """Environment dump in the spirit of nnU-Net's debug.json
    (``ldiffusion_tpu/core/logging.py:126``), with torch's device fields."""
    import torch

    cuda = torch.cuda.is_available()
    info = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "process_count": process_count(),
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else [],
    }
    if extra:
        info.update(extra)
    if is_main_process():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(info, f, indent=2, default=str)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block (host, and the card when there
    is one) written to ``log_dir`` as a Chrome trace
    (``trace_<pid>_<ms>.json``), and beside it the port's spans and counters
    of the block (``core/tracing.py``, cleared on entry): ``spans_<pid>_<ms>.json``
    holding ``summary`` and the raw ``spans``. Nothing when ``log_dir`` is
    empty or None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ldiffusion_tpu_torch.core import tracing

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    tracing.reset()
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    stamp = f"{os.getpid()}_{int(time.time() * 1000)}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
        json.dump({"summary": tracing.summary(), "spans": tracing.records()}, f)
