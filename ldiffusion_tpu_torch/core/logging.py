"""Logging (counterpart of ``CSVLogger`` and ``TextLogger`` in
``ldiffusion_tpu/core/logging.py``). The port runs in one process, so every
call writes; the JAX package's rank-0 checks wait for distribution (ROADMAP
queue 1 item 12)."""
from __future__ import annotations

import csv
import os
import time
from typing import Optional


class CSVLogger:
    """epoch,loss CSV identical in shape to the reference's contrast_loss.csv."""

    def __init__(self, path: str, header=("epoch", "loss")):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", newline="") as f:
            csv.writer(f).writerow(list(header))

    def append(self, *row):
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(list(row))


class TextLogger:
    """Timestamped text log file + stdout."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def __call__(self, *msg, also_print: bool = True):
        line = " ".join(str(m) for m in msg)
        if also_print:
            print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')}: {line}\n")
