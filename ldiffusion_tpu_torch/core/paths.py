"""Environment-variable paths (counterpart of ``ldiffusion_tpu/core/paths.py``;
reference ``paths.py:21-39``, ``configuration.py:1-11``).

``LDIFFUSION_RAW`` / ``LDIFFUSION_PREPROCESSED`` / ``LDIFFUSION_RESULTS``,
with the ``nnUNet_*`` names as fallbacks and a warning when unset, and the
process-count knobs (``default_num_processes``, ``num_processes_da``; the
port's host side reads them nowhere yet, as it runs one prefetch thread).
The JAX package's compile-cache switch has no counterpart here.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional


def _env(*names: str, default: Optional[str] = None) -> Optional[str]:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return default


def raw_dir(warn: bool = True) -> Optional[str]:
    v = _env("LDIFFUSION_RAW", "nnUNet_raw")
    if v is None and warn:
        warnings.warn("LDIFFUSION_RAW is not set; dataset materialization will "
                      "default to <work_dir>/seg_raw")
    return v


def preprocessed_dir(warn: bool = True) -> Optional[str]:
    v = _env("LDIFFUSION_PREPROCESSED", "nnUNet_preprocessed")
    if v is None and warn:
        warnings.warn("LDIFFUSION_PREPROCESSED is not set; preprocessed cases "
                      "stay in memory / under <work_dir>")
    return v


def results_dir(warn: bool = True) -> Optional[str]:
    v = _env("LDIFFUSION_RESULTS", "nnUNet_results")
    if v is None and warn:
        warnings.warn("LDIFFUSION_RESULTS is not set; checkpoints default to "
                      "<work_dir>/segmentor")
    return v


def default_num_processes() -> int:
    """``LDIFFUSION_N_PROC`` (or ``nnUNet_def_n_proc``), default 8 (reference
    ``configuration.py:5``)."""
    return int(_env("LDIFFUSION_N_PROC", "nnUNet_def_n_proc", default="8"))


def num_processes_da() -> int:
    """``LDIFFUSION_N_PROC_DA`` (or ``nnUNet_n_proc_DA``), default 2
    (reference ``utilities/default_n_proc_DA.py``): the host prefetch's
    workers; augmentation runs on the device."""
    return int(_env("LDIFFUSION_N_PROC_DA", "nnUNet_n_proc_DA", default="2"))
