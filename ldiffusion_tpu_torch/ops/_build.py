"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. The build
runs at first use into ``ldiffusion_tpu_torch/_build/`` (listed in
``.gitignore``); the library's file name carries a hash of its source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt
and a stale library is never loaded. ``build()`` starts one ``nvcc`` per
source, all at once.

A ``ctypes`` call has no autograd: its output has no ``grad_fn``. So every
kernel wrapper calls ``refuse_grad`` before it launches, and a caller that
needs gradients goes through the ``torch.autograd.Function`` of its op.

Nothing here runs when the package is imported: the CPU tests import every
module on a host that has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_fwd_wgmma", "flash_bwd_wgmma", "flash_attention", "flash_attention_bwd",
           "groupnorm", "groupnorm_sm90")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA kernels "
                           "are built from ldiffusion_tpu_torch/csrc at first use")
    return found


def library_path(name: str) -> Path:
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = SOURCES) -> None:
    """Compile every named source whose library is missing, in parallel.
    The compiler's register/shared-memory report lands in ``_build/<name>.log``."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def needs_grad(*tensors) -> bool:
    """Whether autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise where a kernel's output would silently drop the gradient."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{what}: a kernel output carries no gradient; differentiate "
                           "through the op's autograd Function (dot_product_attention, "
                           "groupnorm_silu_trainable) or call it under torch.no_grad()")
