"""The harness's parts that know no cell: where things are, finding a cell's
files by name, the run's settings, the cache directories, the benchmark's
spans, and the check that neither JAX nor the JAX package was loaded.

A cell ``<cell>`` is ``workloads/<cell>.json`` (its configuration's name,
chips, driver, traffic parameters, why, and the limits of its correctness
numbers); its configuration is ``configs/<config>.json``; its driver is
``drivers/<driver>.py`` (``setup``, ``window``, ``check``); each metric
``<metric>`` is read by ``metrics/<metric>.py`` (``read(ctx)``); the frozen
counts of a cell are ``reference/counts/<cell>.json``. Nothing here names a
cell, a configuration or a metric.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
import time

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)  # the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "ldiffusion_tpu")


def set_cache_dirs() -> None:
    """Every build and kernel cache in fixed directories of the checkout, so
    that only a checkout's first run builds; set before torch is imported."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
    os.environ["USE_FLAX"] = "0"


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from its file (metric files' names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(name: str, pkg: str = PKG):
    """(cell, configuration, driver module) of the cell ``name``."""
    cell = load_json(pkg, "workloads", f"{name}.json")
    if cell["name"] != name:
        raise ValueError(f"workloads/{name}.json names the cell {cell['name']!r}")
    cfg = load_json(pkg, "configs", f"{cell['config']}.json")
    return cell, cfg, driver(cell["driver"], pkg)


def driver(name: str, pkg: str = PKG):
    return load_module(os.path.join(pkg, "drivers", f"{name}.py"), f"portbench_driver_{name}")


def reader(metric: str, pkg: str = PKG):
    return load_module(os.path.join(pkg, "metrics", f"{metric}.py"),
                       "portbench_metric_" + metric.replace(".", "_"))


def counts(cell: str, pkg: str = PKG) -> dict:
    path = os.path.join(pkg, "reference", "counts", f"{cell}.json")
    return load_json(path) if os.path.exists(path) else {}


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of BENCHMARK.json that ``cell`` reports: the
    end-to-end ones without a trace, the per-layer ones with it."""
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def process_start() -> float:
    """This process's start on the host's clock (``time.time``), from
    /proc; the import time of this module where /proc says nothing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is
    JAX's, jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """One run of one cell: what a driver and a metric reader are given."""

    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object           # torch.device
    tmp: str                 # this run's scratch directory (under TMPDIR)
    window: dict = dataclasses.field(default_factory=dict)   # what the window did
    summary: dict = None     # the traced window's trace summary
    counts: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds by part
    peak_bytes: int = 0


@contextlib.contextmanager
def setup_part(run: Run, name: str):
    """Adds the time of the block, the device's work in it included, to
    ``run.setup_parts[name]``."""
    t0 = time.perf_counter()
    yield
    if run.device.type == "cuda":
        import torch

        torch.cuda.synchronize()
    run.setup_parts[name] = run.setup_parts.get(name, 0.0) + time.perf_counter() - t0


def span(name: str):
    """A benchmark span around a call into the program, read from the trace."""
    from torch.profiler import record_function

    return record_function("portbench/" + name)
