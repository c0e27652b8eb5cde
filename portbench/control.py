"""The readings that the limits of a cell's correctness numbers are set
from, at the cell's own size, each kind in one process:

    python3 -m portbench.control --workload <cell> --seeds 11,12,... \\
        [--control-seeds 21,22,23] [--fault <name> --fault-seeds 31,32,33]

- ``--seeds``: sound runs of the program: set-up (which drives a training
  cell through its checked steps), for an inference cell one call of the
  window's, then the check.
- ``--control-seeds``: the control, the reference computing in float8
  (``reference.models.Precision``) in the program's place, against the
  float32 reference.
- ``--fault``: a run of the program with one of its driver's ``FAULTS``
  planted.

Prints one JSON line a reading: {"kind", "seed", the numbers}. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import shutil
import sys
import tempfile
import time

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

harness.set_cache_dirs()

import torch  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


@contextlib.contextmanager
def _run(cell, cfg, seed, device):
    """A run of ``cell`` at ``seed`` with no window of its own, in a scratch
    directory removed after it, the device's cache emptied."""
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    try:
        yield harness.Run(cell=cell, config=cfg, seed=seed, seconds=0.0, trace=False,
                          device=device, tmp=tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def program_reading(cell, cfg, drv, seed, device, fault=None) -> dict:
    """The readings of one run of the program (with ``fault`` planted):
    set-up, one window call, the check's readings."""
    with _run(cell, cfg, seed, device) as run, \
            (drv.FAULTS[fault]() if fault else contextlib.nullcontext()):
        state = drv.setup(run)
        run.window = drv.window(run, state, 0.0)
        return drv.readings(run, state)


def control_reading(cell, cfg, drv, seed, device) -> dict:
    """The control's readings against the float32 reference."""
    with _run(cell, cfg, seed, device) as run:
        return drv.control(run)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 3
    cell, cfg, drv = harness.cell_files(args.workload)
    device = torch.device("cuda", 0)
    jobs = [("program", s, None) for s in args.seeds]
    jobs += [("control", s, None) for s in args.control_seeds]
    jobs += [(f"fault:{args.fault}", s, args.fault) for s in args.fault_seeds]
    for kind, seed, fault in jobs:
        t0 = time.perf_counter()
        if kind == "control":
            out = control_reading(cell, cfg, drv, seed, device)
        else:
            out = program_reading(cell, cfg, drv, seed, device, fault)
        print(json.dumps({"kind": kind, "seed": seed, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
