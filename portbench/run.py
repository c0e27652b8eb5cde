"""Run one cell of the port's benchmark once and print its result:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed on the device, the program built and warmed
up on the cell's shapes), then the measured window of ``--seconds``, then
the correctness check against the plain reference once the window has
closed, the peak memory read and the program's state freed. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``: each compared number with its limit); the checks are also
the last lines of standard error, after the set-up's parts (``setup <part>
<seconds> s``). ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones from a profiled window
of at most ``trace.TRACE_SECONDS``.
Exits non-zero without a result when there is no CUDA card, fewer cards
than the cell asks for, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402

harness.set_cache_dirs()

import torch  # noqa: E402

from portbench import trace as tracing  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(run: harness.Run, drv, bench: dict, start: float) -> dict:
    """Set-up, window, check and metrics of one run; returns the result."""
    cuda = run.device.type == "cuda"
    run.setup_parts["start"] = time.time() - start  # imports, the card's context
    state = drv.setup(run)
    if cuda:
        torch.cuda.synchronize()
    run.setup_s = time.time() - start
    if run.trace:
        seconds = min(run.seconds, tracing.TRACE_SECONDS)
        run.window, run.summary = tracing.traced(lambda: drv.window(run, state, seconds))
    else:
        run.window = drv.window(run, state, run.seconds)
        if cuda:
            torch.cuda.synchronize()
    run.peak_bytes = torch.cuda.max_memory_reserved() if cuda else 0
    checks = drv.check(run, state)  # frees the program's state first
    del state
    gc.collect()
    metrics = {}
    for m in harness.metrics_of(bench, run.cell["name"], run.trace):
        value = harness.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = run.window["failed"] == 0 and bool(checks) and all(
        limit is not None and math.isfinite(value) and value <= limit
        for value, limit in checks.values())
    device = {"platform": "gpu" if cuda else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
              "count": run.cell["chips"], "memory_peak_bytes": run.peak_bytes}
    result = {"correct": correct, "attempted": run.window["attempted"],
              "failed": run.window["failed"], "metrics": metrics, "device": device}
    if run.trace:
        device.update(busy_s=run.summary["busy_s"], window_s=run.summary["window_s"])
        result["breakdown"] = {"device_ops": run.summary["device_ops"],
                               "idle_gaps": run.summary["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    start = harness.process_start()
    args = parse_args(argv)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cell, cfg, drv = harness.cell_files(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    tmp = tempfile.mkdtemp(prefix=f"portbench-{args.workload}-")
    try:
        run = harness.Run(cell=cell, config=cfg, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda", 0), tmp=tmp,
                          counts=harness.counts(args.workload))
        result = run_cell(run, drv, bench, start)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, seconds in run.setup_parts.items():
        print(f"setup {name} {seconds!r} s", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
