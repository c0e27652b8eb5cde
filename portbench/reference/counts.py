"""Operation and byte counts that the MFU and roofline readers divide by,
worked out from the reference at a cell's shapes and frozen in
``counts/<cell>.json`` beside this file, so that they stay the same whatever
implements the step.

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the reference
  on the meta device (matrix products and convolutions; no recomputation):
  a stage-1 step forward and backward, or one tissue ROI (the transform
  and the DynUNet forwards of every fold and mirror).
- ``attention``: the stage-1 step's attention calls of 512 keys or more,
  the ones the attention kernels serve: each forward (as often as the step
  runs it: remat recomputes the trajectory's) and the backward of those
  with head dim ≤ 160. A forward is 4·B·H·Sq·Sk·D operations and reads q,
  k, v and writes o once in bf16 (and its logsumexp in f32 when a backward
  follows); a backward is 10·B·H·Sq·Sk·D operations and reads q, k, v, o,
  dO and the logsumexp and writes dq, dk, dv once. Its bound is
  max(operations / bf16 peak, bytes / HBM bytes a second).
- ``groupnorm``: each GroupNorm of a tissue ROI's transform reads its bf16
  input and writes its bf16 output once, with its bf16 scale and shift:
  bytes-bound.

Each driver's ``counts(cell, cfg)`` works its cell's counts out with the
arithmetic here; ``python -m portbench.reference.counts <cell> ...`` calls
it and writes the files.
"""
from __future__ import annotations

import json
import os
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.reference import models, peaks

HERE = os.path.dirname(os.path.abspath(__file__))
FLASH_MIN_KEYS = 512
FLASH_BWD_MAX_HEAD_DIM = 160
BF16 = 2
SOURCE = ("portbench/reference/counts.py over the reference on the meta device; "
          "FlopCounterMode counts matrix products and convolutions, 2 per MAC")


def attention_bound(b, sq, sk, h, d, backward: bool, lse: bool) -> dict:
    """Operations, bytes and bound seconds of one attention call (bf16)."""
    if backward:
        ops = 10.0 * b * h * sq * sk * d
        nbytes = BF16 * b * h * d * (4 * sq + 4 * sk) + 4.0 * b * h * sq
    else:
        ops = 4.0 * b * h * sq * sk * d
        nbytes = BF16 * b * h * d * (2 * sq + 2 * sk) + (4.0 * b * h * sq if lse else 0.0)
    return {"ops": ops, "bytes": nbytes,
            "bound_s": max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)}


def groupnorm_bound(shape) -> dict:
    """Bytes and bound seconds of one bf16 GroupNorm of an NCHW ``shape``."""
    n, c = 1, shape[1]
    for s in shape:
        n *= s
    nbytes = BF16 * (2 * n + 2 * c)
    return {"bytes": nbytes, "bound_s": nbytes / peaks.HBM_BYTES}


def flops(fn) -> int:
    """The FLOPs that ``FlopCounterMode`` counts in ``fn()`` (matrix products
    and convolutions, 2 per multiply-add)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def main(argv):
    for name in argv:
        cell, cfg, drv = harness.cell_files(name)
        out = drv.counts(cell, cfg)
        out["source"] = SOURCE
        os.makedirs(os.path.join(HERE, "counts"), exist_ok=True)
        with open(os.path.join(HERE, "counts", f"{name}.json"), "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
        print(name, json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
