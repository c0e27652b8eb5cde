"""mfu.stage1: a step's model FLOPs (the frozen count of the reference's
forward and backward at the cell's shapes, no recomputation:
``reference/counts/<cell>.json``) over the traced window's time a step and
the bf16 peak, in %. The profiler's overhead is in that time: it reads
some 5-8% under the same share worked out from the untraced rate."""
from portbench.reference import peaks


def read(run):
    s, w, flops = run.summary, run.window, run.counts.get("flops_per_step")
    if not s or not flops or not w.get("steps"):
        return None
    return 100.0 * flops * w["steps"] / (s["window_s"] * peaks.BF16_FLOPS)
