"""mfu.tissue: a ROI's model FLOPs (the frozen count of the reference's
transform and DynUNet forwards, every fold and mirror:
``reference/counts/<cell>.json``) times the ROIs written, over the traced
window's time and the bf16 peak, in %. The profiler's overhead is in that
time."""
from portbench.reference import peaks


def read(run):
    s, w, flops = run.summary, run.window, run.counts.get("flops_per_roi")
    if not s or not flops or not w.get("rois"):
        return None
    return 100.0 * flops * w["rois"] / (s["window_s"] * peaks.BF16_FLOPS)
