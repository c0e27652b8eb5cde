"""gn_roofline.tissue: the transform's GroupNorm calls' least time at the
roofline (bytes-bound: each bf16 input read and output written once, the
frozen sum a ROI in ``reference/counts/<cell>.json``) times the ROIs, over
the device time of the GroupNorm family in the traced window, in %."""

FAMILY = ("gn_resident", "gn_stream", "gn_stats", "gn_finalize", "gn_apply")


def read(run):
    s, w = run.summary, run.window
    bound = run.counts.get("groupnorm", {}).get("bound_s_per_roi")
    if not s or not bound or not w.get("rois"):
        return None
    device_s = sum(t for name, t in s["kernel_s"].items() if any(k in name for k in FAMILY))
    return 100.0 * bound * w["rois"] / device_s if device_s > 0 else None
