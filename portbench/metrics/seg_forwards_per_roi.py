"""seg_forwards_per_roi: the predictors' ``network_forwards`` counter over
the window's calls, per ROI written (folds × mirrors × tiles)."""


def read(run):
    w = run.window
    return w["network_forwards"] / w["rois"] if w.get("rois") else None
