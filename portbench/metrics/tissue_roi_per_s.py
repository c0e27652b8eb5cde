"""tissue_roi_per_s: ROIs whose mask PNG was written, over the time of the
whole folder calls of the window. Host clock."""


def read(run):
    w = run.window
    return w["rois"] / w["seconds"] if "rois" in w else None
