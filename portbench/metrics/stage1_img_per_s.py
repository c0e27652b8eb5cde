"""stage1_img_per_s: images trained in the window over the window's time
(steps × batch / seconds; each step ends in its host read of the step's
four values). Host clock."""


def read(run):
    w = run.window
    return w["steps"] * w["batch"] / w["seconds"] if "steps" in w else None
