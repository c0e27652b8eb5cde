"""fwd_ms.stage1: the stage-1 step's forward on the device, in ms a step
(the draws, the trajectory, the VAE decode, VGG and InfoNCE): the program's
counter ``train_step.forward_ms``, from the timing events its captured step
records, over its count in the traced window."""
from portbench.program_spans import counter_mean


def read(run):
    return counter_mean("train_step.forward_ms")
