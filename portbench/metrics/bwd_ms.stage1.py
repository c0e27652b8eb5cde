"""bwd_ms.stage1: the stage-1 step's backward on the device, in ms a step
(the recomputed trajectory with its gradients, the gradients' cast to the
f32 masters): the program's counter ``train_step.backward_ms`` over its
count in the traced window."""
from portbench.program_spans import counter_mean


def read(run):
    return counter_mean("train_step.backward_ms")
