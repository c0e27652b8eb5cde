"""opt_ms.stage1: the stage-1 step's optimizer on the device, in ms a step
(the global-norm clip, AdamW on the f32 masters, their cast back into the
bf16 modules): the program's counter ``train_step.optimizer_ms`` over its
count in the traced window."""
from portbench.program_spans import counter_mean


def read(run):
    return counter_mean("train_step.optimizer_ms")
