"""fused_replay_ms.tissue: the fused tissue program's device time a replay
(transform, 5 folds x 4 mirrors of the DynUNet, the label map), in ms: the
program's counter ``program.tissue_fused.replay_ms``, from timing events
around each ``graph.replay()``, over its count in the traced window."""
from portbench.program_spans import counter_mean


def read(run):
    return counter_mean("program.tissue_fused.replay_ms")
