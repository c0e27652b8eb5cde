"""idle.stage1: the device's idle share of the traced window
(``trace.idle_percent``), in %."""
from portbench.trace import idle_percent


def read(run):
    return idle_percent(run.summary)
