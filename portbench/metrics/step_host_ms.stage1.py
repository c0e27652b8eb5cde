"""step_host_ms.stage1: the host's time in ``train_step`` before it waits
for the device, in ms a step: the program's span ``train_step`` less its
child ``train_step/read`` (so its self time, the inputs' device copies
``train_step/inputs`` and the program's ``program/replay``: the Jit key, the
static inputs' copies, the replay's enqueue), over the spans' count in the
traced window."""
from portbench.program_spans import span_s, summary


def read(run):
    s = summary()
    step = s and s["spans"].get("train_step")
    if not step or not step["count"]:
        return None
    return 1e3 * (step["total_s"] - span_s(s["spans"], "train_step/read")) / step["count"]
