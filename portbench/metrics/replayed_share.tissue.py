"""replayed_share.tissue: the fused programs' replays over their calls in
the window (``Program.replays`` and ``Program.calls``), in %."""


def read(run):
    w = run.window
    return 100.0 * w["replays"] / w["program_calls"] if w.get("program_calls") else None
