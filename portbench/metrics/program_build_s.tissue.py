"""program_build_s.tissue: host seconds a folder call spends on its
programs' eager first use and capture: the program's spans
``program/eager`` and ``program/capture`` of the requests of its
``tissue/call`` spans, over their count, in the traced window."""
from portbench.program_spans import records

BUILD = ("program/eager", "program/capture")


def read(run):
    spans = records()
    if not spans:
        return None
    calls = {s["request"] for s in spans if s["name"] == "tissue/call"}
    builds = [s for s in spans if s["name"] in BUILD and s["request"] in calls]
    if not calls or not builds:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in builds) / 1e9 / len(calls)
