"""predictor_build_s.tissue: seconds a folder call spends finding the fold
checkpoints and building the predictor (reading, converting, the nets on
the device): the program's span ``tissue/predictor_build`` over the count of
its ``tissue/call`` spans in the traced window."""
from portbench.program_spans import span_s, summary


def read(run):
    s = summary()
    calls = s and s["spans"].get("tissue/call")
    if not calls or "tissue/predictor_build" not in s["spans"]:
        return None
    return span_s(s["spans"], "tissue/predictor_build") / calls["count"]
