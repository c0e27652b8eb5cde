"""roi_host_ms.tissue: the host's own work a ROI in folder mode, in ms: the
program's spans ``tissue/read_roi`` (probe, TIFF decode and resize, the
staging copy) and ``tissue/write_mask`` (postprocessing, PNG encode and
save) less ``tissue/wait_mask`` (the wait for the mask), over the count of
``tissue/read_roi`` in the traced window."""
from portbench.program_spans import span_s, summary


def read(run):
    s = summary()
    rois = s and s["spans"].get("tissue/read_roi")
    if not rois or not rois["count"]:
        return None
    host = span_s(s["spans"], "tissue/read_roi") + span_s(s["spans"], "tissue/write_mask") \
        - span_s(s["spans"], "tissue/wait_mask")
    return 1e3 * host / rois["count"]
