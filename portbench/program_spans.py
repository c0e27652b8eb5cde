"""What the program's own tracer (``ldiffusion_tpu_torch.core.tracing``)
recorded in a traced window. It records only while a ``torch.profiler``
session records, and ``trace.traced`` profiles exactly the window, so its
registry holds the window and nothing else. Each function returns None
where the program has no tracer (a checkout older than it)."""


def _tracing():
    try:
        from ldiffusion_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing


def summary():
    """The tracer's ``summary()``: spans by name, counters; or None."""
    t = _tracing()
    return t.summary() if t else None


def records():
    """The tracer's finished spans (``records()``), or None."""
    t = _tracing()
    return t.records() if t else None


def counter_mean(name: str):
    """The counter's total over its count, or None where it has none."""
    s = summary()
    c = s and s["counters"].get(name)
    return c["total"] / c["count"] if c and c["count"] else None


def span_s(spans: dict, name: str) -> float:
    """Total seconds of the spans ``name`` in a summary's ``spans`` (0 without one)."""
    return spans[name]["total_s"] if name in spans else 0.0
