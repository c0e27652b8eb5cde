"""The port's spans and counters, recorded only while a ``torch.profiler``
session records: the profiler is the switch, and there is no other. With no
profiler running, ``span``, ``count`` and ``device_time`` return at once and
enter no ``record_function``.

A span keeps its name, its start and end (``time.perf_counter_ns``), its
parent (the span open around it) and a request id: the number of the
outermost open span, so that a training step's or a folder call's spans
share one. Each span is also a ``record_function`` range of the same name,
so it lands in the profiler's trace, nested in the ranges around it; on the
device's timeline the profiler draws the range of the innermost one around
the work it launched. Spans are kept in memory, from one thread.

Counters are named sums with a count of their additions. ``device_time``
records a pair of timing events around a block on the current CUDA stream;
the registry holds them until the device has passed both, then adds the
milliseconds between them to a counter (``summary`` synchronises first).
``summary()`` gives each span name's count, total and self time (its
duration less its children's) and the counters; ``records()`` the raw
spans; ``reset()`` clears everything.

Names belong to the program: ``train_step/...``, ``tissue/...``,
``predictor/...``, ``program/...``; counters ``<layer>.<quantity>``.
"""
from __future__ import annotations

import contextlib
import time

import torch

_OFF = contextlib.nullcontext()


def enabled() -> bool:
    """Whether a ``torch.profiler`` session is recording."""
    return torch._C._autograd._profiler_enabled()


class _Registry:
    """What the spans, counters and pending device timings have recorded."""

    def __init__(self):
        self.spans: list = []     # finished spans, dicts in the order they ended
        self.stack: list = []     # open spans
        self.counters: dict = {}  # name → [total, count]
        self.pending: list = []   # (counter name, start event, end event)
        self.next_id = 0
        self.next_request = 0

    def add(self, name: str, value: float) -> None:
        c = self.counters.setdefault(name, [0.0, 0])
        c[0] += value
        c[1] += 1


_REG = _Registry()


class Span:
    """One span: times its block always (``seconds``), and records it, as a
    registry entry and a ``record_function`` range, while the profiler
    records (``span`` makes one only then)."""

    __slots__ = ("name", "start_ns", "end_ns", "_entry", "_range")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = 0
        self._entry = self._range = None

    def __enter__(self):
        if enabled():
            reg = _REG
            parent = reg.stack[-1] if reg.stack else None
            request = parent["request"] if parent else reg.next_request
            if parent is None:
                reg.next_request += 1
            self._entry = {"name": self.name, "id": reg.next_id,
                           "parent": parent["id"] if parent else None, "request": request}
            reg.next_id += 1
            reg.stack.append(self._entry)
            self._range = torch.autograd.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._entry is not None:
            self._range.__exit__(*exc)
            entry = self._entry
            entry.update(start_ns=self.start_ns, end_ns=self.end_ns)
            if _REG.stack and _REG.stack[-1] is entry:
                _REG.stack.pop()
                _REG.spans.append(entry)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str):
    """A span around a block while the profiler records; else nothing."""
    return Span(name) if enabled() else _OFF


def count(name: str, value: float = 1.0) -> None:
    """Add ``value`` to the counter ``name`` while the profiler records."""
    if enabled():
        _REG.add(name, float(value))


@contextlib.contextmanager
def _timed(name: str):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    _resolve()
    _REG.pending.append((name, start, end))


def device_time(name: str):
    """While the profiler records: timing events around the block on the
    current CUDA stream, their milliseconds added to the counter ``name``
    once the device has passed them; else nothing."""
    return _timed(name) if enabled() else _OFF


def _resolve(wait: bool = False) -> None:
    """Adds the pending timings the device has completed, in order (all of
    them after a synchronise when ``wait``)."""
    pending = _REG.pending
    if wait and pending:
        torch.cuda.synchronize()
    done = 0
    for name, start, end in pending:
        if not (wait or end.query()):
            break
        _REG.add(name, start.elapsed_time(end))
        done += 1
    del pending[:done]


def records() -> list:
    """The finished spans: dicts of ``name``, ``id``, ``parent`` (its id, or
    None), ``request``, ``start_ns``, ``end_ns``."""
    return [dict(s) for s in _REG.spans]


def summary() -> dict:
    """{"spans": {name: {"count", "total_s", "self_s"}}, "counters": {name:
    {"total", "count"}}}, the pending device timings resolved first."""
    _resolve(wait=True)
    child_s: dict = {}
    for s in _REG.spans:
        if s["parent"] is not None:
            child_s[s["parent"]] = child_s.get(s["parent"], 0.0) + \
                (s["end_ns"] - s["start_ns"]) / 1e9
    spans: dict = {}
    for s in _REG.spans:
        dur = (s["end_ns"] - s["start_ns"]) / 1e9
        row = spans.setdefault(s["name"], {"count": 0, "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += dur
        row["self_s"] += dur - child_s.get(s["id"], 0.0)
    return {"spans": spans,
            "counters": {k: {"total": t, "count": n} for k, (t, n) in _REG.counters.items()}}


def reset() -> None:
    """Clears the spans, the counters and the pending timings."""
    _REG.__init__()
