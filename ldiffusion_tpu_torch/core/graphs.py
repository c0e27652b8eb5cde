"""Programs captured as CUDA graphs: the port's counterpart of the JAX
package's jitted programs (``ldiffusion_tpu/api.py:313-346``,
``ldiffusion_tpu/segmentor/predictor.py:280-318``), which compile once per
cache key and then run without the host in the loop.

A ``Program`` wraps ``fn(x)`` (one input tensor; a tensor or a tuple of
tensors out) on a device. On a CUDA device:

- its first call runs ``fn`` eagerly: the capture's warm-up (cuDNN makes its
  choices, the kernels set their shared-memory attributes, the GroupNorm
  workspace grows);
- its second copies the input into a static tensor, captures ``fn`` on it
  into a ``torch.cuda.CUDAGraph`` (memory from ``pool``: one
  ``torch.cuda.graph_pool_handle()`` shared by an owner's programs) and
  replays it;
- later calls copy the input into the static tensor and replay.

A replay returns the graph's static outputs, which the next replay of a
program of the same pool may overwrite: read them (or enqueue their copy)
before the next call. Replays are ordered on the current stream. On the CPU
every call runs ``fn``; no graph is made. There is no switch that turns
capture off, and a capture or replay that fails raises.

Launch counters: the kernel wrappers count a launch in Python where they
enqueue their kernel, which happens once, at capture. A ``Program`` records
what its capture added to every counter (``counters()``, plus the
``counted`` pairs it was given), takes that back (a capture launches
nothing), and adds it again on every replay, so that the counts stay the
launches the device ran.
"""
from __future__ import annotations

import time

import torch

# (owner, attribute) pairs that captures record and replays repeat, besides
# the kernel wrappers' counters: ``watch_counter`` adds, ``unwatch_counter``
# removes.
_WATCHED: list = []


def watch_counter(owner, attr: str) -> None:
    """Count ``owner.attr`` (an int, or a dict of ints) through replays of
    the programs captured from now on."""
    _WATCHED.append((owner, attr))


def unwatch_counter(owner, attr: str) -> None:
    _WATCHED.remove((owner, attr))


def counters() -> list:
    """The (owner, attribute) pairs of every kernel wrapper's launch counts."""
    from ldiffusion_tpu_torch.ops import attention, groupnorm, quant

    fns = (attention.flash_attention_fwd, attention.flash_attention_fwd_lse,
           attention.flash_attention_bwd, groupnorm.groupnorm_silu, quant.int8_conv,
           quant.int8_matmul)
    return [(fn, a) for fn in fns for a in ("launches", "launches_by_route")
            if hasattr(fn, a)] + list(_WATCHED)


def _read(pairs) -> list:
    return [dict(v) if isinstance(v, dict) else v for v in (getattr(o, a) for o, a in pairs)]


def _diff(after: list, before: list) -> list:
    return [{k: n - b.get(k, 0) for k, n in a.items()} if isinstance(a, dict) else a - b
            for a, b in zip(after, before)]


def _add(pairs, deltas: list, sign: int = 1) -> None:
    for (owner, attr), d in zip(pairs, deltas):
        cur = getattr(owner, attr)
        if isinstance(d, dict):
            for k, n in d.items():
                cur[k] = cur.get(k, 0) + sign * n
        else:
            setattr(owner, attr, cur + sign * d)


class Program:
    """``fn`` run eagerly once, then captured and replayed (module docstring).
    ``counted``: more (owner, attribute) counters that ``fn`` raises and
    replays repeat (a predictor's ``network_forwards``)."""

    def __init__(self, fn, device, pool=None, counted=()):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.counted = list(counted)
        self.calls = 0
        self.replays = 0
        self.capture_s = 0.0
        self.graph = None
        self.static_input = None
        self.static_output = None
        self._pairs: list = []
        self._deltas: list = []

    def __call__(self, x):
        """``x``: the input, on the device or on the host (a pinned host
        tensor is copied without blocking)."""
        with torch.inference_mode():
            if self.device.type != "cuda":
                return self.fn(x.to(self.device))
            self.calls += 1
            if self.graph is not None:
                self.static_input.copy_(x, non_blocking=True)
            elif self.calls == 1:
                return self.fn(x.to(self.device, non_blocking=True))
            else:
                self._capture(x)
            return self._replay()

    def _capture(self, x):
        t0 = time.perf_counter()
        # the input's strides, as the eager first use saw them
        self.static_input = torch.empty_like(x, device=self.device).copy_(x, non_blocking=True)
        pairs = counters() + self.counted
        before = _read(pairs)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.fn(self.static_input)
        finally:
            deltas = _diff(_read(pairs), before)
            _add(pairs, deltas, -1)  # a capture launches nothing
        self.graph, self.static_output = graph, out
        self._pairs, self._deltas = pairs, deltas
        self.capture_s = time.perf_counter() - t0

    def _replay(self):
        self.graph.replay()
        self.replays += 1
        _add(self._pairs, self._deltas)
        return self.static_output
