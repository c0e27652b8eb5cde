"""Programs captured as CUDA graphs: the port's counterpart of the JAX
package's jitted programs (``ldiffusion_tpu/api.py:313-346``,
``ldiffusion_tpu/segmentor/predictor.py:280-318``, the trainers' donated
steps ``ldiffusion_tpu/train/ldiffusion.py:110-129`` and
``ldiffusion_tpu/segmentor/trainer.py:319-403``, the cell level's
``ldiffusion_tpu/cell/instance.py:135-388`` and
``ldiffusion_tpu/cell/classifier.py:199-384``, the dataset builder's
``ldiffusion_tpu/segmentor/dataset_builder.py:35-64``), which compile once
per cache key and then run without the host in the loop.

A ``Program`` wraps ``fn(*inputs)`` (input tensors; a tensor or a tuple of
tensors out) on a device. On a CUDA device:

- its first call runs ``fn`` eagerly: the capture's warm-up (cuDNN makes its
  choices, the kernels set their shared-memory attributes, the GroupNorm
  workspace grows, an optimizer makes its state);
- its second copies the inputs into static tensors, captures ``fn`` on them
  into a ``torch.cuda.CUDAGraph`` (memory from ``pool``: one
  ``torch.cuda.graph_pool_handle()`` shared by an owner's programs) and
  replays it;
- later calls copy the inputs into the static tensors and replay.

A replay returns the graph's static outputs, which the next replay of a
program of the same pool may overwrite: read them (or enqueue their copy)
before the next call. Replays are ordered on the current stream. On the CPU
every call runs ``fn``; no graph is made. ``calls`` counts the calls on
every device, ``replays`` the replays. There is no switch that turns
capture off, and a capture or replay that fails raises.

``Program`` runs ``fn`` under ``torch.inference_mode``. ``TrainProgram``
runs it with autograd (a training step: forward, backward, optimizer), and
registers the owner's ``torch.Generator``s with its graph, so that each
replay draws what an eager step would and advances them as far.
``Jit`` keeps one program per input signature (each input's shape and
dtype) and static keyword values, the key ``jax.jit`` compiles by.

Each program has a ``name``, its owner's (``stage1_step``, ``tissue_fused``,
``predict_bucket``, ...). While a ``torch.profiler`` session records
(``core/tracing.py``), a call is the span ``program/eager``,
``program/capture`` or ``program/replay`` (host time), and each replay's
device time, from timing events around ``graph.replay()``, is added to the
counter ``program.<name>.replay_ms``. ``capture_s`` is the capture span's
duration.

Launch counters: the kernel wrappers count a launch in Python where they
enqueue their kernel, which happens once, at capture. A ``Program`` records
what its capture added to every counter (``counters()``, plus the
``counted`` pairs it was given), takes that back (a capture launches
nothing), and adds it again on every replay, so that the counts stay the
launches the device ran.
"""
from __future__ import annotations

import functools
import weakref

import torch

from ldiffusion_tpu_torch.core import tracing

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
           attention.flash_attention_bwd, groupnorm.groupnorm_silu,
           groupnorm.groupnorm_silu_backward, quant.int8_conv, quant.int8_matmul)
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


def weak_method(method):
    """``method`` (a bound method) called through a weak reference to its
    object. An owner's program of its own method would otherwise close a
    cycle (owner → program → method → owner) that keeps the owner, its
    graphs and their pool's device memory alive after the last reference
    is dropped, until the cycle collector happens to run."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kwargs):
        return ref()(*args, **kwargs)

    return call


class Program:
    """``fn`` run eagerly once, then captured and replayed (module docstring).
    ``counted``: more (owner, attribute) counters that ``fn`` raises and
    replays repeat (a predictor's ``network_forwards``); ``generators``: the
    ``torch.Generator``s ``fn`` draws from; ``name``: the owner's name for
    it, in its replays' counter."""

    def __init__(self, fn, device, pool=None, counted=(), generators=(), name="program"):
        self.fn = fn
        self.name = name
        self._replay_ms = f"program.{name}.replay_ms"
        self.device = torch.device(device)
        self.pool = pool
        self.counted = list(counted)
        self.generators = list(generators)
        self.calls = 0
        self.replays = 0
        self.capture_s = 0.0
        self.graph = None
        self.static_inputs = ()
        self.static_output = None
        self._pairs: list = []
        self._deltas: list = []

    @staticmethod
    def _mode():
        return torch.inference_mode()

    def __call__(self, *xs):
        """``xs``: the inputs, on the device or on the host (a pinned host
        tensor is copied without blocking)."""
        with self._mode():
            self.calls += 1
            if self.device.type != "cuda":
                return self.fn(*(x.to(self.device) for x in xs))
            if self.graph is not None:
                for static, x in zip(self.static_inputs, xs):
                    static.copy_(x, non_blocking=True)
            elif self.calls == 1:
                with tracing.span("program/eager"):
                    return self.fn(*(x.to(self.device, non_blocking=True) for x in xs))
            else:
                captured = tracing.Span("program/capture")
                with captured:
                    self._capture(xs)
                self.capture_s = captured.seconds
            with tracing.span("program/replay"), tracing.device_time(self._replay_ms):
                return self._replay()

    def _capture(self, xs):
        # the inputs' strides, as the eager first use saw them
        self.static_inputs = tuple(torch.empty_like(x, device=self.device)
                                   .copy_(x, non_blocking=True) for x in xs)
        pairs = counters() + self.counted
        before = _read(pairs)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.fn(*self.static_inputs)
        finally:
            deltas = _diff(_read(pairs), before)
            _add(pairs, deltas, -1)  # a capture launches nothing
        self.graph, self.static_output = graph, out
        self._pairs, self._deltas = pairs, deltas

    def _replay(self):
        self.graph.replay()
        self.replays += 1
        _add(self._pairs, self._deltas)
        return self.static_output


class TrainProgram(Program):
    """A ``Program`` run with autograd: a training step whose backward and
    optimizer update the parameters and the optimizer's state in place. At
    capture the backward makes each ``.grad`` a static tensor of the pool,
    which every replay writes again; the owner must not replace a tensor the
    graph reads (parameters, optimizer state), only write it in place."""

    @staticmethod
    def _mode():
        return torch.enable_grad()


class Jit:
    """One program per input signature (each input's shape and dtype) and
    static values (the keywords of a call, ``jax.jit``'s
    ``static_argnames``), the key ``jax.jit`` compiles by:
    ``program_type(fn, device, pool, generators=generators, name=name)`` made at a
    key's first call, with the static values bound to ``fn`` as keywords.
    ``fn`` is an owner's bound method, held weakly (``weak_method``);
    ``name``: its programs' name."""

    def __init__(self, fn, device, pool=None, generators=(), program_type=Program,
                 name="program"):
        self.fn = weak_method(fn)
        self.device = device
        self.pool = pool
        self.generators = list(generators)
        self.program_type = program_type
        self.name = name
        self.programs: dict = {}

    def __call__(self, *xs, **static):
        key = tuple((tuple(x.shape), x.dtype) for x in xs) + tuple(sorted(static.items()))
        program = self.programs.get(key)
        if program is None:
            fn = functools.partial(self.fn, **static) if static else self.fn
            program = self.programs[key] = self.program_type(
                fn, self.device, self.pool, generators=self.generators, name=self.name)
        return program(*xs)
