"""What a traced window's profiler trace says: the device's busy time as the
union of its operations' intervals (streams that overlap count once), the
device time by kernel and by family, and the idle gaps labelled by the
benchmark's own spans (``portbench/<name>`` ranges around its calls).

The events are ``torch.profiler``'s (CPU and CUDA activity), read from its
Kineto results as Chrome-trace records (``cat``, ``name``, ``ts`` and
``dur`` in µs) without writing the trace: device operations are of
category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; spans are
``user_annotation`` events. A traced window lasts at most
``TRACE_SECONDS``: a 512² training step launches some tens of thousands
of kernels, and reading more of them would not end within a run's time.
"""
from __future__ import annotations

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench/"
WINDOW_SPAN = SPAN_PREFIX + "window"
TOP = 10
TRACE_SECONDS = 10.0


def kernel_family(name: str) -> str:
    """The family a device operation's name belongs to."""
    n = name.lower()
    if "nccl" in n:
        return "collective (NCCL)"
    if "flash_fwd" in n:
        return "flash_attention_fwd"
    if "flash_bwd" in n:
        return "flash_attention_bwd"
    if any(k in n for k in ("gn_resident", "gn_stream", "gn_stats", "gn_finalize", "gn_apply")):
        return "groupnorm_silu"
    if any(k in n for k in ("conv", "cudnn", "implicit", "winograd", "dgrad", "fprop", "wgrad")):
        return "convolution (cuDNN)"
    if any(k in n for k in ("gemm", "cutlass", "cublas", "sm90_xmma", "ampere")):
        return "matmul (cuBLAS)"
    if "reduce" in n or "norm" in n or "softmax" in n:
        return "reduction / norm / softmax"
    if "memcpy" in n or "memset" in n:
        return "copy / memset"
    return "elementwise and other"


def union(intervals):
    """Sorted, merged [start, end] intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list) -> dict:
    """A window's summary from its trace events (times in µs): ``window_s``
    (the window span's length), ``busy_s`` (the union of device operations
    within it), ``kernel_s`` and ``family_s`` (summed device time by name and
    by family), ``device_ops`` (the families with most time) and
    ``idle_gaps`` (the longest gaps between device operations, each named
    by the innermost benchmark span around its middle on the host)."""
    windows = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    t0 = float(windows[0]["ts"])
    t1 = t0 + float(windows[0]["dur"])
    ops, kernel_s, family_s = [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s = max(float(e["ts"]), t0)
        end = min(float(e["ts"]) + float(e.get("dur", 0.0)), t1)
        if end <= s:
            continue
        ops.append((s, end))
        name = e.get("name", "")
        kernel_s[name] = kernel_s.get(name, 0.0) + (end - s) / 1e6
        fam = kernel_family(name) if e["cat"] == "kernel" else "copy / memset"
        family_s[fam] = family_s.get(fam, 0.0) + (end - s) / 1e6
    busy = union(ops)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(SPAN_PREFIX):])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX) and e["name"] != WINDOW_SPAN]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = (s + e) / 2
            around = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            label = min(around, key=lambda sp: sp[1] - sp[0])[2] if around else "between spans"
            gaps.append([label, (e - s) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    return {"window_s": (t1 - t0) / 1e6, "busy_s": sum(e - s for s, e in busy) / 1e6,
            "kernel_s": kernel_s, "family_s": family_s,
            "device_ops": sorted(([k, v] for k, v in family_s.items()), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": gaps[:TOP]}


def idle_percent(summary) -> float:
    """The device's idle share of a traced window, in %: 1 − the union of
    its operations' intervals over the window's length; None without a
    trace or with no device operation in it."""
    if not summary or summary["window_s"] <= 0 or summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])


def traced(fn):
    """Run ``fn()`` under ``torch.profiler`` (CPU and CUDA activity) inside
    the window span, ending in a synchronise; returns (its result, the
    summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            out = fn()
            torch.cuda.synchronize()
    return out, summarize(records(prof.profiler.kineto_results.events()))


def records(kineto_events) -> list:
    """Chrome-trace records (``cat``, ``name``, ``ts``, ``dur`` in µs) of
    the device operations and the CPU-side user annotations among Kineto's
    events. Where an event cannot say its category (``activity_type`` is
    younger than some torch releases), a device event named as a CPU event
    is a user annotation's device range, one named ``Memcpy``/``Memset`` a
    copy or fill, any other a kernel; a CPU event is a user annotation when
    it says so, or carries a benchmark span's name."""
    from torch.autograd import DeviceType

    events = list(kineto_events)
    if events and hasattr(events[0], "activity_type"):
        cats = [e.activity_type() for e in events]
    else:
        cpu = {e.name() for e in events if e.device_type() == DeviceType.CPU}
        cats = []
        for e in events:
            name = e.name()
            if e.device_type() != DeviceType.CPU:
                cats.append("gpu_user_annotation" if name in cpu else
                            "gpu_memcpy" if name.startswith("Memcpy") else
                            "gpu_memset" if name.startswith("Memset") else "kernel")
            elif (e.is_user_annotation() if hasattr(e, "is_user_annotation")
                  else name.startswith(SPAN_PREFIX)):
                cats.append("user_annotation")
            else:
                cats.append("cpu_op")
    kept = DEVICE_CATEGORIES + ("user_annotation",)
    out = []
    for e, cat in zip(events, cats):
        if cat in kept:
            if hasattr(e, "start_ns"):
                ts, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
            else:
                ts, dur = float(e.start_us()), float(e.duration_us())
            out.append({"cat": cat, "name": e.name(), "ts": ts, "dur": dur})
    return out
