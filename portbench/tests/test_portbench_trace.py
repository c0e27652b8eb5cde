"""The trace reduction on a made-up trace: busy time is the union of the
device operations' intervals (overlapping streams count once), clipped to
the window span; idle gaps are named by the innermost benchmark span."""
import pytest

from portbench import trace


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [
    ev("user_annotation", trace.WINDOW_SPAN, 1000.0, 1000.0),       # window 1000-2000 µs
    ev("user_annotation", "portbench/train_step", 1000.0, 600.0),
    ev("user_annotation", "portbench/load_batch", 1650.0, 300.0),
    ev("kernel", "void flash_fwd_wgmma<64>(x)", 900.0, 200.0),     # clipped to 1000-1100
    ev("kernel", "cudnn_conv_fprop", 1050.0, 150.0),              # overlaps: 1050-1200
    ev("kernel", "void at::native::vectorized_elementwise_kernel", 1300.0, 100.0),
    ev("gpu_memcpy", "Memcpy HtoD", 1390.0, 20.0),                # 1390-1410
    ev("kernel", "gn_resident<bf16>", 1900.0, 50.0),
    ev("kernel", "void late", 2100.0, 10.0),                      # outside the window
    ev("cpu_op", "aten::add", 1200.0, 5.0),
]


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [[1, 4], [5, 8]]


def test_summary_busy_is_the_union_within_the_window():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1000e-6)
    # 1000-1200, 1300-1410, 1900-1950
    assert s["busy_s"] == pytest.approx((200 + 110 + 50) * 1e-6)
    summed = sum(s["kernel_s"].values())
    assert summed == pytest.approx((100 + 150 + 100 + 20 + 50) * 1e-6)  # sums overcount
    assert s["family_s"]["flash_attention_fwd"] == pytest.approx(100e-6)
    assert s["family_s"]["groupnorm_silu"] == pytest.approx(50e-6)
    assert s["family_s"]["copy / memset"] == pytest.approx(20e-6)


def test_idle_gaps_named_by_innermost_span():
    s = trace.summarize(EVENTS)
    gaps = dict((round(v * 1e6), k) for k, v in s["idle_gaps"])
    # gaps: 1200-1300 (train_step), 1410-1900 (mid 1655: load_batch), 1950-2000 (none)
    assert gaps == {100: "train_step", 490: "load_batch", 50: "between spans"}
    assert [round(v * 1e6) for _, v in s["idle_gaps"]] == [490, 100, 50]


def test_window_span_required():
    with pytest.raises(RuntimeError):
        trace.summarize([e for e in EVENTS if e["name"] != trace.WINDOW_SPAN])


def test_kernel_families():
    assert trace.kernel_family("void pytorch_flash::flash_bwd_dq_kernel") == "flash_attention_bwd"
    assert trace.kernel_family("gn_stream_stats<float>") == "groupnorm_silu"
    assert trace.kernel_family("sm90_xmma_gemm_bf16") == "matmul (cuBLAS)"
    assert trace.kernel_family("ncclDevKernel_AllReduce") == "collective (NCCL)"


class _Event:
    """A Kineto event as older torch releases give it: no ``activity_type``,
    no ``is_user_annotation``, times in µs."""

    def __init__(self, name, device, ts, dur):
        self._n, self._d, self._t, self._u = name, device, ts, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_us(self):
        return self._t

    def duration_us(self):
        return self._u


def test_records_without_categories():
    from torch.autograd import DeviceType

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_Event(trace.WINDOW_SPAN, cpu, 1000, 1000),
              _Event("portbench/train_step", cpu, 1000, 600),
              _Event("Optimizer.step#AdamW.step", cpu, 1100, 50),
              _Event("aten::add", cpu, 1200, 5),
              _Event("Optimizer.step#AdamW.step", cuda, 1050, 300),  # a device range
              _Event("portbench/train_step", cuda, 1000, 600),
              _Event("void flash_fwd_wgmma<64>(x)", cuda, 1000, 100),
              _Event("Memcpy HtoD (Pageable -> Device)", cuda, 1150, 50)]
    recs = trace.records(events)
    assert [(r["cat"], r["name"]) for r in recs] == [
        ("user_annotation", trace.WINDOW_SPAN), ("user_annotation", "portbench/train_step"),
        ("kernel", "void flash_fwd_wgmma<64>(x)"), ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)")]
    s = trace.summarize(recs)
    assert s["busy_s"] == pytest.approx(150e-6)  # the device ranges of annotations are no work


def test_records_from_this_torch():
    """The categories this torch's profiler gives, on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            torch.ones(8).add_(1)
    recs = trace.records(prof.profiler.kineto_results.events())
    assert [r["name"] for r in recs] == [trace.WINDOW_SPAN]
    assert trace.summarize(recs)["busy_s"] == 0.0
