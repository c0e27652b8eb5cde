"""The port's tracer (``ldiffusion_tpu_torch/core/tracing.py``), its sites
and its exporter, on the CPU, and the benchmark's readers of what it records.

- With no profiler nothing is recorded; under a CPU ``torch.profiler``
  session nested spans give their counts, totals, self times, parents and
  request ids, each is a ``user_annotation`` of its name among Kineto's
  events, counters sum, and ``reset`` clears it all.
- ``core/logging.profiler_trace`` writes the Chrome trace and the spans file.
- A 64² folder call through ``LDiffusionModel.inference_tissue`` records one
  ``tissue/predictor_build`` a call, ``tissue/read_roi`` and
  ``tissue/write_mask`` once per ROI and ``predictor.checkpoint_bytes`` equal
  to the checkpoint files' sizes; a CPU ``train_step`` records its spans and
  no phase counters (the timing events exist only on a card).
- Each of the benchmark's readers of the tracer returns None on an empty
  registry and its ratio on a filled one.
"""
import json
import os
import time
import warnings

import numpy as np
import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from ldiffusion_tpu_torch.core import tracing
from ldiffusion_tpu_torch.core.checkpoint import save_pytree
from ldiffusion_tpu_torch.core.logging import profiler_trace
from ldiffusion_tpu_torch.models.convert import dynunet_to_flax
from ldiffusion_tpu_torch.models.dynunet import DynUNet
from ldiffusion_tpu_torch.models.layers import init_random_
from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from portbench import harness
from portbench.trace import records as kineto_records

NAP_S = 0.002


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this file (the suite runs several workers on
    one host); the previous count comes back after the file."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_registry():
    tracing.reset()
    yield
    tracing.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_recorded_without_a_profiler():
    assert not tracing.enabled()
    assert tracing.span("a") is tracing.span("b")  # the shared no-op: no record_function
    with tracing.span("a"):
        with tracing.span("a/b"):
            tracing.count("n", 3)
    with tracing.device_time("t_ms"):
        pass
    assert tracing.summary() == {"spans": {}, "counters": {}}
    assert tracing.records() == []


def test_nested_spans_under_a_cpu_profiler():
    with _cpu_profile() as prof:
        assert tracing.enabled()
        for _ in range(2):  # two requests: a root with two children, one with a grandchild
            with tracing.span("root"):
                time.sleep(NAP_S)
                with tracing.span("root/a"):
                    time.sleep(NAP_S)
                    with tracing.span("root/a/leaf"):
                        time.sleep(NAP_S)
                with tracing.span("root/b"):
                    time.sleep(NAP_S)
                tracing.count("things", 2)
        tracing.count("things", 5)
    s = tracing.summary()
    recs = tracing.records()
    assert [r["name"] for r in recs] == ["root/a/leaf", "root/a", "root/b", "root"] * 2
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        parent = by_id.get(r["parent"])
        assert (parent is None) == (r["name"] == "root")
        if parent:
            assert r["name"].startswith(parent["name"] + "/")
            assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"]
            assert r["request"] == parent["request"]
    assert [r["request"] for r in recs if r["name"] == "root"] == [0, 1]
    dur = lambda r: (r["end_ns"] - r["start_ns"]) / 1e9  # noqa: E731
    for name, row in s["spans"].items():
        mine = [r for r in recs if r["name"] == name]
        kids = [c for r in mine for c in recs if c["parent"] == r["id"]]
        assert row["count"] == len(mine) == 2
        assert row["total_s"] == pytest.approx(sum(map(dur, mine)), rel=1e-12)
        assert row["self_s"] == pytest.approx(row["total_s"] - sum(map(dur, kids)), rel=1e-9)
        assert row["self_s"] >= 2 * NAP_S * 0.9
    assert s["spans"]["root/a/leaf"]["self_s"] == s["spans"]["root/a/leaf"]["total_s"]
    assert s["counters"] == {"things": {"total": 9.0, "count": 3}}
    names = {e["name"] for e in kineto_records(prof.profiler.kineto_results.events())
             if e["cat"] == "user_annotation"}
    assert {"root", "root/a", "root/a/leaf", "root/b"} <= names
    tracing.reset()
    assert tracing.summary() == {"spans": {}, "counters": {}} and tracing.records() == []


def test_profiler_trace_writes_the_trace_and_the_spans(tmp_path):
    with _cpu_profile():
        with tracing.span("before"):  # cleared when the exporter's session starts
            pass
    with profiler_trace(str(tmp_path)):
        with tracing.span("step"):
            torch.ones(8, 8).matmul(torch.ones(8, 8))
        tracing.count("step.n")
    spans, trace = sorted(os.listdir(tmp_path))
    assert spans.startswith("spans_") and trace.startswith("trace_")
    assert spans[len("spans_"):] == trace[len("trace_"):]  # one stamp
    with open(tmp_path / spans) as f:
        out = json.load(f)
    assert [r["name"] for r in out["spans"]] == ["step"]
    assert out["summary"]["spans"]["step"]["count"] == 1
    assert out["summary"]["counters"] == {"step.n": {"total": 1.0, "count": 1}}
    with open(tmp_path / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "step" and e.get("cat") == "user_annotation" for e in events)


# -- the sites ---------------------------------------------------------------

def _segmentor(root, folds=2):
    """A 32² / 3-class 2D plan and ``folds`` seeded folds in the trainers' layout."""
    kw = dict(patch_size=(32, 32), batch_size=2, features_per_stage=(8, 16), strides=(1, 2),
              n_conv_per_stage=2, num_classes=3, in_channels=3,
              normalization="zscore_image", intensity_properties={}, median_shape=(32, 32),
              batch_dice=True)
    plan = SegPlan(**kw)
    seg = root / "segmentor"
    plan.save(str(seg / "plans.json"))
    cfg = plan.network_config()
    paths = []
    for fold in range(folds):
        net = init_random_(DynUNet(cfg), torch.Generator().manual_seed(fold))
        path = seg / f"fold_{fold}" / "checkpoint_final.pkl"
        save_pytree(str(path), {"params": dynunet_to_flax(net.state_dict(), cfg),
                                "batch_stats": {}, "plan": plan.to_json()})
        paths.append(str(path))
    return str(seg), paths


def test_tissue_folder_call_records_its_spans(tmp_path):
    from ldiffusion_tpu_torch.api import LDiffusionModel

    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    names = ["a.png", "b.png", "c_wide.png"]
    for name, (h, w) in zip(names, [(64, 64), (64, 64), (40, 56)]):
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(images / name)
    seg, ckpts = _segmentor(tmp_path)
    model = LDiffusionModel("random:tiny", "tissue", device="cpu", work_dir=str(tmp_path / "w"))
    with _cpu_profile():
        for call in range(2):
            model.inference_tissue(str(images), None, seg, 3,
                                   output_path=str(tmp_path / f"out_{call}"))
    assert sorted(os.listdir(tmp_path / "out_1")) == ["a.png", "b.png", "c_wide.png"]
    s = tracing.summary()
    count = {k: v["count"] for k, v in s["spans"].items()}
    assert count["tissue/call"] == count["tissue/predictor_build"] == 2
    assert count["tissue/read_roi"] == count["tissue/write_mask"] == 2 * len(names)
    assert count["predictor/read_checkpoint"] == count["predictor/convert"] == 2 * len(ckpts)
    assert count["predictor/nets"] == 2
    assert "tissue/wait_mask" not in count  # on the CPU a mask waits on no event
    size = sum(os.path.getsize(p) for p in ckpts)
    assert s["counters"]["predictor.checkpoint_bytes"] == {"total": 2.0 * size,
                                                           "count": 2 * len(ckpts)}
    recs = tracing.records()
    calls = [r for r in recs if r["name"] == "tissue/call"]
    assert [c["request"] for c in calls] == [0, 1]
    for c in calls:
        mine = [r for r in recs if r["request"] == c["request"]]
        assert sum(r["name"] == "tissue/read_roi" for r in mine) == len(names)
        assert all(c["start_ns"] <= r["start_ns"] <= r["end_ns"] <= c["end_ns"] for r in mine)


def test_cpu_train_step_records_its_spans_and_no_phase_counters():
    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.losses.infonce import InfoNceLoss
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        info = InfoNceLoss.create(device="cpu", num_anchors=4, num_negatives=8, num_classes=3)
    cfg = DiffusionTrainConfig(num_inference_steps=5, compute_dtype="float32", num_classes=3)
    trainer = DiffusionWarmupTrainer(SDComponents.random(seed=1, device="cpu"), cfg,
                                     info_nce=info)
    assert trainer.phase_events is None
    rng = np.random.default_rng(0)
    images = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 3, size=(1, 64, 64))
    with _cpu_profile():
        metrics = trainer.train_step(images, labels)
    assert np.isfinite(metrics["loss"])
    s = tracing.summary()
    for name in ("train_step", "train_step/inputs", "train_step/read"):
        assert s["spans"][name]["count"] == 1
    assert not any(k.startswith("train_step.") for k in s["counters"])
    step = next(r for r in tracing.records() if r["name"] == "train_step")
    assert step["parent"] is None
    assert all(r["request"] == step["request"] for r in tracing.records())


# -- the benchmark's readers ---------------------------------------------------

def _fill():
    """A registry as a window records it: two stage-1 steps and two folder
    calls of three ROIs, spans with set times, counters with set sums."""
    reg = tracing._REG
    ids = iter(range(10 ** 6))

    def span(name, start, end, parent=None, request=None):
        rec = {"name": name, "id": next(ids), "parent": parent and parent["id"],
               "request": parent["request"] if parent else request,
               "start_ns": int(start * 1e9), "end_ns": int(end * 1e9)}
        reg.spans.append(rec)
        return rec

    t = 0.0
    for step, read_s in enumerate((0.45, 0.44)):
        root = span("train_step", t, t + 0.5, request=step)
        span("train_step/inputs", t, t + 0.01, root)
        span("program/replay", t + 0.02, t + 0.04, root)
        span("train_step/read", t + 0.5 - read_s, t + 0.5, root)
        t += 1.0
    for call, build_s in enumerate((2.0, 2.2)):
        root = span("tissue/call", t, t + 6.0, request=2 + call)
        span("tissue/predictor_build", t, t + build_s, root)
        span("program/eager", t + 2.5, t + 2.8, root)
        span("program/capture", t + 3.0, t + 3.5, root)
        for roi in range(3):
            span("tissue/read_roi", t + 4 + roi, t + 4.02 + roi, root)
            w = span("tissue/write_mask", t + 4.5 + roi, t + 4.55 + roi, root)
            span("tissue/wait_mask", t + 4.5 + roi, t + 4.53 + roi, w)
        t += 10.0
    span("program/eager", t, t + 7.0, request=4)  # outside any folder call: not counted
    for name, total, n in (("train_step.forward_ms", 300.0, 2),
                           ("train_step.backward_ms", 800.0, 2),
                           ("train_step.optimizer_ms", 40.0, 2),
                           ("program.tissue_fused.replay_ms", 460.0, 2)):
        reg.counters[name] = [total, n]


READINGS = {"fwd_ms.stage1": 150.0, "bwd_ms.stage1": 400.0, "opt_ms.stage1": 20.0,
            "step_host_ms.stage1": 1e3 * (1.0 - 0.89) / 2,
            "predictor_build_s.tissue": 2.1, "program_build_s.tissue": 0.8,
            "fused_replay_ms.tissue": 230.0,
            "roi_host_ms.tissue": 1e3 * (6 * 0.02 + 6 * 0.05 - 6 * 0.03) / 6}


def test_readers_cover_the_new_metrics():
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    mine = [m for m in bench["per_layer"] if m["name"] in READINGS]
    assert sorted(m["name"] for m in mine) == sorted(READINGS)
    assert all(m["source"] == "program_counter" for m in mine)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_reader_of_the_tracer(metric):
    read = harness.reader(metric).read
    assert read(None) is None  # an empty registry
    _fill()
    assert read(None) == pytest.approx(READINGS[metric], rel=1e-6)
