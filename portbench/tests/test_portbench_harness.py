"""The harness's arguments and its lookups by name: every cell, configuration,
driver and metric reader that BENCHMARK.json names is found from its name."""
import os

import pytest

from portbench import harness, run


def bench():
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def test_arguments():
    a = run.parse_args(["--workload", "stage1-512", "--seed", str(2 ** 33 + 5),
                        "--seconds", "30", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("stage1-512", 2 ** 33 + 5, 30.0, 1)
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "stage1-512", "--seed", "1", "--seconds", "1",
                        "--trace", "2"])


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(cell):
    entry = next(w for w in bench()["workloads"] if w["name"] == cell)
    c, cfg, drv = harness.cell_files(cell)
    assert (c["config"], c["chips"], c["why"], c["traffic"]["name"]) == (
        entry["config"], entry["chips"], entry["why"], entry["traffic"])
    assert cfg["name"] == entry["config"]
    assert all(callable(getattr(drv, f))
               for f in ("setup", "window", "check", "control", "counts"))
    assert harness.counts(cell), f"no frozen counts for {cell}"


@pytest.mark.parametrize("metric", [m["name"] for k in ("end_to_end", "per_layer")
                                    for m in bench()[k]])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric).read)


def test_configs_are_their_files():
    for c in bench()["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_metrics_of_filters_by_cell():
    b = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
         "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.metrics_of(b, "x", False)] == ["a", "b"]
    assert [m["name"] for m in harness.metrics_of(b, "y", False)] == ["a"]
    assert [m["name"] for m in harness.metrics_of(b, "y", True)] == ["c"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in harness.metrics_of(b, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(b, w["name"], True)


def test_cache_dirs_inside_the_checkout(monkeypatch):
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(k, "unset")
    harness.set_cache_dirs()
    for k in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH"):
        assert os.environ[k].startswith(harness.ROOT + os.sep)


def test_process_start_precedes_now():
    import time

    assert 0 <= time.time() - harness.process_start() < 3600


def test_setup_parts_add_up_by_name():
    import torch

    r = harness.Run(cell={}, config={}, seed=0, seconds=1.0, trace=False,
                    device=torch.device("cpu"), tmp="")
    for _ in range(2):
        with harness.setup_part(r, "step"):
            pass
    with harness.setup_part(r, "copies"):
        pass
    assert list(r.setup_parts) == ["step", "copies"]
    assert all(0 <= s < 1 for s in r.setup_parts.values())
