"""What the benchmark loads: nothing whose top-level name is JAX's, jaxlib's,
flax's or the JAX package's (``ldiffusion_tpu``, compared whole: the port,
``ldiffusion_tpu_torch``, begins with it), and a reference that loads
nothing of the program."""
import json
import os
import subprocess
import sys

from portbench import harness

REFERENCE = ["portbench.reference." + f[:-3] for f in sorted(os.listdir(
    os.path.join(harness.PKG, "reference"))) if f.endswith(".py") and f != "__init__.py"]


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": harness.ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ldiffusion_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxfake.x", sys)
    assert not any(m.startswith(("ldiffusion_tpu_torch_fake", "jaxfake"))
                   for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "ldiffusion_tpu.api", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"ldiffusion_tpu.api", "jax.numpy"} <= set(harness.forbidden_modules())


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("\n".join(f"import {m}" for m in REFERENCE))
    tops = {m.split(".")[0] for m in loaded}
    assert not tops & {"ldiffusion_tpu_torch", "ldiffusion_tpu", "jax", "jaxlib", "flax"}


RUN_EVERY_DRIVER = """
import tempfile, torch
torch.set_num_threads(2)
from portbench import harness
from portbench.tests import tiny
for make in (tiny.stage1_cell, lambda: tiny.tissue_cell({"mask_gap": 0.5})):
    cell, cfg = make()
    with tempfile.TemporaryDirectory() as d:
        tiny.run_tiny(cell, cfg, d)
import portbench.run, portbench.control
for k in ("end_to_end", "per_layer"):
    for m in harness.load_json(harness.ROOT, "BENCHMARK.json")[k]:
        harness.reader(m["name"])
"""


def test_a_run_of_every_driver_loads_no_jax():
    tops = {m.split(".")[0] for m in _loaded_after(RUN_EVERY_DRIVER)}
    assert "ldiffusion_tpu_torch" in tops  # the program ran
    assert not tops & {"ldiffusion_tpu", "jax", "jaxlib", "flax"}
