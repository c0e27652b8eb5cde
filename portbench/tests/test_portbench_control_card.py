"""The control on the card, at a size a test run holds: the reference with
its products in float8 in the program's place must read at least three
times what sound runs of the program read, on one of a cell's numbers.
At the cells' own sizes the same readings come from ``portbench.control``
(PERF.md lists them and the limits set from them). Skips without a card,
deciding inside the test."""
import pytest
import torch

from portbench import control, harness
from portbench.tests import tiny

SEEDS = (101, 102, 103)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _separates(cell, cfg, device):
    drv = harness.driver(cell["driver"])
    prog = [control.program_reading(cell, cfg, drv, s, device) for s in SEEDS]
    low = [control.control_reading(cell, cfg, drv, s, device) for s in SEEDS]
    numbers = [k for k, v in prog[0].items() if isinstance(v, float)]
    return {k: min(r[k] for r in low) / max(r[k] for r in prog) for k in numbers}


@pytest.mark.gpu
def test_stage1_control_is_caught():
    device = _card()
    cell, cfg = tiny.stage1_cell(batch=2)
    cfg["train"]["compute_dtype"] = "bfloat16"
    cell["traffic"].update(image_size=64, checked_steps=3)
    ratios = _separates(cell, cfg, device)
    assert max(ratios.values()) >= 3.0, ratios


@pytest.mark.gpu
def test_tissue_control_is_caught():
    device = _card()
    cell, cfg = tiny.tissue_cell()
    cfg["dtype"] = "bfloat16"
    ratios = _separates(cell, cfg, device)
    assert max(ratios.values()) >= 3.0, ratios
