"""Tiny CPU runs of each driver through the harness (set-up, a window of
two steps or calls, the check against the reference), and the same runs
with the timed path broken underneath: each fault the cell can have must
make ``correct`` false. The harness's look for a card is skipped; the
program computes in float32 here, except the predictor's DynUNet, which
always runs in bf16."""
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

# the tiny tissue cell's DynUNet is bf16 against a float32 reference: its
# mean gap reads ~1e-4 of the logits' spread
TISSUE_LIMITS = {"mask_gap": 0.01}


@pytest.fixture(autouse=True)
def few_threads():
    kept = torch.get_num_threads()
    torch.set_num_threads(min(kept, 4))
    yield
    torch.set_num_threads(kept)


def faulted(cell, cfg, tmp, fault):
    with harness.driver(cell["driver"]).FAULTS[fault]():
        return tiny.run_tiny(cell, cfg, tmp)


def test_stage1_tiny_run_is_correct(tmp_path):
    cell, cfg = tiny.stage1_cell()
    r = tiny.run_tiny(cell, cfg, tmp_path, seconds=0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 1 and r["failed"] == 0
    assert list(r["checks"]) == list(cell["limits"])


def test_stage1_state_unchanged_fails(tmp_path):
    cell, cfg = tiny.stage1_cell()
    r = faulted(cell, cfg, tmp_path, "state_unchanged")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert r["checks"]["grad_err"]["value"] == pytest.approx(1.0)


def test_stage1_half_batch_fails(tmp_path):
    cell, cfg = tiny.stage1_cell(batch=2)
    assert tiny.run_tiny(cell, cfg, tmp_path / "sound")["correct"]
    r = faulted(cell, cfg, tmp_path / "fault", "half_batch")
    assert not r["correct"]
    assert r["checks"]["grad_err"]["value"] > cell["limits"]["grad_err"]


def test_tissue_tiny_run_is_correct(tmp_path):
    cell, cfg = tiny.tissue_cell(TISSUE_LIMITS)
    r = tiny.run_tiny(cell, cfg, tmp_path)
    assert r["correct"], r["checks"]
    assert r["attempted"] == 3 and r["failed"] == 0


def test_tissue_answer_altered_fails(tmp_path):
    cell, cfg = tiny.tissue_cell(TISSUE_LIMITS)
    r = faulted(cell, cfg, tmp_path, "answer_altered")
    assert not r["correct"], r["checks"]


def test_missing_mask_fails(tmp_path, monkeypatch):
    """A ROI whose mask never comes is failed, and not correct."""
    from PIL import Image

    cell, cfg = tiny.tissue_cell(TISSUE_LIMITS)
    kept = Image.Image.save

    def save(self, fp, *a, **kw):
        if str(fp).endswith("roi_001.png") and "out_0" in str(fp):
            return None
        return kept(self, fp, *a, **kw)

    monkeypatch.setattr(Image.Image, "save", save)
    r = tiny.run_tiny(cell, cfg, tmp_path)
    assert not r["correct"] and r["failed"] == 1
