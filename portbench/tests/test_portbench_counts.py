"""The roofline and MFU arithmetic on hand-worked shapes, FlopCounterMode's
count against a closed form, and the frozen counts of every cell."""
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness
from portbench.tests import tiny
from portbench.reference import counts, models, peaks


def test_attention_bound_forward_and_backward():
    # (B, S, S, H, D) = (1, 4096, 4096, 8, 40): PERF.md's K5 and K6 rows
    f = counts.attention_bound(1, 4096, 4096, 8, 40, backward=False, lse=True)
    assert f["ops"] == 4 * 8 * 4096 * 4096 * 40
    assert f["bytes"] == 2 * 8 * 40 * 4 * 4096 + 4 * 8 * 4096
    assert f["bound_s"] == pytest.approx(f["ops"] / 989e12)
    assert f["bound_s"] * 1e3 == pytest.approx(0.0217, abs=5e-5)
    b = counts.attention_bound(1, 4096, 4096, 8, 40, backward=True, lse=True)
    assert b["ops"] == 10 * 8 * 4096 * 4096 * 40
    assert b["bound_s"] * 1e3 == pytest.approx(0.0543, abs=5e-5)
    # a short call is bytes-bound
    s = counts.attention_bound(1, 64, 64, 1, 512, backward=False, lse=False)
    assert s["bound_s"] == pytest.approx(s["bytes"] / peaks.HBM_BYTES)


def test_groupnorm_bound_reads_and_writes_once():
    g = counts.groupnorm_bound((1, 1280, 16, 16))
    assert g["bytes"] == 2 * (2 * 1280 * 16 * 16 + 2 * 1280)
    assert g["bound_s"] * 1e3 == pytest.approx(0.0004, abs=1e-4)


def test_flop_counter_on_a_tiny_dynunet_matches_the_closed_form():
    plan = {"features_per_stage": [4, 8], "strides": [1, 2], "n_conv_per_stage": 1,
            "in_channels": 3, "num_classes": 3}
    with torch.device("meta"):
        net = models.DynUNet(plan)
        x = torch.zeros(1, 3, 16, 16)
    with FlopCounterMode(display=False) as c:
        net(x)
    closed = (2 * 9 * 3 * 4 * 16 * 16        # enc_0_0
              + 2 * 9 * 4 * 8 * 8 * 8        # enc_1_0, stride 2
              + 2 * 8 * 4 * 2 * 2 * 8 * 8    # up_0: transpose conv, kernel 2, from 8²
              + 2 * 9 * 8 * 4 * 16 * 16      # dec_0_0 over the concatenation
              + 2 * 4 * 3 * 16 * 16)         # seg_0
    assert c.get_total_flops() == closed


def _run(**kw):
    base = dict(cell={"name": "x"}, config={}, seed=0, seconds=1.0, trace=True,
                device=torch.device("cpu"), tmp="")
    base.update(kw)
    return harness.Run(**base)


def test_mfu_and_roofline_readers_on_hand_worked_numbers():
    summary = {"window_s": 2.0, "busy_s": 1.5,
               "kernel_s": {"void flash_fwd_wgmma<1>": 0.010, "flash_bwd_prep": 0.002,
                            "gn_resident<bf16>": 0.004, "cudnn_conv": 1.0}}
    run = _run(summary=summary, window={"steps": 3, "rois": 4},
               counts={"flops_per_step": 98.9e12, "flops_per_roi": 49.45e12,
                       "attention": {"bound_s_per_step": 0.002},
                       "groupnorm": {"bound_s_per_roi": 0.0005}})
    # 3 steps of 98.9 TFLOP in 2 s at 989 TFLOP/s: 15%
    assert harness.reader("mfu.stage1").read(run) == pytest.approx(15.0)
    assert harness.reader("mfu.tissue").read(run) == pytest.approx(10.0)
    # 3 × 2 ms of bound over 12 ms of the attention family
    assert harness.reader("attn_roofline.stage1").read(run) == pytest.approx(50.0)
    assert harness.reader("gn_roofline.tissue").read(run) == pytest.approx(50.0)
    assert harness.reader("idle.stage1").read(run) == pytest.approx(25.0)
    # no trace, or nothing of the family: nothing to read
    assert harness.reader("mfu.stage1").read(_run(window={"steps": 3})) is None
    summary["kernel_s"] = {"cudnn_conv": 1.0}
    assert harness.reader("attn_roofline.stage1").read(run) is None


def test_rates_and_counters():
    run = _run(window={"steps": 10, "batch": 8, "seconds": 4.0, "rois": 32,
                       "program_calls": 32, "replays": 30, "network_forwards": 640},
               setup_s=12.5, peak_bytes=3 * 2 ** 30)
    assert harness.reader("stage1_img_per_s").read(run) == 20.0
    assert harness.reader("tissue_roi_per_s").read(run) == 8.0
    assert harness.reader("replayed_share.tissue").read(run) == pytest.approx(93.75)
    assert harness.reader("seg_forwards_per_roi").read(run) == 20.0
    assert harness.reader("setup_s").read(run) == 12.5
    assert harness.reader("peak_mem_gib").read(run) == 3.0


def test_frozen_counts():
    c = harness.counts("stage1-512")
    assert c["attention"]["forward_calls"] == 133  # 6 × 10 UNet, remat twice, 13 VAE
    assert c["attention"]["backward_calls"] == 60
    assert c["flops_per_step"] > 4e13
    t = harness.counts("tissue-folder-5fold")
    assert t["groupnorm"]["calls_per_roi"] == 113
    assert t["network_forwards_per_roi"] == 20
    b8 = harness.counts("stage1-64-b8")
    assert b8["attention"]["forward_calls"] == 0 and b8["flops_per_step"] > 0


def test_each_driver_counts_its_cell_with_the_shared_arithmetic():
    cell, cfg = tiny.stage1_cell()  # 32² images: no attention reaches 512 keys
    c = harness.driver(cell["driver"]).counts(cell, cfg)
    assert c["flops_per_step"] > 0 and c["attention"]["forward_calls"] == 0
    assert c["shapes"] == {"batch": 1, "image": [32, 32], "labels": [64, 64]}
    cell, cfg = tiny.tissue_cell()
    t = harness.driver(cell["driver"]).counts(cell, cfg)
    assert t["network_forwards_per_roi"] == 2 * 4  # 2 folds × 4 mirrors
    g = t["groupnorm"]
    assert g["calls_per_roi"] > 0
    assert g["bound_s_per_roi"] == pytest.approx(g["bytes_per_roi"] / peaks.HBM_BYTES)
