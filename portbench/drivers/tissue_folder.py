"""Folder inference traffic: ``LDiffusionModel.inference_tissue(folder, None,
<segmentor dir>, classes, output_path=...)`` back to back, the folder mode
of the API's tissue inference. Each call pays what a user's call pays: the
predictor rebuilt from the fold checkpoints, the fused program's eager
first use and capture, then replays; each writes one mask PNG a ROI.

Traffic parameters: ``rois`` (distinct seeded ROIs in the folder, written
as uncompressed TIFF, PUMA's format), ``roi_size``, ``warmup_rois`` (the
folder set-up's one call takes: eager, capture and replay), and
``checked_rois`` (how many ROIs, drawn from the seed, the check compares).

Set-up makes the SD weights (in the configuration's dtype) and one seeded
DynUNet a fold, written as ``fold_k/checkpoint_final.pkl`` beside
``plans.json``, and the ROIs; every window call writes to a directory of
its own. The check frees the program, runs the reference on the checked
ROIs, and takes the widest gap by which a mask's class lies below the
reference's best logit, averaged over a mask's pixels, worst over every
call's mask of those ROIs.
"""
from __future__ import annotations

import contextlib
import gc
import os
import pickle
import time

import numpy as np
import torch
from PIL import Image

from portbench import data, program, weights
from portbench.harness import setup_part, span
from portbench.reference import counts as arithmetic
from portbench.reference import models
from portbench.reference.tissue import Tissue, gaps

def fold_states(run) -> list:
    """One seeded DynUNet state dict a fold (float32), from the fold's seed."""
    with torch.device("meta"):
        net = models.DynUNet(run.config["plan"])
    out = []
    for k in range(run.config["folds"]):
        gen = torch.Generator(device=run.device).manual_seed(
            weights.sub_seed(run.seed, weights.FOLD + k))
        out.append(weights.seeded_state(net, gen, run.device))
    return out


def rois(run) -> np.ndarray:
    t = run.cell["traffic"]
    gen = torch.Generator(device=run.device).manual_seed(
        weights.sub_seed(run.seed, weights.INPUTS))
    return data.tissue_rois(t["rois"], t["roi_size"], gen, run.device).cpu().numpy()


def _plan(cfg):
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan

    p = cfg["plan"]
    return SegPlan(patch_size=tuple(p["patch_size"]), batch_size=p["batch_size"],
                   features_per_stage=tuple(p["features_per_stage"]), strides=tuple(p["strides"]),
                   n_conv_per_stage=p["n_conv_per_stage"], num_classes=p["num_classes"],
                   in_channels=p["in_channels"], normalization=p["normalization"],
                   intensity_properties={}, median_shape=tuple(p["patch_size"]),
                   batch_dice=True, deep_supervision=p["deep_supervision"],
                   block_type=p["block_type"])


def write_segmentor(run, root: str) -> str:
    """plans.json and fold_k/checkpoint_final.pkl (the trainers' pickle of
    flax-layout parameters) of the seeded folds."""
    from ldiffusion_tpu_torch.models.convert import dynunet_to_flax

    plan = _plan(run.config)
    plan.save(os.path.join(root, "plans.json"))
    for k, sd in enumerate(fold_states(run)):
        os.makedirs(os.path.join(root, f"fold_{k}"))
        host = {name: t.cpu() for name, t in sd.items()}
        with open(os.path.join(root, f"fold_{k}", "checkpoint_final.pkl"), "wb") as f:
            pickle.dump({"params": dynunet_to_flax(host, plan.network_config()),
                         "plan": plan.to_json()}, f, protocol=4)
    return root


@contextlib.contextmanager
def predictor_span():
    """The benchmark's span around each predictor build inside a call."""
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor

    built = SlidingWindowPredictor.__dict__["from_checkpoints"]

    def from_checkpoints(cls, *args, **kwargs):
        with span("predictor_build"):
            return built.__func__(cls, *args, **kwargs)

    SlidingWindowPredictor.from_checkpoints = classmethod(from_checkpoints)
    try:
        yield
    finally:
        SlidingWindowPredictor.from_checkpoints = built


def setup(run):
    from ldiffusion_tpu_torch.api import LDiffusionModel

    cfg, t = run.config, run.cell["traffic"]
    with setup_part(run, "weights"):
        states = program.sd_states(cfg, run.seed, run.device, getattr(torch, cfg["dtype"]))
        comps = program.program_components(cfg, states, run.device)
        del states
    with setup_part(run, "segmentor"):
        seg = write_segmentor(run, os.path.join(run.tmp, "segmentor"))
    with setup_part(run, "rois"):
        images = rois(run)
        folder, warm = os.path.join(run.tmp, "rois"), os.path.join(run.tmp, "warm")
        os.makedirs(folder)
        os.makedirs(warm)
        names = [f"roi_{i:03d}.tif" for i in range(len(images))]
        for i, (name, img) in enumerate(zip(names, images)):
            Image.fromarray(img).save(os.path.join(folder, name))
            if i < t["warmup_rois"]:
                os.link(os.path.join(folder, name), os.path.join(warm, name))
    with setup_part(run, "model"):
        # a name that is not random: the 1024² ROI size rule, as for a user's checkpoint
        path = "sd15-seeded" if t["roi_size"] == 1024 else "random:seeded"
        model = LDiffusionModel(path, "tissue", components=comps, device=run.device,
                                work_dir=os.path.join(run.tmp, "work"))
    state = {"model": model, "seg": seg, "folder": folder, "names": names, "calls": []}
    with setup_part(run, "warm_call"), predictor_span():
        _call(run, state, warm, os.path.join(run.tmp, "out_warm"))
    state["calls"] = []
    return state


def _call(run, state, folder, out):
    with span("folder_call"):
        state["model"].inference_tissue(folder, None, state["seg"],
                                        run.config["plan"]["num_classes"], output_path=out)
    fused = state["model"].tissue_programs["fused"]
    progs = list(fused.values())
    predictor = progs[0].counted[0][0]
    state["calls"].append({"out": out, "program_calls": sum(p.calls for p in progs),
                           "replays": sum(p.replays for p in progs),
                           "network_forwards": predictor.network_forwards})


def window(run, state, seconds):
    t0 = time.perf_counter()
    with predictor_span():
        while True:
            _call(run, state, state["folder"], os.path.join(run.tmp, f"out_{len(state['calls'])}"))
            if time.perf_counter() - t0 >= seconds:
                break
    if run.device.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    n = len(state["names"])
    written = sum(os.path.exists(os.path.join(c["out"], os.path.splitext(f)[0] + ".png"))
                  for c in state["calls"] for f in state["names"])
    calls = state["calls"]
    return {"calls": len(calls), "rois": written, "seconds": elapsed,
            "attempted": n * len(calls), "failed": n * len(calls) - written,
            "program_calls": sum(c["program_calls"] for c in calls),
            "replays": sum(c["replays"] for c in calls),
            "network_forwards": sum(c["network_forwards"] for c in calls)}


def reference_logits(run, picked, prec=None):
    """The reference's logits of each picked ROI (a generator of (index, logits))."""
    images = rois(run)
    states = program.sd_states(run.config, run.seed, run.device,
                               getattr(torch, run.config["dtype"]))
    ref = Tissue(run.config, states, fold_states(run), run.device, prec)
    del states
    with models.reference_math():
        for i in picked:
            yield i, ref.logits(ref.transform(torch.from_numpy(images[i:i + 1]))[0])


def _picked(run):
    n, k = run.cell["traffic"]["rois"], run.cell["traffic"]["checked_rois"]
    return sorted(np.random.default_rng(run.seed).choice(n, k, replace=False))


def readings(run, state) -> dict:
    """Every window call's mask of each checked ROI against the reference's
    logits (``reference.tissue.gaps``): the worst mask's mean gap, widest
    gap and share of pixels off the argmax. A mask that is missing or of the
    wrong shape reads infinite."""
    del state["model"]
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    worst = {"mask_gap": 0.0, "mask_widest_gap": 0.0, "mask_off_share": 0.0}
    for i, logits in reference_logits(run, _picked(run)):
        png = os.path.splitext(state["names"][i])[0] + ".png"
        for c in state["calls"]:
            path = os.path.join(c["out"], png)
            mask = None
            if os.path.exists(path):
                with Image.open(path) as m:
                    mask = np.array(m)
            if mask is None or mask.shape != tuple(logits.shape[1:]):
                worst = {k: float("inf") for k in worst}
                continue
            g = gaps(logits, mask)
            for k, key in (("mask_gap", "mean"), ("mask_widest_gap", "widest"),
                           ("mask_off_share", "share")):
                worst[k] = max(worst[k], g[key])
    return worst


def check(run, state):
    """The readings the cell compares: those its ``limits`` name."""
    r = readings(run, state)
    return {k: (r[k], limit) for k, limit in run.cell["limits"].items()}


def control(run) -> dict:
    """The control's readings: the argmax of the reference with its products
    in float8, in the program's place, against the float32 reference."""
    picked = _picked(run)
    low = dict(reference_logits(run, picked, models.Precision(fp8=True)))
    worst = {"mask_gap": 0.0, "mask_widest_gap": 0.0, "mask_off_share": 0.0}
    for i, logits in reference_logits(run, picked):
        g = gaps(logits, low[i].argmax(dim=0))
        for k, key in (("mask_gap", "mean"), ("mask_widest_gap", "widest"),
                       ("mask_off_share", "share")):
            worst[k] = max(worst[k], g[key])
    return worst


def counts(cell, cfg) -> dict:
    """One ROI's FLOPs (the transform and the DynUNet forwards of every fold
    and mirror) and its transform's GroupNorm calls (``reference.counts``)."""
    dev = torch.device("meta")
    state = {k: m.state_dict() for k, m in program.reference_modules(cfg).items()}
    with dev:
        folds = [models.DynUNet(cfg["plan"]).state_dict() for _ in range(cfg["folds"])]
        roi = torch.zeros(1, cfg["roi_size"], cfg["roi_size"], 3, dtype=torch.uint8)
    ref = Tissue(cfg, state, folds, dev)
    gn = []

    def one_roi():
        with models.recording() as calls:
            t = ref.transform(roi)
            gn.extend(calls["groupnorm"])
        ref.logits(t[0])

    flops = arithmetic.flops(one_roi)
    bounds = [arithmetic.groupnorm_bound(s) for s in gn]
    return {"flops_per_roi": flops,
            "network_forwards_per_roi": len(ref.flips) * len(ref.nets),
            "groupnorm": {"calls_per_roi": len(gn),
                          "bytes_per_roi": sum(b["bytes"] for b in bounds),
                          "bound_s_per_roi": sum(b["bound_s"] for b in bounds)},
            "shapes": {"roi": [cfg["roi_size"]] * 2, "folds": cfg["folds"]}}


@contextlib.contextmanager
def answer_altered():
    """Fault: the mask's top-left sixteenth takes the next class where it is made."""
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor

    kept = SlidingWindowPredictor._to_seg

    def _to_seg(self, logits):
        seg = kept(self, logits)
        h, w = seg.shape[0] // 4, seg.shape[1] // 4
        altered = seg.clone()
        altered[:h, :w] = (seg[:h, :w] + 1) % logits.shape[0]
        return altered

    SlidingWindowPredictor._to_seg = _to_seg
    try:
        yield
    finally:
        SlidingWindowPredictor._to_seg = kept


FAULTS = {"answer_altered": answer_altered}
