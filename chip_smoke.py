#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's tissue inference, stage-1 training,
stage-2 segmentor training, the cell level, the 2D segmentor command line,
its workflow after training, its volumetric (3D) pathway, the generation
tail, the int8 W8A8 inference modes and distribution on one NVIDIA GPU.

    python3 chip_smoke.py                    # every phase, one card
    python3 chip_smoke.py --phases kernels   # only the kernel checks
    python3 chip_smoke.py --phases train     # only the training checks

Phases, in order (any failure exits non-zero; nothing is caught):
  1. build:   compile ldiffusion_tpu_torch/csrc/*.cu with nvcc (sm_90a), one
              nvcc per source, in parallel; count the HGMMA and UTMALDG
              instructions in the SASS of the wgmma forward and backward
              (cuobjdump); none fails.
  2. kernels: every kernel at every distinct shape of its path (inference at
              1024², training at 512²), held against its plain PyTorch version
              in bf16 (plus f32 and ragged cases), timed beside the plain
              version and one library call (each window at least 50 ms of
              device work); the forward and backward rows name the route
              they took and time the mma.sync kernels (the previous design)
              on the same inputs; the flash forward with logsumexp also at
              tools/bench_attn_exp2.py's three shapes; the inference kernels
              also at the generation tail's shapes, at bench.py's batch-8
              program's (the quant phase's (d)) and at the 1024² ROI's
              shapes at batch 2 (the dataset build's
              DiffusionTransform(batch_size=2)). GroupNorm rows take
              the route gn_route names, repeat bitwise, hold the other route
              (and the resident route at other slice widths) to the same
              tolerance and time it, and time the first GroupNorm kernel
              (csrc/groupnorm.cu, "v1"). The GroupNorm backward at stage
              1's maps (GN_BWD_SHAPES): dx, dscale and dbias against the
              closed form, the route gn_route names, two calls bitwise,
              timed in a CUDA graph beside the other route where it takes
              the shape, the autograd route it replaced, the closed form and
              autograd through F.group_norm + F.silu.
  3. tiny:    the whole ``inference_tissue`` at the tiny configs on a 64² ROI,
              once on cuda with the kernels (f32, TF32 off) and once on the
              CPU with the plain versions, same weights; compared.
  4. full:    SD-v1.5-width bf16 components from seeded random weights, a
              segmentor directory at the 1024²/7-class plan written in the JAX
              layout, then ``LDiffusionModel.inference_tissue`` on one 1024²
              ROI (one eager run of the fused program) and in folder mode on
              8 square ROIs + 1 non-square ROI (the fused program eager, then
              captured as a CUDA graph and replayed, 3 images in flight; the
              non-square ROI through the predictor's bucket). Launch counters
              are reset just before and read just after, replays counted
              (core/graphs.py); every forward launch there took the wgmma
              route, every GroupNorm launch the route gn_route names for its
              shape; the folder launched 8 times the single ROI's kernels.
              Every folder mask is bit-equal to the eager route on its ROI
              (the fused program's function called directly; a fresh
              predictor's first use), the decoded image and mask of a
              transform-keeping program's two replays to its eager first
              use, and a capture that would grow the GroupNorm workspace
              raises, and so does a training program's (a draw from a
              registered generator, backward, an update) whose capture
              would. Figures (``full`` line): single and folder s/ROI,
              programs, graphs captured, replays and capture seconds, one
              profiled folder run's idle share, the allocated and reserved
              peaks, launches per ROI.
  5. train:   one stage-1 step at the tiny configs in f32 on cuda against the
              same step on the CPU (same weights, noise, contrastive indices);
              then SD-v1.5 width, bf16 compute over f32 masters, batch 1, 25
              inference steps (6 timesteps), remat: (a) 64² images through
              ``LDiffusionModel.train(component="ldiffusion")`` on synthetic
              PNG pairs, 3 steps, and the saved UNet read back by
              ``inference_tissue``; (b) 512² images with 64² labels through
              ``DiffusionWarmupTrainer``, 5 steps. Each step is one program
              (core/graphs.py): the first eager, the second captured as a
              CUDA graph, the rest replays. Counters are reset before (a)
              and read after (b), replays counted, every bf16 forward and
              backward launch on the wgmma route, every GroupNorm launch on
              its gn_route route, each replayed 512² step launching what the
              eager one did (K6: K6_PER_STEP_512; the GroupNorm backward:
              GN_BWD_PER_STEP_512); one 512² replay profiled.
              Then (c) at 64² and SD-v1.5 width, TRAIN_ROUTE_STEPS steps
              through ``train_step`` against as many ``step_fn`` calls (the
              eager route) from the same weights and generator seed: losses,
              gradient norms, masters and AdamW moments bit-equal or within
              twice the difference between two eager runs (printed beside
              them); one 64² replay profiled. Figures (``train_*`` lines):
              the eager, captured and replayed s/step, capture s, the
              allocated and reserved peaks, the profiled replays' idle
              share.
  6. seg:     one stage-2 step at a tiny plan in f32 on cuda against the same
              step on the CPU (same weights and patches, DA off), and the
              device DA stack on both with the same drawn parameters; then
              SD-v1.5-width bf16 components from seeded random weights, their
              UNet written by save_unet_dir, 6 synthetic 1024² ROI/label
              pairs, and ``LDiffusionModel.train(component="segmentor")``:
              the dataset build through the one-step transform (counters
              reset before, read after: every forward launch on wgmma, every
              GroupNorm launch on its gn_route route), the 1024²/7-class plan,
              2 epochs × 4 iterations in bf16 (every crop and spatial
              resample on the native route; the train and validation steps
              programs: eager, captured, then replayed through the epoch
              loop), validation; the written segmentor read back by
              ``inference_tissue``. Then SEG_ROUTE_STEPS train steps and 2
              validation steps at that plan replayed against the step
              functions called eagerly from the same parameters, momentum
              and generator state (bit-equal or within twice the eager
              spread); one replayed iteration profiled. The dataset build
              runs one DiffusionTransform program (first ROI eager, second
              captured, the rest replayed); then a DiffusionTransform on 3 of
              its ROIs, bit-equal to one_step_transform called eagerly on
              each, and one of batch 2 (a full and a zero-padded chunk,
              twice: 17 flash and 113 GroupNorm launches a chunk),
              bit-equal to the eager batch-2 route, its rows within
              SEG_BATCH2_MAX_ABS of batch 1's (``transform_check``).
  7. cell:    11 classes. SD-v1.5-width bf16 components from seeded random
              weights written as a diffusers-layout safetensors directory
              (own writer, tokenizer files), read back by
              ``LDiffusionModel(<dir>, "cell")`` without ``components=``: its
              one-step transform of a 1024² ROI equals the in-memory bundle's
              bit for bit (the text projection carried over). Then
              ``train(component="segmentor")`` on 6 synthetic 1024² nuclei
              ROIs (2 epochs; ResNet-152) and ``inference`` on a square and a
              non-square ROI (counters reset before the training, read after
              the inference: every forward on wgmma, every GroupNorm on its
              gn_route route); one inference profiled. Then the ResNet-152
              classifier on an untransformed ROI of >= 300 instances, classes
              on the card (TF32 off) against the CPU (>= 99% equal), timed
              with TF32 as shipped on a classifier of its own (a program
              keeps its capture's TF32 setting); the cell path's transforms
              count 17 flash and 113 GroupNorm launches a ROI through
              replays, and the head step replayed. Then the programs
              (``programs`` on the ``cell`` line): follow_flows by method
              and _device_propose of the "transformed" flow proposer at the
              1024² crowded ROI and classify_rois at the PUMA-density ROI's
              bucket, each used 5 times (the first use, the capture, 3
              replays; programs, replays, capture s, first-use, eager and
              replayed s; every replay bit-equal to the first use);
              cache_features of two ROIs of one bucket, twice (each entry
              bit-equal to its ROI's eager features, the entries distinct);
              CELL_STEPS head steps on those features and flow-net steps
              (features 32-64-128, batch 4, 64² scenes) through their
              programs against the step functions called eagerly (cuDNN
              deterministic; bit-equal or within twice the eager spread).
              Last, the flow proposer at 1024², card against CPU (PQ >=
              0.99).
  8. cli:     the pieces the segmentor CLI adds, tiny and f32 on cuda against
              the CPU (a BatchNorm ResEnc DynUNet's forward, backward and
              running statistics, Adan, the regions loss, DA5 with fixed
              draws; 1e-4). Then 6 + 2 synthetic 1024² PUMA pairs through
              the one-step transform of seeded random SD-v1.5-width bf16
              components (``build_transformed_dataset``; counters reset
              before, read after: 17 flash-forward and 113 GroupNorm launches
              a ROI, on wgmma and their gn_route routes), as two datasets:
              Dataset001 the 7 labels with ``"ignore": 7`` on a band,
              Dataset002 nested regions. Run A (Dataset001, the 1024²/7-class
              plan, nnUNetTrainerDA5) through ``python -m
              ldiffusion_tpu_torch.segmentor`` processes: plan_and_preprocess
              --verify_dataset_integrity, train --epochs 2 --iters 4 --npz,
              predict --save_probabilities, evaluate_folder -djfile. Runs B
              (Dataset002, nnUNetPlannerResEncM: 512², batch 2, ResEnc-M,
              nnUNetTrainerAdanCosAnneal) and C (Dataset001, nnUNetTrainerBN:
              train, train --val, predict -chk, determine/apply
              postprocessing) through ``cli.main`` in this process with
              cuDNN's TF32 as shipped. Gates: every command, the native crop
              and resample only, the ResEnc-M parameter count, run C's moved
              batch_stats, the npz probabilities, run C's f32 masks card vs
              CPU (>= 99.5%). Figures (``cli`` line): each command's wall
              seconds, s/iteration, peak memory, host ms a batch, validation
              s/case, predict s/ROI (from each run's ``timing`` log lines),
              DA5 device ms a batch, and one profiled iteration of A and B
              (a replay of the step's program, after the eager and the
              captured iteration; the runs' iterations replay too).
  9. workflow: the nnU-Net workflow after training, on run A (Dataset001,
              the 1024²/7-class plan, nnUNetTrainerDA5; the cli phase's
              datasets, plans, fold 0 and fold-0 predictions when it ran in
              this invocation, else built here the same way). As user
              processes: train -f 1 (one epoch); through cli.main,
              find_best_configuration -c 2d (each fold predicts its own
              validation cases on the card); as processes,
              predict_from_modelfolder -f 0 1 -chk checkpoint_final.pkl
              --save_probabilities and predict with the same folds, side by
              side (masks bit-equal). Through cli.main in this process:
              accumulate_crossval_results (cases = both folds', finite Dice),
              ensemble of both folds with fold 0 alone (masks = the argmax of
              the mean of the two npz payloads, the npz = that mean) and of
              run B's region predictions (-d 2, painted by the label
              manager), export_model of the final checkpoints (in a thread,
              beside the two predict processes) / install_model /
              download_model file:// (the installed and downloaded files =
              the zip's names), plot_overlays, move_plans,
              convert_msd and convert_old_dataset on small generated inputs;
              predict_from_modelfolder of the installed model, profiled, with
              cuDNN's TF32 as users have it (masks bit-equal to the user
              process's); train -f 1 --epochs 2 --c (the resume from epoch
              1, the loaded momentum bit-equal to the checkpoint's). Also the
              device-side rotation + scaling of augment_batch on the card
              against the CPU from the same draws (data 1e-4, labels >=
              99.5%). Figures
              (``{"workflow": ...}`` line): each command's wall seconds, CV
              prediction s a case, find_best s, predict_from_modelfolder
              s/ROI, ensemble s a case, export/install/download s and the
              zip's bytes, the spatial DA's device ms, the profiled call's
              idle share.
 10. vol:     the volumetric pathway at the planner's full 3D width. First
              the 3D pieces tiny and f32 on cuda against the CPU (one trainer
              step of a cascade-width plan, the volumes' device DA with the
              same draws, the 3D sliding window's logits; SEG_TINY_TOL, 1e-4).
              Then 4 + 1 seeded 160x256x256 float32 volumes at spacing
              (2.5, 0.8, 0.8) as a .npy dataset: plan_and_preprocess
              through cli.main (all three 3D configurations: 3d_fullres
              (80,128,128) batch 2, 32-320 features; 3d_lowres (112,96,96);
              the cascade), then ``python -m ldiffusion_tpu_torch.segmentor``
              processes: train -c
              3d_lowres, 3d_cascade_fullres (the fullres plan with 1 + 2
              input channels, fed by the lowres stage; one epoch of
              VOL_ITERS iterations each), predict -c 3d_cascade_fullres on
              the test volume (the fullres net predicts in its own
              validation), evaluate_folder on the cascade's fold-0
              validation (through cli.main). Gates: the
              plans, every 3D crop and resample native, finite losses, masks
              of the input's shape with labels in {0, 1, 2}, the cascade's
              cache and its log lines. Figures (``vol`` line): s/iteration,
              peak memory, host ms a batch and validation s/case of each
              configuration (the trainers' ``timing`` lines), predict seconds
              a volume by step and network forwards (the ``timing predict``
              line), and one profiled window of fullres iterations (device
              idle share; none of the port's own kernels runs there).
 11. gen:     the generation tail. First tiny and f32 on cuda (TF32 off)
              against the CPU, the same weights and draws: 5-step DDIM and
              LMS loops over the tiny UNet, ``multimodal_augment`` with a
              tiny ControlNet whose zero convolutions are drawn non-zero,
              both conductor nets in eval mode (GEN_TINY_TOL). Then, counters
              reset before and read after (the tools' processes report
              theirs; the two tools run side by side):
              ``python -m ldiffusion_tpu_torch.tools.sample`` on an
              SD-v1.5-width diffusers directory (the cell phase's when it ran
              in this invocation, else written the same way), one 512² image,
              5 PLMS steps, 6 PNGs; ``python -m
              ldiffusion_tpu_torch.tools.pixel_latent_vector`` on the same
              directory and 2 synthetic 1024² PUMA pairs, 25 inference steps
              (6 timesteps), 2 x 4096 CSV rows; ``multimodal_augment`` of 4
              synthetic 256² RGB/DTM/mask triplets read by
              ``RgbDtmMaskDataset``, one bf16 batch, seeded random SD-v1.5
              components and an SD-width ControlNet (conditioning 16-32-96-
              256). Every forward launch on wgmma, every GroupNorm launch on
              its gn_route route. Then TissueSegNet (ConvNeXt-Tiny 96-768, 7
              classes) on a 1024² ROI, TissueSegWithDepthHeatmap on the
              augmented batch with its DTMs and CombinedLoss on the result,
              eval mode, cuDNN's TF32 as shipped. Figures (``{"gen": ...}``
              line): each command's wall, s a sampling step (the PNGs' write
              times), the augment's s a batch and peak memory, one profiled
              augment call's device busy ms and idle share, the conductor ms.
 12. quant:   the int8 W8A8 modes (ops/quant.py, QConv / QDense). (a) The
              one-step transform at the tiny UNet with a (64, 256) VAE
              (whose 256-channel convs pass the shape gate) under none,
              int8, int8_all and int8_static, f32 on cuda (TF32 off) against
              the CPU, the same weights, the static scales calibrated on the
              CPU (QUANT_TRANSFORM_TOL, QUANT_MIN_EFFECT_CORR); int8_conv and
              int8_matmul on the same int8 codes on both devices (int32
              accumulators equal, outputs within 1e-6). Then, counters reset
              before and read after, SD-v1.5-width bf16 components from
              seeded random weights: (c) ``LDiffusionModel.inference_tissue``
              on one 1024² ROI under none, int8 and int8_static (scales from
              ``calibrate_static_scales`` on that ROI): 114 gated sites a
              ROI, finite output that differs from none; (d) bench.py's
              program (``laplace_reverse_transform``: 512², batch 8, 5 PNDM
              steps with Laplace noise) under none and int8_static with
              bench.py's amax-1.0 stand-in. Every forward launch on wgmma,
              every GroupNorm launch on its gn_route route. (b) Every distinct
              gated conv shape of (c) and (d): int8_conv's device ms split
              into the activation's quantize / im2col / _int_mm /
              dequantize (the weight's codes are QConv's, taken once from
              its f32 weight; their quantize is timed apart), the bf16 cuDNN
              conv's device ms (each from CUDA graph replays), the bounds.
              Figures (``{"quant": ...}`` line): s/ROI,
              the transform's error and the masks' agreement against none,
              s a batch, patches/s, peak, the profiled pass's idle share, the
              per-shape table's sums; a ``quant shape`` line a shape.
 13. dist:    distribution (core/dist.py). A process group over NCCL at
              world size 1 (127.0.0.1, a free port; backend and NCCL version
              printed; no gloo on the card). One stage-1 step at SD-v1.5
              width on a 512² image through the one-device trainer and
              through DiffusionWarmupTrainer(mesh=...) under FSDP2, the same
              seeded weights and draws: the loss, the gradient norm, every
              gradient and updated parameter held to the one-device step
              (DIST_*), the route counters (K2-K6 and the GroupNorm
              backward, reset before each step) equal, the backward's
              GN_BWD_PER_STEP_512. Then the FSDP2 trainer from that state takes
              DIST_ROUTE_STEPS steps through ``train_step`` (its program:
              eager first use, capture with FSDP2's collectives inside the
              graph, replay) and one profiled replay, against as many
              ``step_fn`` calls from the same state: bit-equal or within
              twice the eager spread, each step's launches by route the
              eager step's; eager, captured and replayed s/step, capture s,
              allocated and reserved peaks. An FSDP2 trainer's state after
              a step (tiny configs) gathered, saved, loaded and re-sharded
              bit-equal. One segmentor step at the seg phase's plan
              data-parallel over the mesh (its gradients averaged by one
              all-reduce), plain and nnUNetTrainerBN (batch Dice and
              BatchNorm over the group), against the one-device step; then
              DIST_SEG_ROUTE_STEPS train and 2 validation steps through
              their programs against the eager route, the same rule, s per
              iteration by route. Then ``python -m
              torch.distributed.run --nproc_per_node 1 -m
              ldiffusion_tpu_torch.ldiffusion`` on ``random:tiny``: exit 0,
              the UNet directory and rank 0's loss log. Each step's wall,
              device ms and peak beside the one-device step's
              (``{"dist": ...}`` line; the compared steps are first steps
              timed with CUDA events, their ``device_span_ms`` the device
              timeline from the first launch to the last).
The line before the last is the kernels JSON; the last line is the device
JSON. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import glob
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

# The port's package sits beside this script: find it whatever the working
# directory, and under ``python -P`` (which leaves the script's directory off
# sys.path).
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# Published H100 SXM peaks (dense): bf16 tensor cores, f32 outside them, HBM3.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# Tolerances (atol, atol_rms, rtol): every element must hold
# |kernel - plain| <= atol + atol_rms*rms(plain) + rtol*|plain|.
# bf16 attention scales its absolute term with the output: at S = 16384 a
# typical |o| is about sqrt(e/S) ~ 0.013, where a fixed atol of 5e-3 would be
# 40% of a typical value and pass faults that move outputs by a few percent.
# Both versions round the output to bf16, at most one ulp
# (2^-7*|o|) apart: rtol 2^-6. They round the probabilities at different
# places (unnormalised in the kernel, normalised in the plain version),
# relative 2^-9 a term, about 2^-9*rms(o) an output: atol_rms 2^-5.
ATTN_BF16 = (0.0, 2 ** -5, 2 ** -6)
# GroupNorm outputs are O(1): same f32 math, other summation order; the bf16
# output can differ by one ulp (2^-7 relative at worst).
GN_BF16 = (1e-3, 0.0, 1.6e-2)
# f32: only the summation order differs.
ATTN_F32 = (2e-5, 0.0, 1e-4)
GN_F32 = (1e-5, 0.0, 1e-4)
# The logsumexp (K5): bf16 inputs give exact f32 products in both versions,
# so only the order of the f32 sums differs.
LSE = {"bfloat16": (1e-3, 0.0, 1e-5), "float32": (1e-4, 0.0, 1e-5)}
# The flash backward (K6): in bf16 both versions round P and dS to bf16 before
# their products, from f32 values that differ by summation order, and round
# dq/dk/dv to bf16 — the forward's bound; in f32 only the order of the sums
# over up to 4096 terms differs, relative to each gradient's scale.
BWD = {"bfloat16": ATTN_BF16, "float32": (0.0, 1e-4, 1e-4)}
# The GroupNorm backward: f32 math on both sides, other summation order and
# the kernel's fast exponential; dx, dscale and dbias each rounded once to
# bf16 (2^-7 relative at worst) from f32 values 2^-9 of their rms apart.
GN_BWD_BF16 = (0.0, 2 ** -9, 2 ** -7)


def log(*a):
    print(*a, flush=True)


# A timed window holds at least this much device work (and at least the
# caller's count of calls), so sub-0.1 ms kernels are timed over hundreds of
# launches and their times compare on one footing.
MIN_WINDOW_MS = 50.0
MAX_TIMED_CALLS = 5000


def _events_ms(fn, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """ms per call, over a window of max(iters, MIN_WINDOW_MS of work) calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    once = _events_ms(fn, 1)
    n = min(MAX_TIMED_CALLS, max(iters, math.ceil(MIN_WINDOW_MS / max(once, 1e-3))))
    return _events_ms(fn, n) / n


def device_kernel_ms(prof) -> dict:
    """Device time by kernel name (ms) from a finished torch.profiler run:
    device work only; a user range such as "Optimizer.step#AdamW.step" is
    listed on the device too, over kernels that are counted already."""
    import torch

    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
    return kernels


PROFILE_ATTEMPTS = 8  # CUPTI now and then drops the records of a whole window


def profiled_kernels_ms(fn, iters: int) -> dict:
    """Device time per call by kernel name: ``iters`` calls under
    torch.profiler, without the host time between them. A trace that holds
    fewer kernels than calls (each call launches at least one) is taken
    again, after a warm-up call, up to PROFILE_ATTEMPTS times, then raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        traced = sum(e.count for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation)
        if traced >= iters:
            return {name: ms / iters for name, ms in device_kernel_ms(prof).items()}
    raise AssertionError(f"the profiler traced {traced} kernels for {iters} calls")


def profiled_device_ms(fn, iters: int) -> float:
    """Device time per call: the sum of ``profiled_kernels_ms``."""
    return sum(profiled_kernels_ms(fn, iters).values())


def route_delta(fn, before: dict) -> str:
    """The one route a wrapper launched since ``before`` (its counts then)."""
    moved = [r for r, n in fn.launches_by_route.items() if n != before[r]]
    if len(moved) != 1 or fn.launches_by_route[moved[0]] != before[moved[0]] + 1:
        raise AssertionError(f"expected one launch, routes {before} -> {fn.launches_by_route}")
    return moved[0]


def compare(name, out, ref, tol):
    """Errors of ``out`` vs ``ref``: a dict of max abs, max rel, rms(ref) and
    the tolerance; raises when any element is outside
    atol + atol_rms*rms(ref) + rtol*|ref|."""
    import torch

    atol_abs, atol_rms, rtol = tol
    o, r = out.float(), ref.float()
    if not bool(torch.isfinite(o).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    rms = float(r.pow(2).mean().sqrt())
    atol = atol_abs + atol_rms * rms
    diff = (o - r).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / r.abs().clamp_min(1e-6)).max())
    worst = float((diff - (atol + rtol * r.abs())).max())
    row = {"max_abs_err": max_abs, "max_rel_err": max_rel, "rms_ref": rms,
           "atol": atol, "rtol": rtol}
    if worst > 0:
        raise AssertionError(f"{name}: {json.dumps(row)} outside the tolerance by {worst:.3e}")
    return row


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

# (B, S, H, D) at a 1024² ROI, SD-v1.5 width; launches per ROI in brackets:
# UNet level 0 (5), level 1 (5), level 2 (5), VAE mid-block (2)
ATTN_PATH_SHAPES = [(1, 16384, 8, 40), (1, 4096, 8, 80), (1, 1024, 8, 160),
                    (1, 16384, 1, 512)]
# ragged sequences and other head dims: the f32 kernel's tile widths; the
# wgmma kernel's other configurations (d % 8 == 0: 8, 96, 128, 136, 200 and
# the split at 512) and the shapes TMA cannot address, which stay on the
# mma.sync kernel (d = 100, 300)
ATTN_EXTRA = [((2, 300, 3, 8), "float32"), ((1, 1000, 2, 16), "float32"),
              ((1, 777, 2, 64), "float32"), ((1, 600, 1, 512), "float32"),
              ((2, 300, 3, 8), "bfloat16"), ((2, 515, 2, 96), "bfloat16"),
              ((1, 1000, 2, 128), "bfloat16"), ((1, 129, 2, 100), "bfloat16"),
              ((1, 700, 2, 136), "bfloat16"), ((1, 1500, 1, 200), "bfloat16"),
              ((1, 333, 1, 300), "bfloat16"), ((1, 600, 1, 512), "bfloat16")]
# (B, H, W, C, silu, eps): the smallest and largest maps of the path, the
# largest maps on each side of the routes' boundary (resident: the 512² step's
# 64²×320 and 64²×960, the ROI's 128²×640 and the VAE's 128²×512; streamed:
# the ROI's 128²×960 and the VAE's 256²×256, 256²×512 and 512²×256)
GN_PATH_SHAPES = [(1, 16, 16, 1280, True, 1e-5), (1, 16, 16, 2560, True, 1e-5),
                  (1, 16, 16, 1280, False, 1e-6), (1, 64, 64, 320, True, 1e-5),
                  (1, 64, 64, 960, True, 1e-5), (1, 128, 128, 320, False, 1e-6),
                  (1, 128, 128, 640, True, 1e-5), (1, 128, 128, 512, True, 1e-6),
                  (1, 128, 128, 960, True, 1e-5), (1, 256, 256, 256, True, 1e-6),
                  (1, 256, 256, 512, True, 1e-6), (1, 512, 512, 256, True, 1e-6),
                  (1, 1024, 1024, 128, True, 1e-6), (1, 1024, 1024, 128, False, 1e-5)]
# the generation tail's shapes at SD-v1.5 width: tools.sample's 512² image
# (K1 at the UNet's level 0 and 1, 4096 and 1024 tokens; K2 at the VAE
# mid-block, 4096 tokens, d = 512), then the multimodal augment of four 256²
# RGB-D pairs (K1 at the UNet's and the ControlNet's level 0, 1024 tokens,
# d = 40; K2 at the VAE mid-block, 1024 tokens); GroupNorm over the augment's
# batch-4 maps (B, H, W, C, silu, eps)
GEN_ATTN_SHAPES = [(1, 4096, 8, 40), (1, 1024, 8, 80), (1, 4096, 1, 512),
                   (4, 1024, 8, 40), (4, 1024, 1, 512)]
GEN_GN_SHAPES = [(4, 32, 32, 320, True, 1e-5), (4, 32, 32, 320, False, 1e-6),
                 (4, 8, 8, 2560, True, 1e-5), (4, 64, 64, 512, True, 1e-6),
                 (4, 128, 128, 256, True, 1e-6), (4, 256, 256, 128, True, 1e-6),
                 (4, 256, 256, 256, True, 1e-6)]
# ((B, H, W, C, G), dtype, scale/bias dtype, element offset of x): f32, odd
# channel counts, bf16 scale/bias, batches > 1, ragged rows; C·itemsize not a
# multiple of 16 (36 bf16) and x off the 16-byte grid take the scalar variant
GN_EXTRA = [((2, 7, 9, 96, 8), "float32", "float32", 0),
            ((1, 64, 64, 64, 32), "float32", "float32", 0),
            ((3, 33, 31, 640, 32), "bfloat16", "float32", 0),
            ((2, 40, 40, 320, 32), "bfloat16", "bfloat16", 0),
            ((3, 64, 64, 256, 32), "bfloat16", "bfloat16", 0),
            ((1, 300, 300, 128, 32), "bfloat16", "float32", 0),
            ((2, 256, 256, 256, 32), "bfloat16", "bfloat16", 0),
            ((1, 9, 9, 36, 4), "bfloat16", "float32", 0),
            ((2, 7, 9, 96, 8), "bfloat16", "float32", 1),
            ((1, 50, 50, 100, 4), "float32", "float32", 1)]
# the dataset build's DiffusionTransform(batch_size=2) at 1024²: the ROI's
# shapes at batch 2 (attention as ATTN_PATH_SHAPES, GroupNorm as
# GN_PATH_SHAPES); its launches are counted per batch in the seg phase
B2_ATTN_SHAPES = [(2,) + shape[1:] for shape in ATTN_PATH_SHAPES]
B2_GN_SHAPES = [(2,) + shape[1:] for shape in GN_PATH_SHAPES]
# (B, S, H, D) of the differentiated flash attention at 512² training images,
# SD-v1.5 width: UNet level 0 (4096 tokens) and level 1 (1024 tokens), each 5
# self-attentions per UNet pass, 6 timesteps a step → 30 K6 launches a step
# each, and twice as many K5 (remat runs each timestep's forward twice). d=160
# (level 2, 256 tokens at 512²) is routed plain there; K6 takes it anyway.
TRAIN_ATTN_SHAPES = [(1, 4096, 8, 40), (1, 1024, 8, 80), (1, 1024, 8, 160)]
TRAIN_PER_STEP = {"flash_attention_fwd_lse": [60, 60, 0], "flash_attention_bwd": [30, 30, 0]}
# ragged lengths and other head dims, f32 (the tiny runs' 16 and 64) and bf16
TRAIN_EXTRA = [((2, 300, 3, 8), "float32"), ((1, 1024, 2, 16), "float32"),
               ((1, 1024, 1, 64), "float32"), ((1, 777, 2, 160), "float32"),
               ((2, 300, 3, 8), "bfloat16"), ((1, 129, 2, 100), "bfloat16"),
               ((1, 515, 2, 136), "bfloat16"), ((2, 700, 2, 40), "bfloat16")]
# tools/bench_attn_exp2.py's (BH, S, D) shapes as (B, S, H, D): K7's formulation
K7_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 256, 8, 160)]
# bench.py's program at SD-v1.5 width (the quant phase's 512², batch 8): K1 at
# the UNet's level 0 and 1 (4096 and 1024 tokens, 30 launches each a pass),
# K2 at the VAE mid-blocks (4096 tokens, d = 512, 2 a pass); GroupNorm over
# its batch-8 maps (B, H, W, C, silu, eps): resident up to 20 MiB (the
# smallest, 8²×1280; 32²×1280; the largest, 64²×320, with and without SiLU),
# streamed above (the smallest, 32²×1920; the UNet's 64²×960; the VAE
# mid-block's 64²×512 without SiLU; 256²×256; 512²×128; the largest, 512²×256)
BENCH_ATTN_SHAPES = [(8, 4096, 8, 40), (8, 1024, 8, 80), (8, 4096, 1, 512)]
BENCH_GN_SHAPES = [(8, 8, 8, 1280, True, 1e-5), (8, 32, 32, 1280, True, 1e-5),
                   (8, 64, 64, 320, True, 1e-5), (8, 64, 64, 320, False, 1e-6),
                   (8, 32, 32, 1920, True, 1e-5), (8, 64, 64, 960, True, 1e-5),
                   (8, 64, 64, 512, False, 1e-6), (8, 256, 256, 256, True, 1e-6),
                   (8, 512, 512, 128, True, 1e-6), (8, 512, 512, 256, True, 1e-6)]


# (B, H, W, C, silu, eps) of the differentiated GroupNorm at stage 1 (bf16,
# bf16 parameters), backward launches a step in brackets: the 512² step's
# UNet at 64² latents, 64²×320 (78) and 16²×1280 (66), and its VAE decode,
# 256²×512 (6), 512²×128 (36) and 512²×256 (6); the 64²-image batch-8 step's
# UNet at 8², 8²×320 (78), and VAE decode, 64²×128 (36, without SiLU too)
GN_BWD_SHAPES = [(1, 64, 64, 320, True, 1e-5), (1, 16, 16, 1280, True, 1e-5),
                 (1, 256, 256, 512, True, 1e-6), (1, 512, 512, 128, True, 1e-6),
                 (1, 512, 512, 256, True, 1e-6), (8, 8, 8, 320, True, 1e-5),
                 (8, 64, 64, 128, True, 1e-6), (8, 64, 64, 128, False, 1e-6)]


def attn_row(b, s, h, d, dtype, gen, iters):
    import torch
    import torch.nn.functional as F

    from ldiffusion_tpu_torch.ops.attention import _launch_fwd, flash_attention_fwd, plain_attention

    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
               for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    before = dict(flash_attention_fwd.launches_by_route)
    out = flash_attention_fwd(q, k, v, scale)
    route = route_delta(flash_attention_fwd, before)
    ref = plain_attention(q, k, v, scale)
    torch.cuda.synchronize()
    tol = ATTN_BF16 if dt == torch.bfloat16 else ATTN_F32
    row = {"shape": [b, s, h, d], "dtype": dtype, "route": route,
           **compare(f"flash_attention_fwd{(b, s, h, d)} {dtype}", out, ref, tol)}
    del ref
    if iters:
        row["ms"] = cuda_ms(lambda: flash_attention_fwd(q, k, v, scale), iters)
        # the kernel alone: at the short shapes the host's launch path sets "ms"
        row["device_ms"] = profiled_device_ms(lambda: flash_attention_fwd(q, k, v, scale), 20)
        if route == "wgmma":  # the mma.sync kernel (the previous design), same inputs
            row["mma_ms"] = cuda_ms(
                lambda: _launch_fwd("flash_attention_fwd (mma)", q, k, v, scale, None, route="mma"), iters)
        row["plain_ms"] = cuda_ms(lambda: plain_attention(q, k, v, scale), iters)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters)
        flops = 4.0 * b * h * s * s * d
        nbytes = 4.0 * b * s * h * d * q.element_size()
        t_ops = flops / (PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
        t_bytes = nbytes / PEAK_BYTES
        row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return row


def gn_row(b, hh, ww, c, groups, silu, eps, dtype, gen, iters, sdtype="float32", offset=0):
    """GroupNorm(+SiLU) at one shape: the route ``gn_route`` names, two calls
    bitwise equal, the plain version's tolerance; timed (``iters``) beside the
    first kernel (csrc/groupnorm.cu, "v1"), the other route where it takes the shape (the
    resident route's limit is set from these), the plain version and
    F.group_norm + F.silu."""
    import torch
    import torch.nn.functional as F

    from ldiffusion_tpu_torch.ops.groupnorm import (
        _launch,
        gn_resident_config,
        gn_route,
        groupnorm_silu,
        plain_groupnorm_silu,
        vectorised,
    )

    dt, st = getattr(torch, dtype), getattr(torch, sdtype)
    shape = (b, hh, ww, c)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dt)
    if offset:  # the same values, `offset` elements past an allocation's start
        x = torch.empty(x.numel() + offset, device="cuda", dtype=dt)[offset:].view(shape).copy_(x)
    scale = (1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")).to(st)
    bias = (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(st)
    name = f"groupnorm_silu{shape} {dtype} scale {sdtype} silu={silu} eps={eps} offset={offset}"
    before = dict(groupnorm_silu.launches_by_route)
    out = groupnorm_silu(x, scale, bias, groups, eps, silu)
    route = route_delta(groupnorm_silu, before)
    aligned = x.data_ptr() % 16 == 0
    if route != gn_route(b, hh * ww, c, groups, dt, aligned):
        raise AssertionError(f"{name}: took {route}, gn_route names another")
    again = groupnorm_silu(x, scale, bias, groups, eps, silu)
    ref = plain_groupnorm_silu(x, scale, bias, groups, eps, silu)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls differ ({route})")
    tol = GN_BF16 if dt == torch.bfloat16 else GN_F32
    row = {"shape": list(shape), "groups": groups, "silu": silu, "eps": eps, "dtype": dtype,
           "scale_dtype": sdtype, "offset": offset, "route": route,
           "vectorised": vectorised(c, dt, aligned), "bitwise_repeat": True,
           **compare(name, out, ref, tol)}
    if route == "resident":
        row["config"] = gn_resident_config(b, hh * ww, c, groups, dt)
    # the other route, and the resident route with other narrowest slices
    # (bytes) where they change its choice: held to the same tolerance, timed
    # below (the route's limit and MIN_SLICE_BYTES are set from these)
    alts = {}
    if route == "resident":
        alts["stream"] = {"route": "stream"}
    if vectorised(c, dt, aligned):
        own = gn_resident_config(b, hh * ww, c, groups, dt) if route == "resident" else None
        for min_slice in (32, 64, 128, 256):
            cfg = gn_resident_config(b, hh * ww, c, groups, dt, min_slice)
            if cfg is not None and (own is None or cfg["groups"] != own["groups"]):
                alts[f"resident_{min_slice}"] = {"route": "resident", "min_slice": min_slice}
    for key, kw in alts.items():
        y_alt, _ = _launch(f"{name} ({key})", x, scale, bias, groups, eps, silu, **kw)
        torch.cuda.synchronize()
        row[f"{key}_max_abs_err"] = compare(f"{name} ({key})", y_alt, ref, tol)["max_abs_err"]
    del ref
    if iters:
        ours = lambda: groupnorm_silu(x, scale, bias, groups, eps, silu)
        row["ms"] = cuda_ms(ours, iters)
        # the kernels alone: at the small maps the host's launch path sets "ms"
        by_kernel = profiled_kernels_ms(ours, 20)
        row["device_ms"] = sum(by_kernel.values())
        row["device_ms_by_kernel"] = {name.split("<")[0].split("::")[-1]: ms
                                      for name, ms in by_kernel.items()}
        v1 = lambda: _launch("groupnorm_silu (v1)", x, scale, bias, groups, eps, silu,
                             route="v1")
        row["v1_ms"] = cuda_ms(v1, iters)  # the first kernel, same inputs
        row["v1_device_ms"] = profiled_device_ms(v1, 20)
        for key, kw in alts.items():
            row[f"{key}_device_ms"] = profiled_device_ms(
                lambda: _launch(key, x, scale, bias, groups, eps, silu, **kw), 20)
        row["plain_ms"] = cuda_ms(
            lambda: plain_groupnorm_silu(x, scale, bias, groups, eps, silu), iters)

        def library(xc):
            y = F.group_norm(xc, groups, scale.to(dt), bias.to(dt), eps)
            return F.silu(y) if silu else y

        xc = x.permute(0, 3, 1, 2)  # NCHW view of the same channels-last memory
        row["library_ms"] = cuda_ms(lambda: library(xc), iters)
        row["library_device_ms"] = profiled_device_ms(lambda: library(xc), 20)
        # the same values in contiguous NCHW memory, F.group_norm's own layout
        xn = xc.contiguous()
        row["library_nchw_ms"] = cuda_ms(lambda: library(xn), iters)
        del xn
        nbytes = 2.0 * x.numel() * x.element_size() + 2 * c * scale.element_size()
        t_bytes = nbytes / PEAK_BYTES
        t_ops = 10.0 * x.numel() / PEAK_F32
        row["bound_ms"] = 1e3 * max(t_ops, t_bytes)
        row["bound_by"] = "operations" if t_ops > t_bytes else "bytes"
    return row


def gn_bwd_row(b, hh, ww, c, silu, eps, gen):
    """The GroupNorm backward at one shape, bf16 with bf16 parameters: the
    route ``gn_route(..., backward=True)`` names, dx/dscale/dbias against
    ``plain_groupnorm_silu_backward`` (GN_BWD_BF16), two calls bitwise
    equal; ms a call in a CUDA graph (as the captured step runs it) and
    eager, the kernels' device ms, the other route where the shape takes it
    (held to the same tolerance), the autograd route through
    ``plain_groupnorm_silu`` that the kernels replaced, the closed form and
    autograd through F.group_norm + F.silu. Bound: x and dy read, dx written
    once."""
    import torch
    import torch.nn.functional as F

    from ldiffusion_tpu_torch.ops.groupnorm import (
        _launch_bwd,
        gn_route,
        groupnorm_silu_backward,
        plain_groupnorm_silu,
        plain_groupnorm_silu_backward,
    )

    dt, groups = torch.bfloat16, 32
    shape = (b, hh, ww, c)
    x = (torch.randn(shape, generator=gen, device="cuda") * 2.0 + 0.5).to(dt)
    dy = torch.randn(shape, generator=gen, device="cuda").to(dt)
    scale = (1.0 + 0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dt)
    bias = (0.1 * torch.randn((c,), generator=gen, device="cuda")).to(dt)
    name = f"groupnorm_silu_backward{shape} silu={silu} eps={eps}"
    fn = groupnorm_silu_backward
    before = dict(fn.launches_by_route)
    got = fn(x, dy, scale, bias, groups, eps, silu)
    route = route_delta(fn, before)
    if route != gn_route(b, hh * ww, c, groups, dt, True, backward=True):
        raise AssertionError(f"{name}: took {route}, gn_route names another")
    again = fn(x, dy, scale, bias, groups, eps, silu)
    refs = plain_groupnorm_silu_backward(x, dy, scale, bias, groups, eps, silu)
    torch.cuda.synchronize()
    if not all(torch.equal(a, o) for a, o in zip(again, got)):
        raise AssertionError(f"{name}: two calls differ ({route})")
    row = {"shape": list(shape), "groups": groups, "silu": silu, "eps": eps, "dtype": "bfloat16",
           "scale_dtype": "bfloat16", "route": route, "bitwise_repeat": True}
    for key, out, ref in zip(("dx", "dscale", "dbias"), got, refs):
        row[key] = compare(f"{name} {key}", out, ref, GN_BWD_BF16)
    row["max_abs_err"] = max(row[k]["max_abs_err"] for k in ("dx", "dscale", "dbias"))
    alts = ["stream"] if route == "resident" else []
    for alt in alts:
        *y_alt, _ = _launch_bwd(x, dy, scale, bias, groups, eps, silu, True, route=alt)
        torch.cuda.synchronize()
        row[f"{alt}_max_abs_err"] = max(
            compare(f"{name} ({alt}) {key}", out, ref, GN_BWD_BF16)["max_abs_err"]
            for key, out, ref in zip(("dx", "dscale", "dbias"), y_alt, refs))
    del again, refs, got
    ours = lambda: fn(x, dy, scale, bias, groups, eps, silu)
    row["ms"] = graph_ms(ours)
    row["eager_ms"] = cuda_ms(ours, 10)
    by_kernel = profiled_kernels_ms(ours, 20)
    row["device_ms"] = sum(by_kernel.values())
    row["device_ms_by_kernel"] = {k.split("<")[0].split("::")[-1]: ms
                                  for k, ms in by_kernel.items()}
    for alt in alts:
        row[f"{alt}_ms"] = graph_ms(
            lambda: _launch_bwd(x, dy, scale, bias, groups, eps, silu, True, route=alt))

    def autograd(forward, xs):
        leaves = [t.detach().requires_grad_() for t in (xs, scale, bias)]
        y = forward(*leaves)
        return torch.autograd.grad(y, leaves, dy if xs is x else dy.permute(0, 3, 1, 2))

    row["prev_ms"] = graph_ms(
        lambda: autograd(lambda *t: plain_groupnorm_silu(*t, groups, eps, silu), x))
    row["plain_ms"] = graph_ms(
        lambda: plain_groupnorm_silu_backward(x, dy, scale, bias, groups, eps, silu))

    def library(xc, w, b_):
        y = F.group_norm(xc, groups, w, b_, eps)
        return F.silu(y) if silu else y

    row["library_ms"] = graph_ms(lambda: autograd(library, x.permute(0, 3, 1, 2)))
    row["bound_ms"] = 1e3 * 3.0 * x.numel() * x.element_size() / PEAK_BYTES
    row["bound_by"] = "bytes"
    return row


def attn_bound(b, s, h, d, dt, ops_per_mac: int, n_tensors: int, extra_bytes: float = 0.0):
    """(bound_ms, bound_by): ops_per_mac·B·H·S²·D operations at the peak of the
    type, or n_tensors (B, S, H, D) tensors + extra_bytes moved once."""
    import torch

    t_ops = ops_per_mac * b * h * s * s * d / (PEAK_BF16 if dt == torch.bfloat16 else PEAK_F32)
    t_bytes = (n_tensors * b * s * h * d * dt.itemsize + extra_bytes) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def lse_row(b, s, h, d, dtype, gen, iters):
    """K5: the forward with logsumexp against plain_attention_lse."""
    import torch
    import torch.nn.functional as F

    from ldiffusion_tpu_torch.ops.attention import (
        _launch_fwd,
        flash_attention_fwd_lse,
        plain_attention_lse,
    )

    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt) for _ in range(3))
    scale = 1.0 / math.sqrt(d)
    before = dict(flash_attention_fwd_lse.launches_by_route)
    out, lse = flash_attention_fwd_lse(q, k, v, scale)
    route = route_delta(flash_attention_fwd_lse, before)
    ref, ref_lse = plain_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    name = f"flash_attention_fwd_lse{(b, s, h, d)} {dtype}"
    row = {"shape": [b, s, h, d], "dtype": dtype, "route": route,
           "out": compare(name + " out", out, ref, ATTN_BF16 if dt == torch.bfloat16 else ATTN_F32),
           "lse": compare(name + " lse", lse, ref_lse, LSE[dtype])}
    row["max_abs_err"] = max(row["out"]["max_abs_err"], row["lse"]["max_abs_err"])
    del ref, ref_lse
    if iters:
        row["ms"] = cuda_ms(lambda: flash_attention_fwd_lse(q, k, v, scale), iters)
        row["device_ms"] = profiled_device_ms(lambda: flash_attention_fwd_lse(q, k, v, scale), 20)
        if route == "wgmma":  # the mma.sync kernel (the previous design), same inputs
            row["mma_ms"] = cuda_ms(
                lambda: _launch_fwd("flash_attention_fwd (mma)", q, k, v, scale, lse, route="mma"), iters)
        row["plain_ms"] = cuda_ms(lambda: plain_attention_lse(q, k, v, scale), iters)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale), iters)
        row["bound_ms"], row["bound_by"] = attn_bound(b, s, h, d, dt, 4, 4, 4.0 * b * h * s)
    return row


def bwd_row(b, s, h, d, dtype, gen, iters, memory_check=False):
    """K6: dq/dk/dv against plain_attention_bwd, from the same lse."""
    import torch
    import torch.nn.functional as F

    from ldiffusion_tpu_torch.ops.attention import (
        _launch_bwd,
        flash_attention_bwd,
        plain_attention_bwd,
        plain_attention_lse,
    )

    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    out, lse = plain_attention_lse(q, k, v, scale)
    # contiguous, as the forward kernel writes it (the plain einsum returns a
    # permuted view, which the wrapper would copy inside the timed calls)
    out = out.contiguous()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(flash_attention_bwd.launches_by_route)
    grads = flash_attention_bwd(q, k, v, out, do, lse, scale)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    route = route_delta(flash_attention_bwd, before)
    refs = plain_attention_bwd(q, k, v, out, do, lse, scale)
    torch.cuda.synchronize()
    name = f"flash_attention_bwd{(b, s, h, d)} {dtype}"
    row = {"shape": [b, s, h, d], "dtype": dtype, "route": route, "peak_rise_bytes": rise}
    for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
        row[gname] = compare(f"{name} {gname}", g, r, BWD[dtype])
    row["max_abs_err"] = max(row[g]["max_abs_err"] for g in ("dq", "dk", "dv"))
    del refs
    if memory_check:
        row["score_matrix_bytes"] = 4 * s * s
        if rise >= 4 * s * s:
            raise AssertionError(f"{name}: the backward raised the peak by {rise} B, not below "
                                 f"one f32 score matrix ({4 * s * s} B)")
    if iters:
        ours = lambda: flash_attention_bwd(q, k, v, out, do, lse, scale)
        row["ms"] = cuda_ms(ours, iters)
        by_kernel = profiled_kernels_ms(ours, 50)  # the kernels (pre-pass included) alone
        row["device_ms"] = sum(by_kernel.values())
        row["device_ms_by_kernel"] = {name[:60]: ms for name, ms in by_kernel.items()}
        if route == "wgmma":  # the mma.sync kernels (the previous design), same inputs
            mma = lambda: _launch_bwd("flash_attention_bwd (mma)", q, k, v, out, do, lse, scale,
                                      route="mma")
            row["mma_ms"] = cuda_ms(mma, iters)
            row["mma_device_ms"] = profiled_device_ms(mma, 50)  # Δ's PyTorch kernels included
        row["plain_ms"] = cuda_ms(lambda: plain_attention_bwd(q, k, v, out, do, lse, scale),
                                  iters)
        # SDPA's backward alone on the same shape: one forward kept, grads timed
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        dot = do.transpose(1, 2)
        sdpa_bwd = lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)
        row["library_ms"] = cuda_ms(sdpa_bwd, iters)  # host time of autograd included
        row["library_device_ms"] = profiled_device_ms(sdpa_bwd, 50)  # kernels only
        # reads q, k, v, o, do, lse, Δ; writes dq, dk, dv
        row["bound_ms"], row["bound_by"] = attn_bound(b, s, h, d, dt, 10, 8, 8.0 * b * h * s)
    return row


def phase_kernels(seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    attn, gn = [], []
    for b, s, h, d in ATTN_PATH_SHAPES:
        attn.append(attn_row(b, s, h, d, "bfloat16", gen, iters=5))
        log("kernel flash_attention_fwd", json.dumps(attn[-1]))
    for shape, dtype in ATTN_EXTRA:
        r = attn_row(*shape, dtype, gen, iters=0)
        log("kernel flash_attention_fwd", json.dumps(r))
    for b, s, h, d in GEN_ATTN_SHAPES:  # after the path rows: KERNEL_META's per_call skips them
        attn.append(attn_row(b, s, h, d, "bfloat16", gen, iters=5))
        log("kernel gen_shapes flash_attention_fwd", json.dumps(attn[-1]))
    for b, s, h, d in BENCH_ATTN_SHAPES:
        attn.append(attn_row(b, s, h, d, "bfloat16", gen, iters=5))
        log("kernel bench_shapes flash_attention_fwd", json.dumps(attn[-1]))
    for b, s, h, d in B2_ATTN_SHAPES:
        attn.append(attn_row(b, s, h, d, "bfloat16", gen, iters=5))
        log("kernel batch2_shapes flash_attention_fwd", json.dumps(attn[-1]))
    for b, hh, ww, c, silu, eps in GN_PATH_SHAPES:
        gn.append(gn_row(b, hh, ww, c, 32, silu, eps, "bfloat16", gen, iters=10))
        log("kernel groupnorm_silu", json.dumps(gn[-1]))
    for b, hh, ww, c, silu, eps in GEN_GN_SHAPES:
        gn.append(gn_row(b, hh, ww, c, 32, silu, eps, "bfloat16", gen, iters=10))
        log("kernel gen_shapes groupnorm_silu", json.dumps(gn[-1]))
    for b, hh, ww, c, silu, eps in BENCH_GN_SHAPES:
        gn.append(gn_row(b, hh, ww, c, 32, silu, eps, "bfloat16", gen, iters=10))
        log("kernel bench_shapes groupnorm_silu", json.dumps(gn[-1]))
    for b, hh, ww, c, silu, eps in B2_GN_SHAPES:
        gn.append(gn_row(b, hh, ww, c, 32, silu, eps, "bfloat16", gen, iters=10))
        log("kernel batch2_shapes groupnorm_silu", json.dumps(gn[-1]))
    for (b, hh, ww, c, groups), dtype, sdtype, offset in GN_EXTRA:
        for silu in (True, False):
            r = gn_row(b, hh, ww, c, groups, silu, 1e-5, dtype, gen, iters=0, sdtype=sdtype,
                       offset=offset)
            log("kernel groupnorm_silu", json.dumps(r))
    gn_bwd = []
    for b, hh, ww, c, silu, eps in GN_BWD_SHAPES:
        gn_bwd.append(gn_bwd_row(b, hh, ww, c, silu, eps, gen))
        log("kernel groupnorm_silu_backward", json.dumps(gn_bwd[-1]))
    lse, bwd = [], []
    for i, (b, s, h, d) in enumerate(TRAIN_ATTN_SHAPES):
        lse.append(lse_row(b, s, h, d, "bfloat16", gen, iters=5))
        log("kernel flash_attention_fwd_lse", json.dumps(lse[-1]))
        bwd.append(bwd_row(b, s, h, d, "bfloat16", gen, iters=5, memory_check=i == 0))
        log("kernel flash_attention_bwd", json.dumps(bwd[-1]))
    for shape, dtype in TRAIN_EXTRA:
        log("kernel flash_attention_fwd_lse", json.dumps(lse_row(*shape, dtype, gen, iters=0)))
        log("kernel flash_attention_bwd", json.dumps(bwd_row(*shape, dtype, gen, iters=0)))
    for b, s, h, d in K7_SHAPES:  # the exp2 formulation at the A/B tool's shapes
        log("kernel k7_exp2_shapes flash_attention_fwd_lse",
            json.dumps(lse_row(b, s, h, d, "bfloat16", gen, iters=5)))
    return {"flash_attention_fwd": attn, "groupnorm_silu": gn,
            "flash_attention_fwd_lse": lse, "flash_attention_bwd": bwd,
            "groupnorm_silu_backward": gn_bwd}


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def counters():
    from ldiffusion_tpu_torch.ops.attention import (
        flash_attention_bwd,
        flash_attention_fwd,
        flash_attention_fwd_lse,
    )
    from ldiffusion_tpu_torch.ops.groupnorm import groupnorm_silu, groupnorm_silu_backward

    return {"flash_attention_fwd": flash_attention_fwd, "groupnorm_silu": groupnorm_silu,
            "flash_attention_fwd_lse": flash_attention_fwd_lse,
            "flash_attention_bwd": flash_attention_bwd,
            "groupnorm_silu_backward": groupnorm_silu_backward}


def reset_counters():
    for fn in counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_counters():
    return {name: fn.launches for name, fn in counters().items()}


def read_routes():
    """Launches by route of the attention and GroupNorm wrappers."""
    return {name: dict(fn.launches_by_route) for name, fn in counters().items()
            if hasattr(fn, "launches_by_route")}


def check_bf16_routes(where: str, routes: dict) -> None:
    """Every bf16 forward and backward of the model's path shapes takes the
    wgmma route (GroupNorm's routes are its own)."""
    for name, by_route in routes.items():
        if name.startswith("groupnorm_silu"):
            continue
        off = {r: n for r, n in by_route.items() if r != "wgmma" and n}
        if off:
            raise AssertionError(f"{where}: {name} launched off the wgmma route: {by_route}")


INFERENCE_KERNELS = ("flash_attention_fwd", "groupnorm_silu")
NATIVE_2D = ("crop_with_pad_batch", "affine_augment_batch")
NATIVE_3D = ("crop_with_pad_batch_3d", "affine_augment_batch_3d")


def check_native_routes(where: str, routes: dict, used) -> None:
    """No host crop or resample took the numpy route, and each entry point
    of ``used`` ran natively at least once."""
    for name, by_route in routes.items():
        if by_route["numpy"] or (name in used and not by_route["native"]):
            raise AssertionError(f"{where}: {name} left the native route: {by_route}")


class GnRouteWatch:
    """Counts, for every GroupNorm layer call on the card while it is open,
    the route ``gn_route`` names for the call's shape (a global forward
    pre-hook on ``FusedGroupNormSiLU``, which hands the wrapper its input as
    contiguous NHWC), and the calls by shape; a CUDA graph captured while it
    is open repeats its counts on every replay (``core/graphs.py``).
    ``check`` holds the wrapper's launches by route since ``reset_counters``
    against them."""

    def __enter__(self):
        from torch.nn.modules.module import register_module_forward_pre_hook

        from ldiffusion_tpu_torch.ops.groupnorm import ROUTES

        from ldiffusion_tpu_torch.core import graphs

        self.expected = dict.fromkeys(ROUTES, 0)
        self.shapes = {}
        self.handle = register_module_forward_pre_hook(self._hook)
        # a replayed program calls no hook: its captures record these too
        for attr in ("expected", "shapes"):
            graphs.watch_counter(self, attr)
        return self

    def _hook(self, module, args):
        from ldiffusion_tpu_torch.models.layers import FusedGroupNormSiLU
        from ldiffusion_tpu_torch.ops.groupnorm import gn_route

        x = args[0]
        if not isinstance(module, FusedGroupNormSiLU) or not x.is_cuda:
            return
        b, c, h, w = x.shape
        # a channels-last input is passed as it is; any other is copied into
        # a fresh (aligned) allocation
        aligned = x.data_ptr() % 16 == 0 or not x.permute(0, 2, 3, 1).is_contiguous()
        self.expected[gn_route(b, h * w, c, module.groups, x.dtype, aligned)] += 1
        key = f"{b}x{h}x{w}x{c}"
        self.shapes[key] = self.shapes.get(key, 0) + 1

    def __exit__(self, *exc):
        from ldiffusion_tpu_torch.core import graphs

        self.handle.remove()
        for attr in ("expected", "shapes"):
            graphs.unwatch_counter(self, attr)

    def check(self, where: str, routes: dict) -> None:
        if routes["groupnorm_silu"] != self.expected:
            raise AssertionError(f"{where}: groupnorm_silu launched {routes['groupnorm_silu']} "
                                 f"by route, gn_route names {self.expected} for its calls")


def tissue_like(rng, h, w):
    """A smooth synthetic ROI (coarse random field, upsampled, faint noise)."""
    import numpy as np
    from PIL import Image

    coarse = Image.fromarray((rng.random((max(h // 64, 2), max(w // 64, 2), 3)) * 255)
                             .astype(np.uint8))
    field = np.asarray(coarse.resize((w, h), Image.BICUBIC), np.float32)
    field += rng.normal(scale=8.0, size=field.shape)
    return Image.fromarray(np.clip(field, 0, 255).astype(np.uint8))


def write_segmentor(root, plan, seed):
    """A segmentor directory in the JAX trainer's layout: plans.json and
    fold_0/checkpoint_final.pkl (a pickle of flax-layout numpy params,
    written through dynunet_to_flax), with seeded random weights."""
    import pickle

    import torch

    from ldiffusion_tpu_torch.models.convert import dynunet_to_flax
    from ldiffusion_tpu_torch.models.dynunet import DynUNet
    from ldiffusion_tpu_torch.models.layers import init_random_

    cfg = plan.network_config()
    net = init_random_(DynUNet(cfg), torch.Generator().manual_seed(seed))
    plan.save(os.path.join(root, "plans.json"))
    os.makedirs(os.path.join(root, "fold_0"))
    with open(os.path.join(root, "fold_0", "checkpoint_final.pkl"), "wb") as f:
        pickle.dump({"params": dynunet_to_flax(net.state_dict(), cfg),
                     "plan": plan.to_json()}, f, protocol=4)
    return root


def seg_plan(patch, features, strides):
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan

    return SegPlan(patch_size=patch, batch_size=2, features_per_stage=features,
                   strides=strides, n_conv_per_stage=2, num_classes=7, in_channels=3,
                   normalization="zscore_image", intensity_properties={},
                   median_shape=patch, batch_dice=True)


TINY_TRANSFORM_TOL = 1e-3   # f32 both sides, TF32 off: summation order only
TINY_MASK_AGREEMENT = 0.995


def phase_tiny(work, seed):
    """inference_tissue at the tiny configs on a 64² ROI (random: path):
    cuda with the kernels vs the CPU with the plain versions, same weights."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.api import LDiffusionModel
    from ldiffusion_tpu_torch.data.dataset import load_image
    from ldiffusion_tpu_torch.diffusion.pipeline import (
        SDComponents,
        one_step_transform,
        trajectory_text_emb,
    )

    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor

    rng = np.random.default_rng(seed)
    roi = os.path.join(work, "tiny_roi.png")
    tissue_like(rng, 64, 64).save(roi)
    seg = write_segmentor(os.path.join(work, "tiny_seg"),
                          seg_plan((32, 32), (8, 16, 32), (1, 2, 2)), seed)
    out, transformed = {}, {}
    # the DynUNet in f32 on both devices (the API builds its predictor in bf16)
    load = SlidingWindowPredictor.__dict__["from_checkpoints"]
    SlidingWindowPredictor.from_checkpoints = classmethod(
        lambda cls, plan, paths, **kw: load.__func__(cls, plan, paths, dtype=torch.float32,
                                                     **kw))
    reset_counters()
    try:
        for dev in ("cuda", "cpu"):
            # drawn on the CPU: the same weights for both devices
            comps = SDComponents.random(seed=seed, device="cpu")
            model = LDiffusionModel("random:tiny", "tissue", components=comps, device=dev)
            decoded, mask = model.inference_tissue(roi, None, seg, 7)
            out[dev] = (np.asarray(decoded, np.int16), mask)
            with torch.inference_mode():
                x = torch.from_numpy(load_image(roi, (64, 64)))[None].to(dev)
                transformed[dev] = one_step_transform(
                    comps, x, trajectory_text_emb(comps, 1)).float().cpu().numpy()
            if dev == "cuda":
                launched = read_counters()
    finally:
        SlidingWindowPredictor.from_checkpoints = load
    err = float(np.abs(transformed["cuda"] - transformed["cpu"]).max())
    agree = float(np.mean(out["cuda"][1] == out["cpu"][1]))
    png_diff = int(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    row = {"transformed_max_abs_diff": err, "tol": TINY_TRANSFORM_TOL,
           "decoded_png_max_level_diff": png_diff, "mask_agreement": agree,
           "min_agreement": TINY_MASK_AGREEMENT, "cuda_launches": launched}
    log("tiny", json.dumps(row))
    if not np.isfinite(transformed["cuda"]).all() or err > TINY_TRANSFORM_TOL:
        raise AssertionError(f"tiny: cuda vs cpu transformed image differs by {err}")
    if agree < TINY_MASK_AGREEMENT:
        raise AssertionError(f"tiny: masks agree on only {agree:.4%} of pixels")
    if min(launched[k] for k in INFERENCE_KERNELS) == 0:
        raise AssertionError(f"tiny: a kernel was not launched on cuda: {launched}")
    return row


FULL_PLAN = ((1024, 1024), (32, 64, 128, 256, 512, 512, 512), (1, 2, 2, 2, 2, 2, 2))
FULL_SQUARE_ROIS = 8  # the folder's 1024² ROIs: the 3-slot ring wraps, most replay


def program_stats(caches) -> dict:
    """Programs, captured graphs, replays and capture seconds over program
    caches (``LDiffusionModel.tissue_programs``, a ``Jit``'s ``programs``)."""
    progs = [p for cache in caches.values() for p in cache.values()]
    return {"programs": len(progs), "graphs_captured": sum(p.graph is not None for p in progs),
            "replays": sum(p.replays for p in progs),
            "capture_s": sum(p.capture_s for p in progs)}


def forced_capture_failure():
    """A capture that must fail raises, and nothing falls back: the streamed
    GroupNorm's workspace may not grow while a CUDA graph is captured. Both
    kinds of program: an inference one, and a training step (a draw from a
    registered generator, forward, backward, an update)."""
    import torch

    from ldiffusion_tpu_torch.core.graphs import Program, TrainProgram
    from ldiffusion_tpu_torch.ops import groupnorm as tgn

    x = torch.randn(1, 7, 9, 6, device="cuda")  # 24-byte rows: the streamed route
    one, zero = torch.ones(6, device="cuda"), torch.zeros(6, device="cuda")
    w = torch.ones(6, device="cuda", requires_grad=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def train(t):
        noisy = t + torch.rand(t.shape, generator=gen, device="cuda")
        loss = tgn.groupnorm_silu_trainable(noisy, w, zero, groups=2).square().mean()
        loss.backward()
        with torch.no_grad():
            w.sub_(0.1 * w.grad)
        w.grad = None
        return loss.detach()

    raised = {}
    for kind, program in (
            ("inference", Program(lambda t: tgn.groupnorm_silu(t, one, zero, groups=2), "cuda")),
            ("training", TrainProgram(train, "cuda", generators=[gen]))):
        program(x)
        kept, tgn._workspaces = tgn._workspaces, {}
        try:
            program(x)
        except RuntimeError as e:
            if "workspace" not in str(e) or program.graph is not None:
                raise
            raised[kind] = str(e).split(";")[0]
        finally:
            tgn._workspaces = kept
        if kind not in raised:
            raise AssertionError(f"full: a {kind} capture that grows the GroupNorm workspace "
                                 "did not raise")
    return raised


def phase_full(work, seed):
    """SD-v1.5-width tissue inference at 1024², bf16, seeded random weights:
    one ROI (eager), then a folder of 8 square ROIs and a non-square one
    through the captured programs, each mask (and the decoded image of a
    square ROI) bit-equal to the eager route on the same ROI."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.api import LDiffusionModel, _plain_rgb
    from ldiffusion_tpu_torch.data.dataset import load_image
    from ldiffusion_tpu_torch.diffusion.pipeline import (
        SDComponents,
        one_step_transform,
        trajectory_text_emb,
    )
    from ldiffusion_tpu_torch.models.clip_text import CLIPTextConfig
    from ldiffusion_tpu_torch.models.unet import UNet2DConditionConfig
    from ldiffusion_tpu_torch.models.vae import VAEConfig

    rng = np.random.default_rng(seed + 1)
    rois = os.path.join(work, "rois")
    os.makedirs(rois)
    for i in range(FULL_SQUARE_ROIS):
        tissue_like(rng, 1024, 1024).save(os.path.join(rois, f"roi_{i}.png"))
    tissue_like(rng, 768, 1024).save(os.path.join(rois, f"roi_{FULL_SQUARE_ROIS}_wide.png"))
    n_rois = FULL_SQUARE_ROIS + 1
    single = os.path.join(work, "single_roi.png")
    tissue_like(rng, 1024, 1024).save(single)
    seg = write_segmentor(os.path.join(work, "seg_1024"), seg_plan(*FULL_PLAN), seed)

    t0 = time.perf_counter()
    comps = SDComponents.random(seed=seed, dtype=torch.bfloat16, device="cuda",
                                unet_config=UNet2DConditionConfig.sd15(),
                                vae_config=VAEConfig.sd15(),
                                text_config=CLIPTextConfig.sd15())
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (comps.unet, comps.vae, comps.text, comps.proj)
                   for p in m.parameters())
    log(f"full: SD-v1.5 components, {n_params} parameters, bf16, built in "
        f"{time.perf_counter() - t0:.3f} s")
    # not random: → the 1024² ROI size rule applies, as in the JAX API
    model = LDiffusionModel("sd15-seeded-random", "tissue", components=comps)
    # the peaks from here on are this path's (the warm-up is the single-image
    # call), the reserved one not holding earlier phases' cached blocks
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.inference_tissue(single, None, seg, 7)  # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    with GnRouteWatch() as watch:
        reset_counters()  # the main path starts here
        t0 = time.perf_counter()
        decoded, mask = model.inference_tissue(single, None, seg, 7)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        single_programs = program_stats(model.tissue_programs)
        per_roi = read_counters()
        per_roi_gn_routes = read_routes()["groupnorm_silu"]
        per_roi_gn_shapes = dict(watch.shapes)
        out_dir = os.path.join(work, "masks")
        t0 = time.perf_counter()
        model.inference_tissue(rois, None, seg, 7, output_path=out_dir)
        torch.cuda.synchronize()
        folder_s = time.perf_counter() - t0
        launches = read_counters()  # the main path ends here
        routes = read_routes()
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    folder_programs = program_stats(model.tissue_programs)
    fused_folder = model.tissue_programs["fused"][((1024, 1024, 3), False)]
    check_bf16_routes("full", routes)
    watch.check("full", routes)
    folder_launches = {k: launches[k] - per_roi[k] for k in launches}
    for k in INFERENCE_KERNELS:  # the non-square ROI skips the transform
        if folder_launches[k] != FULL_SQUARE_ROIS * per_roi[k]:
            raise AssertionError(f"full: {k} launched {folder_launches[k]} times for "
                                 f"{FULL_SQUARE_ROIS} square ROIs, {per_roi[k]} for one")
    if single_programs["graphs_captured"]:
        raise AssertionError(f"full: the single-image call captured: {single_programs}")
    if fused_folder.graph is None or fused_folder.replays < FULL_SQUARE_ROIS - 1:
        raise AssertionError(f"full: the folder's fused program replayed "
                             f"{fused_folder.replays} times for {FULL_SQUARE_ROIS} ROIs")

    from PIL import Image

    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor

    if mask.shape != (1024, 1024) or mask.dtype != np.uint8 or int(mask.max()) >= 7:
        raise AssertionError(f"full: bad mask {mask.shape} {mask.dtype} max {mask.max()}")
    if decoded.size != (1024, 1024):
        raise AssertionError(f"full: decoded image is {decoded.size}")

    def fresh_predictor():
        return SlidingWindowPredictor.from_checkpoints(
            SegPlan.load(os.path.join(seg, "plans.json")),
            [os.path.join(seg, "fold_0", "checkpoint_final.pkl")], device="cuda")

    # each folder mask against the eager route on its ROI: the fused
    # program's function called directly (a square ROI), a fresh predictor's
    # first use (the non-square one)
    t0 = time.perf_counter()
    for name in sorted(os.listdir(rois)):
        path = os.path.join(rois, name)
        with Image.open(path) as src, Image.open(os.path.join(out_dir, name)) as m:
            got, size = np.asarray(m), src.size
        if size[0] == size[1]:
            with torch.inference_mode():
                x = torch.from_numpy(load_image(path, (1024, 1024))).cuda()
                want = fused_folder.fn(x).cpu().numpy()
        else:
            want = fresh_predictor().predict(_plain_rgb(path)[1])
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"full: folder mask {name} differs from the eager route "
                                 f"on {int(np.sum(got != want))} pixels")
    eager_check_s = time.perf_counter() - t0

    # the decoded image and mask of a square ROI through a transform-keeping
    # program: eager, captured + replayed, replayed, bit for bit
    predictor = fresh_predictor()
    with torch.inference_mode():
        run = model._make_fused_predict(predictor, trajectory_text_emb(comps, 1))
        x = torch.from_numpy(load_image(single, (1024, 1024)))
        outs = [[a.cpu().numpy() for a in run(x, want_transformed=True)] for _ in range(3)]
    keep = run.programs[((1024, 1024, 3), True)]
    for i, (t, m) in enumerate(outs[1:], start=1):
        if not (np.array_equal(t, outs[0][0]) and np.array_equal(m, outs[0][1])):
            raise AssertionError(f"full: replay {i} of the transform-keeping program differs "
                                 "from its eager first use")
    if not np.array_equal(np.asarray(decoded),
                          (np.clip(outs[0][0], 0, 1) * 255).astype(np.uint8)):
        raise AssertionError("full: the API's decoded image differs from the program's")
    capture_failure = forced_capture_failure()

    with torch.inference_mode():
        x = torch.from_numpy(load_image(single, (1024, 1024)))[None].cuda()
        t = one_step_transform(comps, x, trajectory_text_emb(comps, 1))
        finite = bool(torch.isfinite(t).all())
        lo, hi = float(t.min()), float(t.max())
    if not finite or lo < 0 or hi > 1:
        raise AssertionError(f"full: transformed image finite={finite} range [{lo}, {hi}]")
    if min(launches[k] for k in INFERENCE_KERNELS) == 0:
        raise AssertionError(f"full: a kernel was not launched on the main path: {launches}")

    t0 = time.perf_counter()  # the per-call host set-up: read, convert, upload
    predictor = fresh_predictor()
    torch.cuda.synchronize()
    predictor_s = time.perf_counter() - t0
    profile_roi(model, single, seg, predictor, comps)
    folder_prof = device_profile(lambda: model.inference_tissue(
        rois, None, seg, 7, output_path=os.path.join(work, "masks_profiled")))
    row = {"roi": [1024, 1024], "dtype": "bfloat16", "warmup_s": warm_s,
           "predictor_build_s": predictor_s,
           "single_s_per_roi": single_s, "folder_rois": n_rois, "folder_s": folder_s,
           "folder_s_per_roi": folder_s / n_rois, "max_memory_allocated": peak,
           "max_memory_reserved": peak_reserved,
           "single_programs": single_programs, "folder_programs": folder_programs,
           "transform_program_capture_s": keep.capture_s,
           "folder_profiled": {k: folder_prof[k] for k in
                               ("wall_s", "device_busy_ms", "device_idle_share",
                                "by_family_ms")},
           "folder_profiled_s_per_roi": folder_prof["wall_s"] / n_rois,
           "eager_check_s": eager_check_s, "forced_capture_failure": capture_failure,
           "launches_per_roi": per_roi,
           "launches_per_square_roi_in_folder": {
               k: folder_launches[k] / FULL_SQUARE_ROIS for k in INFERENCE_KERNELS},
           "launches": launches, "launches_by_route": routes,
           "groupnorm_routes_per_roi": per_roi_gn_routes,
           "groupnorm_shapes_per_roi": per_roi_gn_shapes,
           "mask_classes": np.bincount(mask.ravel(), minlength=7).tolist(),
           "transformed_range": [lo, hi]}
    log("full", json.dumps(row))
    return row


# ---------------------------------------------------------------------------
# stage-1 training
# ---------------------------------------------------------------------------

# The tiny step, cuda vs CPU, both f32 with TF32 off: only the order of sums
# differs (the CPU tests measure 1.6e-5 of each tensor's scale for the port
# against the JAX package on such a step). Loss relative; gradients and the
# AdamW moments within a share of each tensor's largest value.
TINY_TRAIN_TOL = {"loss": 1e-4, "grads": 1e-3, "exp_avg": 1e-3, "exp_avg_sq": 2e-3}
# 512² images: 10 self-attentions of >= 512 keys per UNet pass (4096 tokens:
# 2 down + 3 up; 1024 tokens: 2 down + 3 up) x 6 timesteps
K6_PER_STEP_512 = 60
# the differentiated GroupNorm layers of a 512² step: 6 timesteps × (the
# UNet's 61 + the VAE decoder's 30); the forward runs 1114 (each of these
# twice under remat, and the VAE encoder's 22)
GN_BWD_PER_STEP_512 = 546
TRAIN_512_STEPS = 5  # eager, captured, 3 replays


def train_labels(rng, size=64, classes=7):
    """A smooth class map: a coarse random field cut into ``classes`` bands."""
    import numpy as np
    from PIL import Image

    coarse = Image.fromarray((rng.random((4, 4)) * 255).astype(np.uint8))
    field = np.asarray(coarse.resize((size, size), Image.BICUBIC), np.float32)
    edges = np.quantile(field, np.linspace(0, 1, classes + 1)[1:-1])
    return np.digitize(field, edges).astype(np.int32)


def per_tensor_err(a_list, b_list):
    """Largest |a - b| / max|b| over paired tensors."""
    worst = 0.0
    for a, b in zip(a_list, b_list):
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, float((a.float().cpu() - b.float().cpu()).abs().max()) / scale)
    return worst


def phase_train_tiny(seed):
    """One stage-1 step at the tiny configs, f32, on cuda (kernels) and on the
    CPU (plain versions), from the same weights, noise and indices."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.losses.infonce import ContrastIndices, InfoNceLoss
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.normal(size=(1, 64, 64, 3)).astype(np.float32))
    labels = torch.from_numpy(train_labels(rng, classes=4)).long()[None]
    cfg = DiffusionTrainConfig(num_inference_steps=25, compute_dtype="float32", num_classes=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-VGG warning
        info = InfoNceLoss.create(device="cpu", num_anchors=16, num_negatives=64, num_classes=4)
    trainers = {}
    for dev in ("cpu", "cuda"):
        comps = SDComponents.random(seed=seed, device="cpu").to(dev)
        dev_info = InfoNceLoss(vgg=copy.deepcopy(info.vgg).to(dev), num_anchors=16,
                               num_negatives=64, num_classes=4)
        trainers[dev] = DiffusionWarmupTrainer(comps, cfg, info_nce=dev_info)
    noise, idx = trainers["cpu"].draw(images, labels)
    losses = {}
    reset_counters()
    for dev, tr in trainers.items():
        losses[dev], _ = tr.loss_and_grads(images.to(dev), labels.to(dev), noise.to(dev),
                                           ContrastIndices(*(t.to(dev) for t in idx)))
        tr.apply_update()
    torch.cuda.synchronize()
    launched = read_counters()
    cpu, cuda = trainers["cpu"], trainers["cuda"]
    errs = {"loss": abs(float(losses["cuda"]) - float(losses["cpu"])) / abs(float(losses["cpu"])),
            "grads": per_tensor_err([m.grad for m in cuda.master], [m.grad for m in cpu.master])}
    for key in ("exp_avg", "exp_avg_sq"):
        errs[key] = per_tensor_err([cuda.opt.state[m][key] for m in cuda.master],
                                   [cpu.opt.state[m][key] for m in cpu.master])
    row = {"loss_cpu": float(losses["cpu"]), "loss_cuda": float(losses["cuda"]),
           "errors": errs, "tol": TINY_TRAIN_TOL, "cuda_launches": launched}
    log("train_tiny", json.dumps(row))
    bad = {k: v for k, v in errs.items() if not v <= TINY_TRAIN_TOL[k]}
    if bad:
        raise AssertionError(f"train tiny: cuda vs cpu outside the tolerance: {bad}")
    if min(launched.values()) == 0:
        raise AssertionError(f"train tiny: a kernel was not launched on cuda: {launched}")
    return row


def train_pairs(root, n, rng):
    """n synthetic 64² ROI/label PNG pairs, labels in the tissue pixel code."""
    import argparse as ap

    import numpy as np
    from PIL import Image

    codes = np.array([0, 100, 150, 50, 200, 250, 255], np.uint8)  # class ids 0..6
    images, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(images)
    os.makedirs(labels)
    for i in range(n):
        tissue_like(rng, 64, 64).save(os.path.join(images, f"roi_{i}.png"))
        Image.fromarray(codes[train_labels(rng)]).save(os.path.join(labels, f"roi_{i}.png"))
    return ap.Namespace(image_dir=images, label_dir=labels, batch_size=1,
                        num_inference_steps=25, num_classes=7, num_epochs=1)


def sd15_components(seed, dtype):
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.models.clip_text import CLIPTextConfig
    from ldiffusion_tpu_torch.models.unet import UNet2DConditionConfig
    from ldiffusion_tpu_torch.models.vae import VAEConfig

    return SDComponents.random(seed=seed, dtype=dtype, device="cuda",
                               unet_config=UNet2DConditionConfig.sd15(),
                               vae_config=VAEConfig.sd15(), text_config=CLIPTextConfig.sd15())


def step_summary(trainer, launches):
    """A trainer's steps: the first eager, the second captured, the rest
    replays of its program (``core/graphs.py``)."""
    import numpy as np

    hist = trainer.history
    n = len(hist)
    programs = [p for p in trainer.program.programs.values() if p.graph is not None]
    return {"steps": n, "losses": [h["loss"] for h in hist],
            "contents": [h["content"] for h in hist],
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_s": [h["seconds"] for h in hist],
            "eager_step_s": hist[0]["seconds"], "capture_step_s": hist[1]["seconds"],
            "s_per_step_median_replays": float(np.median([h["seconds"] for h in hist[2:]])),
            "capture_s": sum(p.capture_s for p in programs),
            "replays": sum(p.replays for p in programs),
            "launches_per_step": {k: v / n for k, v in launches.items()}}


TRAIN_ROUTE_STEPS = 4
TRAIN_ROUTE_KEYS = ("loss", "content", "contrast", "grad_norm")


def max_abs_diff(a: list, b: list) -> float:
    """Largest |a - b| over paired tensors (one host read)."""
    import torch

    return float(torch.stack([(x.float() - y.float()).abs().max() for x, y in zip(a, b)]).max())


def train_route_check(seed):
    """The 64² reference configuration at SD-v1.5 width: ``TRAIN_ROUTE_STEPS``
    steps through ``train_step`` (eager, captured, replays; the Laplace and
    contrastive draws inside the graph) against as many calls of
    ``step_fn`` (the eager route), from the same weights and generator seed.
    Losses, gradient norms, masters and AdamW moments must be bit-equal, or
    within twice the difference between two eager runs from that state
    (kernels whose sums take no fixed order), which is measured and printed
    beside them. Then one replay, profiled."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    tr = DiffusionWarmupTrainer(sd15_components(seed + 4, torch.float32),
                                DiffusionTrainConfig(num_inference_steps=25, num_classes=7))
    rng = np.random.default_rng(seed + 4)
    batches = [tr_batch(rng, 64) for _ in range(TRAIN_ROUTE_STEPS)]
    start = [m.detach().clone() for m in tr.master]

    def run(captured: bool):
        with torch.no_grad():  # back to the first state: weights, AdamW, generator, programs
            for m, p, s0 in zip(tr.master, tr.params, start):
                m.copy_(s0)
                p.copy_(s0)
        tr.opt.state.clear()
        tr.generator.manual_seed(tr.cfg.seed)
        tr.program.programs.clear()
        values = []
        t0 = time.perf_counter()
        for images, labels in batches:
            if captured:
                m = tr.train_step(images, labels)
                values.append([m[k] for k in TRAIN_ROUTE_KEYS])
            else:
                out = tr.step_fn(torch.as_tensor(images, device="cuda"),
                                 torch.as_tensor(labels, device="cuda").long())
                values.append(torch.stack(out).tolist())
        torch.cuda.synchronize()
        st = tr.opt.state
        return time.perf_counter() - t0, {
            "values": [torch.tensor(values)], "masters": list(tr.master),
            "exp_avg": [st[m]["exp_avg"] for m in tr.master],
            "exp_avg_sq": [st[m]["exp_avg_sq"] for m in tr.master]}

    eager_s, first = run(False)
    first = {k: [t.clone() for t in ts] for k, ts in first.items()}
    eager_again_s, again = run(False)
    spread = {k: max_abs_diff(again[k], first[k]) for k in first}
    del again
    captured_s, got = run(True)
    diff = {k: max_abs_diff(got[k], first[k]) for k in first}
    (program,) = tr.program.programs.values()
    row = {"images": [64, 64], "steps": TRAIN_ROUTE_STEPS,
           "losses": first["values"][0][:, 0].tolist(),
           "captured_vs_eager_max_abs": diff, "eager_vs_eager_max_abs": spread,
           "bit_equal": all(v == 0.0 for v in diff.values()),
           "bound": "bit-equal, or at most twice the eager-vs-eager difference",
           "wall_s": {"eager": eager_s, "eager_again": eager_again_s, "programs": captured_s},
           "capture_s": program.capture_s, "replays": program.replays}
    del first, got
    row["profiled_replay"] = device_profile(lambda: tr.train_step(*batches[0]))
    row["profiled_replay_is_a_replay"] = program.replays == TRAIN_ROUTE_STEPS
    log("train_64_route", json.dumps(row))
    bad = {k: (diff[k], spread[k]) for k in diff if not diff[k] <= 2 * spread[k]}
    if bad or not row["profiled_replay_is_a_replay"]:
        raise AssertionError(f"train 64²: the captured steps left the eager route: {bad}")
    del tr, start
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_train(work, seed):
    """SD-v1.5-width stage-1 training: (a) 64² through the public API, read
    back by inference; (b) 512² through the trainer. Returns the launches of
    both runs (the training path's main path)."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.api import LDiffusionModel
    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.data.dataset import load_image
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    sections, t_mark = {}, [time.perf_counter()]

    def mark(name):  # the wall of each part of the phase, to trace the run's time
        now = time.perf_counter()
        sections[name] = now - t_mark[0]
        t_mark[0] = now

    phase_train_tiny(seed)
    mark("tiny")
    rng = np.random.default_rng(seed + 2)
    args = train_pairs(os.path.join(work, "train_pairs"), 5, rng)  # 70/30 → 3 steps
    seg = write_segmentor(os.path.join(work, "seg_train"), seg_plan(*FULL_PLAN), seed)
    roi = os.path.join(work, "train_readback_roi.png")
    tissue_like(rng, 1024, 1024).save(roi)

    # (a) the reference configuration, 64², through LDiffusionModel.train
    comps = sd15_components(seed, torch.float32)  # f32 masters; the trainer casts to bf16
    watch = {"unet.conv_in.weight": comps.unet.conv_in.weight,
             "unet.conv_out.weight": comps.unet.conv_out.weight,
             "proj.weight": comps.proj.weight}
    before = {k: v.detach().clone() for k, v in watch.items()}
    cfg = DiffusionTrainConfig(num_epochs=1, num_inference_steps=25, num_classes=7)
    model = LDiffusionModel("sd15-seeded-random", "tissue", components=comps,
                            work_dir=os.path.join(work, "train_work"), diffusion_config=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mark("64_setup")
    gn_watch = GnRouteWatch().__enter__()  # closed where the training main path ends
    reset_counters()  # the training main path starts here
    saved = model.train(args, component="ldiffusion")["ldiffusion"]
    torch.cuda.synchronize()
    mark("64_train_call")
    launches_64 = read_counters()
    peak_64 = torch.cuda.max_memory_allocated()
    tr = model.trainer
    names = [f"{k}.{n}" for k, n in tr.names]
    master = dict(zip(names, tr.master))
    moved = {k: not torch.equal(master[k], before[k]) for k in watch}
    row_a = {"images": [64, 64], "dtype": "bfloat16 compute, float32 masters",
             "peak_bytes": peak_64, **step_summary(tr, launches_64), "params_moved": moved,
             "saved": os.path.relpath(saved, work)}
    decoded, mask = model.inference_tissue(roi, saved, seg, 7)  # reads the trained UNet back
    unet = model._components.unet
    readback = all(torch.equal(p.detach(), master[f"unet.{n}"].to(p.dtype))
                   for n, p in unet.named_parameters())
    row_a.update(readback_equal=readback, readback_mask_shape=list(mask.shape))
    mark("64_readback")
    log("train_64", json.dumps(row_a))
    if not (all(np.isfinite(row_a["losses"])) and row_a["steps"] == 3 and all(moved.values())):
        raise AssertionError(f"train 64²: {row_a}")
    if launches_64["flash_attention_bwd"] != 0 or launches_64["flash_attention_fwd_lse"] != 0:
        raise AssertionError(f"train 64²: no attention has >= 512 keys, yet {launches_64}")
    if not readback or mask.shape != (1024, 1024) or decoded.size != (1024, 1024):
        raise AssertionError("train 64²: the saved UNet was not read back by inference")
    del model, tr, master, comps, unet, watch, before
    gc.collect()
    torch.cuda.empty_cache()

    # (b) 512² images, 64² labels, through the trainer: eager, captured, 3 replays
    comps = sd15_components(seed + 1, torch.float32)
    trainer = DiffusionWarmupTrainer(comps, DiffusionTrainConfig(num_inference_steps=25,
                                                                 num_classes=7),
                                     work_dir=os.path.join(work, "train_512"))
    w0 = trainer.master[0].detach().clone()
    img = os.path.join(work, "train_512.png")
    tissue_like(rng, 512, 512).save(img)
    images = load_image(img, (512, 512))[None]
    labels = train_labels(rng)[None]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the 64² run's blocks: the reserved peak is the 512² step's
    torch.cuda.reset_peak_memory_stats()
    counts_before = read_counters()
    routes_before = read_routes()
    shapes_before = dict(gn_watch.shapes)
    mark("512_setup")
    per_step = []
    for _ in range(TRAIN_512_STEPS):
        before = read_counters()
        trainer.train_step(images, labels)
        per_step.append({k: n - before[k] for k, n in read_counters().items()})
    torch.cuda.synchronize()
    mark("512_steps")
    total = read_counters()  # the training main path ends here
    routes = read_routes()
    gn_watch.__exit__(None, None, None)
    check_bf16_routes("train", routes)
    gn_watch.check("train", routes)
    n = TRAIN_512_STEPS
    gn_shapes_512 = {k: (c - shapes_before.get(k, 0)) / n for k, c in gn_watch.shapes.items()
                     if c > shapes_before.get(k, 0)}
    launches_512 = {k: total[k] - counts_before[k] for k in total}
    bwd_wgmma_512 = (routes["flash_attention_bwd"]["wgmma"]
                     - routes_before["flash_attention_bwd"]["wgmma"])
    row_b = {"images": [512, 512], "labels": [64, 64],
             "dtype": "bfloat16 compute, float32 masters",
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "max_memory_reserved": torch.cuda.max_memory_reserved(),
             **step_summary(trainer, launches_512),
             "launches_each_step": per_step,
             "launches_by_route_64_and_512": routes,
             "groupnorm_shapes_per_step": gn_shapes_512,
             "params_moved": not torch.equal(trainer.master[0], w0)}
    (program,) = trainer.program.programs.values()
    replays = program.replays
    row_b["profiled_replay"] = device_profile(lambda: trainer.train_step(images, labels))
    row_b["profiled_replay_is_a_replay"] = program.replays == replays + 1
    log("train_512", json.dumps(row_b))
    mark("512_profiled_replay")
    del trainer, comps
    gc.collect()
    torch.cuda.empty_cache()
    train_route_check(seed)
    mark("64_route_check")
    log("train_sections_s", json.dumps(sections))
    if not (all(np.isfinite(row_b["losses"])) and row_b["params_moved"]):
        raise AssertionError(f"train 512²: {row_b}")
    if not row_b["profiled_replay_is_a_replay"] or replays != n - 1:
        raise AssertionError(f"train 512²: {replays} replays in {n} steps, the profiled step "
                             f"a replay: {row_b['profiled_replay_is_a_replay']}")
    if any(step != per_step[0] for step in per_step[2:]) or \
            launches_512["flash_attention_bwd"] != n * K6_PER_STEP_512 or \
            bwd_wgmma_512 != n * K6_PER_STEP_512 or \
            launches_512["groupnorm_silu_backward"] != n * GN_BWD_PER_STEP_512:
        raise AssertionError(f"train 512²: the replays launched {per_step[2:]}, the eager step "
                             f"{per_step[0]}; flash_attention_bwd "
                             f"{launches_512['flash_attention_bwd']} times in {n} steps, "
                             f"{bwd_wgmma_512} on the wgmma route, expected "
                             f"{n * K6_PER_STEP_512}; groupnorm_silu_backward "
                             f"{launches_512['groupnorm_silu_backward']} times, expected "
                             f"{n * GN_BWD_PER_STEP_512}")
    if min(launches_512.values()) == 0:
        raise AssertionError(f"train 512²: a kernel was not launched: {launches_512}")
    return total, routes


# ---------------------------------------------------------------------------
# stage-2 segmentor training
# ---------------------------------------------------------------------------

# The tiny stage-2 step, cuda vs CPU, both f32 with TF32 off: only the order
# of sums differs (the CPU tests hold the port to the JAX package's step
# within 5e-5 of each tensor's largest value). Loss relative; parameters and
# momentum within a share of each tensor's largest value (both read 2.7e-6 on
# an H100, so 1e-4 leaves about 40x); the device DA applied to the same drawn
# parameters, absolute.
SEG_TINY_TOL = {"loss": 1e-4, "params": 1e-4, "momentum": 1e-4, "augment": 1e-4}
SEG_ROIS = 6  # 70/30 → 4 training ROIs (the 1024² plan's batch 2) and 2 held out
PUMA_CODES = (0, 100, 150, 50, 200, 250, 255)  # class ids 0..6 as tissue PNG values


def no_augment():
    from ldiffusion_tpu_torch.data.augment import AugmentConfig

    return AugmentConfig(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0,
                         p_brightness=0.0, p_contrast=0.0, p_lowres=0.0,
                         p_gamma_invert=0.0, p_gamma=0.0, p_mirror=0.0)


def seg_tensor_err(a: dict, b: dict) -> float:
    """Largest |a - b| / max|b| over the DynUNet's named tensors. A conv bias
    that feeds a norm (InstanceNorm or BatchNorm: every conv of a block,
    plain or residual) has a gradient of 0 in exact arithmetic (the norm
    removes the mean), so its gradient and momentum are rounding noise
    (≈ 1e-8) and its update ≈ lr times that: it is held absolutely (scale 1)."""
    import re

    worst = 0.0
    for k, ref in b.items():
        feeds_norm = re.search(r"\.(conv\d?|downsample_conv)\.bias$", k)
        scale = max(float(ref.abs().max()), 1.0 if feeds_norm else 1e-30)
        worst = max(worst, float((a[k].float().cpu() - ref.float().cpu()).abs().max()) / scale)
    return worst


def phase_seg_tiny(work, seed):
    """One stage-2 step at a tiny plan, f32, on cuda and on the CPU from the
    same weights and patches (DA off); and the device DA stack on both
    devices with the same drawn parameters."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.data.augment import (
        AugmentConfig,
        apply_augment,
        draw_augment_params,
    )
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer

    rng = np.random.default_rng(seed + 5)
    plan = seg_plan((32, 32), (8, 16, 32), (1, 2, 2))
    cfg = SegmentorTrainConfig(compute_dtype="float32")
    data = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    seg = np.stack([train_labels(rng, 32), train_labels(rng, 32)])
    trainers, losses = {}, {}
    for dev in ("cpu", "cuda"):  # the same seeded initialisation on both
        tr = SegmentorTrainer(plan, cfg, output_dir=os.path.join(work, f"seg_tiny_{dev}"),
                              augment=no_augment(), device=dev)
        losses[dev] = float(tr.loss_and_grads(*tr._to_device(data, seg)))
        tr.apply_update(lr=cfg.initial_lr)
        trainers[dev] = tr
    cpu, cuda = trainers["cpu"], trainers["cuda"]
    errs = {"loss": abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"]),
            "params": seg_tensor_err(dict(cuda.net.named_parameters()),
                                     dict(cpu.net.named_parameters())),
            "momentum": seg_tensor_err(cuda._momentum_state(), cpu._momentum_state())}
    every = AugmentConfig(p_rotation=0.0, p_scaling=0.0, p_noise=1.0, p_blur=1.0,
                          p_brightness=1.0, p_contrast=1.0, p_lowres=1.0,
                          p_gamma_invert=1.0, p_gamma=1.0, p_mirror=1.0)
    x = torch.from_numpy(data).permute(0, 3, 1, 2)
    drawn = draw_augment_params(x.shape, every, torch.Generator().manual_seed(seed))
    out_cpu = apply_augment(x, torch.from_numpy(seg), drawn, every)
    out_cuda = apply_augment(x.cuda(), torch.from_numpy(seg).cuda(),
                             {k: v.cuda() for k, v in drawn.items()}, every)
    errs["augment"] = float((out_cuda[0].cpu() - out_cpu[0]).abs().max())
    if not torch.equal(out_cuda[1].cpu(), out_cpu[1]):
        raise AssertionError("seg tiny: the device DA moved the labels differently")
    row = {"loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"], "errors": errs,
           "tol": SEG_TINY_TOL}
    log("seg_tiny", json.dumps(row))
    bad = {k: v for k, v in errs.items() if not v <= SEG_TINY_TOL[k]}
    if bad:
        raise AssertionError(f"seg tiny: cuda vs cpu outside the tolerance: {bad}")
    return row


SEG_ROUTE_STEPS = 3


def seg_route_check(tr, rng):
    """The 1024² plan's train and validation steps (the device DA on):
    ``SEG_ROUTE_STEPS`` train steps replayed through the program the epoch
    loop captured, against as many ``step_fn`` calls (the eager route) from
    the same parameters, momentum and generator state, and 2 validation
    steps replayed against ``_val_counts``: bit-equal, or within twice the
    difference between two eager runs (measured and printed). Also each
    route's allocated peak over those steps."""
    import numpy as np
    import torch

    shape = (tr.plan.batch_size, *tr.plan.patch_size)
    batches = [(rng.normal(size=(*shape, 3)).astype(np.float32),
                np.stack([train_labels(rng, shape[1]) for _ in range(shape[0])]))
               for _ in range(SEG_ROUTE_STEPS + 2)]
    params = list(tr.net.parameters())
    start = [p.detach().clone() for p in params]
    start_momentum = [tr.opt.state[p]["momentum_buffer"].clone() for p in params]
    gen_state = tr.generator.get_state()
    (train,), (val,) = tr.train_program.programs.values(), tr.val_program.programs.values()
    replays = (train.replays, val.replays)

    peaks = {}

    def run(captured: bool):
        with torch.no_grad():
            for p, p0, m0 in zip(params, start, start_momentum):
                p.copy_(p0)
                tr.opt.state[p]["momentum_buffer"].copy_(m0)
        tr.generator.set_state(gen_state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr.net.train()
        losses = []
        for data, seg in batches[:SEG_ROUTE_STEPS]:
            if captured:
                losses.append(float(tr.train_step(data, seg, lr=1e-3)))
            else:
                rate = torch.full((), 1e-3, dtype=torch.float32, device="cuda")
                losses.append(float(tr.step_fn(*tr._to_device(data, seg), rate)[0]))
        tr.net.eval()
        counts = []
        with torch.no_grad():
            for data, seg in batches[SEG_ROUTE_STEPS:]:
                out = tr.val_step(data, seg) if captured else \
                    tr._val_counts(*tr._to_device(data, seg))
                counts.extend(t.clone() for t in out)
        torch.cuda.synchronize()
        peaks["programs" if captured else "eager"] = torch.cuda.max_memory_allocated()
        return {"losses": [torch.tensor(losses)], "validation": counts,
                "params": [p.detach().clone() for p in params],
                "momentum": [tr.opt.state[p]["momentum_buffer"].clone() for p in params]}

    first = run(False)
    spread = {k: max_abs_diff(v, first[k]) for k, v in run(False).items()}
    diff = {k: max_abs_diff(v, first[k]) for k, v in run(True).items()}
    row = {"steps": SEG_ROUTE_STEPS, "validation_steps": 2,
           "captured_vs_eager_max_abs": diff, "eager_vs_eager_max_abs": spread,
           "bit_equal": all(v == 0.0 for v in diff.values()),
           "replayed": [train.replays - replays[0], val.replays - replays[1]],
           "epoch_loop_replays": {"train": replays[0], "validation": replays[1]},
           "capture_s": {"train": train.capture_s, "validation": val.capture_s},
           "max_memory_allocated_by_route": peaks,
           "memory_reserved": torch.cuda.memory_reserved()}
    bad = {k: (diff[k], spread[k]) for k in diff if not diff[k] <= 2 * spread[k]}
    if bad or row["replayed"] != [SEG_ROUTE_STEPS, 2]:
        raise AssertionError(f"seg: the captured steps left the eager route: {bad}, "
                             f"replayed {row['replayed']}")
    return row


# DiffusionTransform(batch_size=2) against batch 1 on the same ROIs: both bf16
# at SD-v1.5 width; cuDNN and cuBLAS may pick other algorithms (another
# summation order) at batch 2, and bf16 rounding spreads that through the
# UNet and the VAE decoder; a pad or misplaced row would move pixels by O(0.5)
SEG_BATCH2_MAX_ABS = 0.1
SEG_TRANSFORM_ROIS = 3  # batch 2: one full chunk and a padded one


def seg_transform_check(comps, paths):
    """The dataset build's DiffusionTransform on ``paths`` (1024² ROIs):
    batch 1 (the first use, the capture, a replay) against
    ``one_step_transform`` called eagerly on each ROI, bit for bit; batch 2
    over all of them twice (a full and a zero-padded chunk: the first use,
    the capture, then replays; launches counted from 0 over the four chunks)
    against the eager batch-2 route, bit for bit; batch 2's rows against
    batch 1's (SEG_BATCH2_MAX_ABS)."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.data.dataset import load_image
    from ldiffusion_tpu_torch.diffusion.pipeline import one_step_transform, trajectory_text_emb
    from ldiffusion_tpu_torch.segmentor.dataset_builder import DiffusionTransform

    images = np.stack([load_image(p, (1024, 1024)) for p in paths])
    n = len(images)
    tf1 = DiffusionTransform(comps)
    secs1, one = [], []
    for i in range(n):
        t0 = time.perf_counter()
        one.append(tf1(images[i:i + 1])[0])
        secs1.append(time.perf_counter() - t0)
    padded = np.concatenate([images, np.zeros((-n % 2,) + images.shape[1:], np.float32)])
    with torch.inference_mode():
        eager1 = [one_step_transform(comps, torch.from_numpy(images[i:i + 1]).cuda(),
                                     trajectory_text_emb(comps, 1)).float().cpu().numpy()[0]
                  for i in range(n)]
        eager2 = np.concatenate([
            one_step_transform(comps, torch.from_numpy(padded[i:i + 2]).cuda(),
                               trajectory_text_emb(comps, 2)).float().cpu().numpy()
            for i in range(0, len(padded), 2)])[:n]
    tf2 = DiffusionTransform(comps, batch_size=2)
    secs2, two = [], []
    reset_counters()  # batch 2's launches: four chunks
    for _ in range(2):
        t0 = time.perf_counter()
        two.append(tf2(images))
        secs2.append(time.perf_counter() - t0)
    launches = read_counters()
    chunks = 2 * (len(padded) // 2)  # two calls of two chunks
    (p1,), (p2,) = tf1.program.programs.values(), tf2.program.programs.values()
    row = {"rois": n, "batch1_s_per_roi": secs1, "batch2_s_per_call": secs2,
           "batch1_replays": p1.replays, "batch2_replays": p2.replays,
           "batch1_capture_s": p1.capture_s, "batch2_capture_s": p2.capture_s,
           "batch1_bit_equal_to_eager": all(np.array_equal(a, b) for a, b in zip(one, eager1)),
           "batch2_bit_equal_to_eager": all(np.array_equal(t, eager2) for t in two),
           "batch2_vs_batch1_max_abs": float(np.abs(two[0] - np.stack(one)).max()),
           "batch2_vs_batch1_mean_abs": float(np.abs(two[0] - np.stack(one)).mean()),
           "batch2_vs_batch1_bound": SEG_BATCH2_MAX_ABS,
           "batch2_launches_per_chunk": {k: launches[k] / chunks for k in INFERENCE_KERNELS}}
    ok = (row["batch1_bit_equal_to_eager"] and row["batch2_bit_equal_to_eager"]
          and row["batch2_vs_batch1_max_abs"] <= SEG_BATCH2_MAX_ABS
          and p1.replays == n - 1 and p2.replays == chunks - 1
          and row["batch2_launches_per_chunk"] == {"flash_attention_fwd": 17,
                                                   "groupnorm_silu": 113})
    return row, ok


def seg_pairs(root, n, rng, size=1024):
    """n synthetic size² ROI/label PNG pairs, labels in the tissue pixel code."""
    import argparse as ap

    import numpy as np
    from PIL import Image

    codes = np.array(PUMA_CODES, np.uint8)
    images, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(images)
    os.makedirs(labels)
    for i in range(n):
        tissue_like(rng, size, size).save(os.path.join(images, f"roi_{i}.png"))
        Image.fromarray(codes[train_labels(rng, size)]).save(os.path.join(labels, f"roi_{i}.png"))
    # num_epochs 12 → max(1, 12 - 10) = 2 segmentor epochs
    return ap.Namespace(image_dir=images, label_dir=labels, batch_size=1,
                        num_inference_steps=25, num_classes=7, num_epochs=12)


def phase_seg(work, seed):
    """Stage-2 training at SD-v1.5 width and the 1024²/7-class plan through
    ``LDiffusionModel.train(component="segmentor")``, 2 epochs × 4
    iterations, bf16; the written segmentor read back by inference."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch import native
    from ldiffusion_tpu_torch.api import LDiffusionModel
    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.models.convert import save_unet_dir
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan

    phase_seg_tiny(work, seed)
    rng = np.random.default_rng(seed + 3)
    args = seg_pairs(os.path.join(work, "seg_pairs"), SEG_ROIS, rng)
    comps = sd15_components(seed, torch.bfloat16)
    unet_dir = os.path.join(work, "seg_unet")
    t0 = time.perf_counter()
    save_unet_dir(unet_dir, comps.unet_config, comps.unet.state_dict(), comps.proj.state_dict())
    save_s = time.perf_counter() - t0
    unet_bytes = sum(os.path.getsize(os.path.join(unet_dir, f)) for f in os.listdir(unet_dir))
    cfg = SegmentorTrainConfig(iters_per_epoch=4, val_iters_per_epoch=2)
    model = LDiffusionModel("sd15-seeded-random", "tissue", components=comps,
                            work_dir=os.path.join(work, "seg_work"), segmentor_config=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_routes()
    with GnRouteWatch() as watch:
        reset_counters()  # the stage-2 main path starts here
        t0 = time.perf_counter()
        seg_dir = model.train(args, component="segmentor", ldiffusion_weight=unet_dir)["segmentor"]
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = read_counters()  # the stage-2 main path ends here
        routes = read_routes()
    peak = torch.cuda.max_memory_allocated()
    native_routes = copy.deepcopy(native.launches_by_route)
    check_bf16_routes("seg", routes)
    watch.check("seg", routes)
    if min(launches[k] for k in INFERENCE_KERNELS) == 0:
        raise AssertionError(f"seg: a kernel was not launched on the stage-2 path: {launches}")
    check_native_routes("seg", native_routes, NATIVE_2D)
    plan = SegPlan.load(os.path.join(seg_dir, "plans.json"))
    if (tuple(plan.patch_size), tuple(plan.features_per_stage), tuple(plan.strides),
            plan.batch_size, plan.num_classes) != (*FULL_PLAN, 2, 7):
        raise AssertionError(f"seg: the plan is not the 1024²/7-class plan: {plan}")
    fold = os.path.join(seg_dir, "fold_0")
    for rel in ("checkpoint_best.pkl", "checkpoint_final.pkl", "validation/summary.json",
                "postprocessing.json"):
        if not os.path.exists(os.path.join(fold, rel)):
            raise AssertionError(f"seg: fold_0/{rel} was not written")
    with open(os.path.join(fold, "validation", "summary.json")) as f:
        fg_dice = json.load(f)["foreground_mean"]["Dice"]
    if not math.isfinite(fg_dice):
        raise AssertionError(f"seg: the validation foreground Dice is {fg_dice}")
    roi = os.path.join(args.image_dir, "roi_0.png")
    _, mask = model.inference_tissue(roi, None, seg_dir, 7)  # the trained UNet is loaded
    if mask.shape != (1024, 1024) or int(mask.max()) >= 7:
        raise AssertionError(f"seg: inference from the trained segmentor: {mask.shape} "
                             f"max {mask.max()}")

    tr = model.seg_trainer
    prep = model.prepare_seconds
    epochs = len(tr.epoch_log.data["epoch_time"])
    (train_program,) = tr.train_program.programs.values()
    (val_program,) = tr.val_program.programs.values()
    loop_replays = {"train": train_program.replays, "validation": val_program.replays}
    # the first use runs eagerly; the capture replays once, every later use again
    if loop_replays != {"train": epochs * cfg.iters_per_epoch - 1,
                        "validation": epochs * cfg.val_iters_per_epoch - 1}:
        raise AssertionError(f"seg: the epoch loop replayed {loop_replays} in {epochs} epochs")
    route = seg_route_check(tr, rng)
    transform, transform_ok = seg_transform_check(
        comps, [os.path.join(args.image_dir, f"roi_{i}.png") for i in range(SEG_TRANSFORM_ROIS)])
    batch = (rng.normal(size=(2, 1024, 1024, 3)).astype(np.float32),
             np.stack([train_labels(rng, 1024), train_labels(rng, 1024)]))
    tr.net.train()
    prof = device_profile(lambda: tr.train_step(*batch, lr=1e-3))  # a replay
    row = {"plan": {"patch": list(plan.patch_size), "batch": plan.batch_size,
                    "features": list(plan.features_per_stage)},
           "rois": prep["rois"], "epochs": len(tr.epoch_log.data["epoch_time"]),
           "iters_per_epoch": cfg.iters_per_epoch, "dtype": "bfloat16 compute, float32 params",
           "unet_dir_write_s": save_s, "unet_dir_bytes": unet_bytes,
           "unet_dir_load_s": prep["load_unet_s"],
           "dataset_build_s_per_roi": prep["dataset_build_s"] / prep["rois"],
           "dataset_build_programs": prep["transform_programs"],
           "dataset_build_replays": prep["transform_replays"], "transform_check": transform,
           "plan_and_preprocess_s": prep["plan_and_preprocess_s"],
           "s_per_iteration_median_after_first": float(np.median(tr.iter_seconds[1:])),
           "s_per_iteration_median_replays": float(np.median(tr.iter_seconds[2:])),
           "iteration_s": tr.iter_seconds, "epoch_loop_replays": loop_replays,
           "route_check": route,
           "s_per_epoch_without_checkpoints": tr.epoch_log.data["epoch_time"],
           "checkpoint_write_s": tr.checkpoint_seconds,
           "checkpoint_bytes": os.path.getsize(os.path.join(fold, "checkpoint_final.pkl")),
           "validation_s_per_case": tr.val_case_seconds,
           "host_ms_per_batch_sampling_and_spatial_da": float(
               np.median(tr.host_batch_seconds[1:]) * 1e3),
           "train_call_s": train_s, "max_memory_allocated": peak,
           "max_memory_reserved": torch.cuda.max_memory_reserved(),
           "train_losses": tr.epoch_log.data["train_loss"],
           "val_foreground_dice": fg_dice,
           "launches": launches, "launches_by_route": routes,
           "launches_per_roi": {k: launches[k] / prep["rois"] for k in INFERENCE_KERNELS},
           "groupnorm_shapes": dict(watch.shapes), "native_routes": native_routes,
           "profiled_iteration": prof}
    log("seg_train", json.dumps(row))
    if not all(math.isfinite(v) for v in row["train_losses"]):
        raise AssertionError(f"seg: non-finite training loss {row['train_losses']}")
    # one program a build: the first ROI eager, the second captured, the rest replay
    if (prep["transform_programs"], prep["transform_replays"]) != (1, prep["rois"] - 1):
        raise AssertionError(f"seg: the dataset build ran {prep['transform_programs']} "
                             f"programs, {prep['transform_replays']} replays")
    if not transform_ok:
        raise AssertionError(f"seg: the DiffusionTransform check failed: {transform}")
    return row


# ---------------------------------------------------------------------------
# the cell level
# ---------------------------------------------------------------------------

CELL_CLASSES = 11
CELL_ROIS = 6  # 70/30 → 4 training ROIs and 2 validation ROIs
# Classes of the same ROI's instances on the card (f32, TF32 off) and on the
# CPU, same encoder and head: only the order of sums differs in the f32
# ResNet-152, so a class flips only where two logits tie to rounding.
CELL_CLASS_AGREEMENT = 0.99
CELL_MIN_INSTANCES = 300  # PUMA ROIs hold ~300-1100 nuclei
# The flow proposer's instance maps, card vs CPU: the same f32 net and
# integration in another summation order; a sink may round the other way.
CELL_PQ_AGREEMENT = 0.99
_ST_DTYPES = {"torch.bfloat16": "BF16", "torch.float32": "F32", "torch.int64": "I64"}


def write_safetensors(path, tensors):
    """A .safetensors file: u64 header length, a JSON header padded to 8 bytes,
    then each tensor's raw little-endian bytes."""
    import struct

    import torch

    header, offset, host = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_DTYPES[str(t.dtype)], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        host.append(t.reshape(-1).view(torch.uint8).numpy())
        offset += n
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in host:
            f.write(raw.data)


def write_sd_dir(root, comps):
    """``comps`` as a diffusers-layout SD directory in its dtype: unet/, vae/,
    text_encoder/ (safetensors + config.json, the text encoder with
    transformers' ``position_ids`` buffer) and a tokenizer/ whose BPE maps
    "A pathological slide" to CLIP's ids."""
    import torch

    u, v, t = comps.unet_config, comps.vae_config, comps.text_config
    configs = {
        "unet": {"in_channels": u.in_channels, "out_channels": u.out_channels,
                 "block_out_channels": list(u.block_out_channels),
                 "layers_per_block": u.layers_per_block,
                 "cross_attention_dim": u.cross_attention_dim,
                 "attention_head_dim": u.attention_head_dim, "norm_num_groups": u.norm_num_groups,
                 "down_block_types": list(u.down_block_types),
                 "up_block_types": list(u.up_block_types)},
        "vae": {"block_out_channels": list(v.block_out_channels),
                "layers_per_block": v.layers_per_block, "latent_channels": v.latent_channels,
                "norm_num_groups": v.norm_num_groups, "scaling_factor": v.scaling_factor},
        "text_encoder": {"vocab_size": t.vocab_size, "hidden_size": t.hidden_size,
                         "num_hidden_layers": t.num_layers,
                         "num_attention_heads": t.num_heads, "intermediate_size": t.mlp_dim,
                         "max_position_embeddings": t.max_positions}}
    text_sd = dict(comps.text.state_dict())
    text_sd["text_model.embeddings.position_ids"] = torch.arange(t.max_positions)[None]
    weights = {"unet": ("diffusion_pytorch_model.safetensors", comps.unet.state_dict()),
               "vae": ("diffusion_pytorch_model.safetensors", comps.vae.state_dict()),
               "text_encoder": ("model.safetensors", text_sd)}
    for sub, cfg in configs.items():
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "config.json"), "w") as f:
            json.dump(cfg, f)
        write_safetensors(os.path.join(root, sub, weights[sub][0]), weights[sub][1])
    vocab = {"<|startoftext|>": 49406, "<|endoftext|>": 49407, "a</w>": 320,
             "pathological</w>": 29018, "slide</w>": 10556}
    merges = []
    for word in ("pathological", "slide"):
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        cur = parts[0]
        for nxt in parts[1:]:
            merges.append(f"{cur} {nxt}")
            cur += nxt
            vocab.setdefault(cur, 1000 + len(vocab))
    os.makedirs(os.path.join(root, "tokenizer"))
    with open(os.path.join(root, "tokenizer", "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(root, "tokenizer", "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(merges) + "\n")


def nuclei_roi(rng, size=1024, spacing=34, keep=0.75):
    """A PUMA-like ROI: pink stroma and dark purple nuclei (ellipses, semi-axes
    4-10 px) on a jittered grid. Returns ((H, W, 3) float32 in [0, 1],
    (H, W) int32 nucleus ids)."""
    import numpy as np

    img = np.empty((size, size, 3), np.float32)
    img[:] = (0.92, 0.72, 0.84)
    img += rng.normal(0, 0.03, img.shape).astype(np.float32)
    inst = np.zeros((size, size), np.int32)
    k = 0
    half = spacing // 2
    for gy in range(half, size - half, spacing):
        for gx in range(half, size - half, spacing):
            if rng.random() > keep:
                continue
            cy, cx = gy + rng.uniform(-6, 6), gx + rng.uniform(-6, 6)
            a, b, th = rng.uniform(5, 10), rng.uniform(4, 7), rng.uniform(0, np.pi)
            y0, x0 = int(cy) - 11, int(cx) - 11
            yy, xx = np.mgrid[y0:y0 + 23, x0:x0 + 23]
            u = (yy - cy) * np.cos(th) + (xx - cx) * np.sin(th)
            v = -(yy - cy) * np.sin(th) + (xx - cx) * np.cos(th)
            m = (u / a) ** 2 + (v / b) ** 2 <= 1
            k += 1
            inst[y0:y0 + 23, x0:x0 + 23][m] = k
            img[y0:y0 + 23, x0:x0 + 23][m] = (np.array((0.35, 0.18, 0.45))
                                              + rng.normal(0, 0.03, 3))
    return np.clip(img, 0, 1), inst


def crowded_roi(rng, size=1024, tile=64):
    """Bright touching cells on a dark ground, the flow nets' training scenes
    (chains of 2-3 disks of radius 3-7.5 px, neighbours touching) tiled over
    size²: (H, W, 3) float32 in [0, 1]."""
    import numpy as np

    img = np.full((size, size), 0.1, np.float32)
    yy, xx = np.mgrid[:tile, :tile].astype(np.float32)
    for ty in range(0, size, tile):
        for tx in range(0, size, tile):
            for _ in range(int(rng.integers(2, 4))):
                cy, cx = rng.uniform(12, tile - 12, 2)
                prev = None
                for _ in range(int(rng.integers(2, 4))):
                    r = float(rng.uniform(3.0, 7.5))
                    if prev is not None:
                        ang = rng.uniform(0, 2 * np.pi)
                        cy = float(np.clip(cy + 0.95 * (prev + r) * np.sin(ang), 6, tile - 6))
                        cx = float(np.clip(cx + 0.95 * (prev + r) * np.cos(ang), 6, tile - 6))
                    m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
                    img[ty:ty + tile, tx:tx + tile][m] = rng.uniform(0.55, 0.9)
                    prev = r
    img += rng.normal(0, 0.03, img.shape).astype(np.float32)
    return np.clip(np.stack([img] * 3, -1), 0, 1)


def cell_pairs(root, n, rng, size=1024):
    """n synthetic size² nuclei ROIs and their 11-class cell label PNGs (PUMA
    cell pixel codes 25·class)."""
    import argparse as ap

    import numpy as np
    from PIL import Image

    images, labels = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(images)
    os.makedirs(labels)
    for i in range(n):
        img, inst = nuclei_roi(rng, size)
        classes = rng.integers(1, CELL_CLASSES, inst.max() + 1)
        classes[0] = 0
        Image.fromarray((img * 255).astype(np.uint8)).save(os.path.join(images, f"roi_{i}.png"))
        Image.fromarray((classes[inst] * 25).astype(np.uint8)).save(
            os.path.join(labels, f"roi_{i}.png"))
    # num_epochs 12 → max(1, 12 - 10) = 2 cell epochs
    return ap.Namespace(image_dir=images, label_dir=labels, batch_size=1,
                        num_inference_steps=25, num_classes=CELL_CLASSES, num_epochs=12)


CELL_STEPS = 4  # the flow-net and head steps of each route check


def timed_call(fn):
    """(host seconds of ``fn()`` to a sync, clones of its tensor outputs)."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return secs, [t.clone() for t in (out if isinstance(out, (tuple, list)) else (out,))]


def program_family(jit, call, eager, calls=5):
    """One program of ``jit`` through ``call()`` ``calls`` times: the first
    use (eager), the captured call, replays; its outputs against the first
    use's bit for bit; ``eager()`` (the program's function called directly)
    3 times. Figures: programs made, replays, capture s, the first use's and
    the captured call's s, the median replayed and eager s."""
    import numpy as np
    import torch

    before = set(jit.programs)
    runs = [timed_call(call) for _ in range(calls)]
    with torch.inference_mode():
        eager_s = [timed_call(eager)[0] for _ in range(3)]
    first = runs[0][1]
    bit_equal = all(torch.equal(a, b) for _, outs in runs[1:] for a, b in zip(outs, first))
    new = [p for k, p in jit.programs.items() if k not in before]
    return {"programs": len(new), "replays": sum(p.replays for p in new),
            "capture_s": sum(p.capture_s for p in new), "first_use_s": runs[0][0],
            "captured_call_s": runs[1][0],
            "replay_s": float(np.median([t for t, _ in runs[2:]])),
            "eager_s": float(np.median(eager_s)), "bit_equal_to_first_use": bit_equal}


def step_route(make, batches, state):
    """``len(batches)`` training steps of a trainer from ``make()`` through
    ``trainer.step`` (its program: eager, captured, replays) and, from a
    fresh ``make()``, through ``trainer.step_fn`` called eagerly, twice:
    ``state(trainer, losses)`` of each run held captured against eager,
    bit-equal or within twice the two eager runs' difference. cuDNN runs its
    deterministic algorithms. Figures: each route's step seconds, programs,
    replays, capture s, the differences."""
    import numpy as np
    import torch

    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for route in ("captured", "eager", "eager_again"):
            tr = make()
            losses, secs = [], []
            for batch in batches:
                t0 = time.perf_counter()
                losses.append(tr.step(*batch) if route == "captured"
                              else float(tr.step_fn(*batch)))
                secs.append(time.perf_counter() - t0)
            runs[route] = (tr, secs, state(tr, losses))
    finally:
        torch.backends.cudnn.deterministic = kept
    tr, secs, captured = runs["captured"]
    _, eager_secs, eager = runs["eager"]
    eager_again = runs["eager_again"][2]
    diffs = {k: max_abs_diff(captured[k], eager[k]) for k in eager}
    spread = {k: max_abs_diff(eager_again[k], eager[k]) for k in eager}
    programs = list(tr.program.programs.values())
    row = {"steps": len(batches), "programs": len(programs),
           "replays": sum(p.replays for p in programs),
           "capture_s": sum(p.capture_s for p in programs), "captured_step_s": secs,
           "replayed_step_s": float(np.median(secs[2:])),
           "eager_step_s": float(np.median(eager_secs[1:])),
           "max_abs_diff_captured_vs_eager": diffs, "max_abs_diff_eager_vs_eager": spread,
           "bit_equal": all(d == 0.0 for d in diffs.values())}
    bad = {k: (diffs[k], spread[k]) for k in diffs if diffs[k] > 2 * spread[k]}
    return row, bad


def adamw_state(params, opt, losses):
    import torch

    params = list(params)
    st = opt.state
    return {"losses": [torch.tensor(losses)], "params": [p.detach().clone() for p in params],
            "exp_avg": [st[p]["exp_avg"].clone() for p in params],
            "exp_avg_sq": [st[p]["exp_avg_sq"].clone() for p in params]}


def flow_batches(rng, n, batch=4, size=64):
    """n batches of ``batch`` size² crowded-cell scenes (the flow nets'
    training scenes) and their masks_to_flows targets on the card."""
    import numpy as np
    import torch
    from scipy import ndimage

    from ldiffusion_tpu_torch.cell.instance import masks_to_flows

    out = []
    for _ in range(n):
        imgs = [crowded_roi(rng, size, size) for _ in range(batch)]
        masks = [ndimage.label(im[..., 0] > 0.4)[0] for im in imgs]
        out.append((torch.from_numpy(np.stack(imgs)).cuda(),
                    torch.from_numpy(np.stack([masks_to_flows(m) for m in masks])).cuda()))
    return out


def cell_programs(rng, ckpt, image, crowded):
    """The cell level's programs on the card: follow_flows by method, the
    proposer's _device_propose at the 1024² crowded ROI, classify_rois at
    the PUMA-density ROI's bucket (program families: replays bit-equal to
    the first use); cache_features of two ROIs of one bucket, twice (the
    second time both replay: each entry equal to its ROI's eager features
    bit for bit, the entries distinct); the head step on those features and
    the flow-net step at the artifact's width (features 32-64-128, batch 4,
    64² scenes), captured against eager (``step_route``)."""
    import torch

    from ldiffusion_tpu_torch.cell.classifier import (
        CellSegClassifier,
        CellTrainer,
        extract_instance_boxes,
    )
    from ldiffusion_tpu_torch.cell.instance import FlowNetProposer, FlowNetTrainer

    out, bad = {}, {}
    prop = FlowNetProposer.load_pretrained("transformed", device="cuda")
    x = torch.from_numpy(crowded).cuda()
    with torch.inference_mode():
        net_out = prop._net_out(x)
        flows, prob = net_out[..., :2] / 5.0, torch.sigmoid(net_out[..., 2])
    for method in ("squaring", "euler"):
        out[f"follow_flows_{method}"] = program_family(
            prop.programs["follow_flows"], lambda m=method: prop.follow(flows, prob, m),
            lambda m=method: prop._follow(flows, prob, n_iter=prop.n_iter, method=m,
                                          prob_threshold=prop.prob_threshold))
    out["device_propose"] = program_family(
        prop.programs["propose"], lambda: prop._device_propose(crowded),
        lambda: prop._propose_out(x, n_iter=prop.n_iter, prob_threshold=prop.prob_threshold))
    del prop, x, net_out, flows, prob

    clf = CellSegClassifier(CELL_CLASSES, device="cuda")
    clf.load(ckpt)
    ids, boxes = extract_instance_boxes(clf.proposer.propose(image))
    img_t = torch.from_numpy(image).cuda()
    bb_t = torch.from_numpy(clf.pad_boxes(boxes)).cuda()
    out["classify_rois"] = program_family(clf.programs["roi_logits"],
                                          lambda: clf.programs["roi_logits"](img_t, bb_t),
                                          lambda: clf._roi_logits(img_t, bb_t))
    out["classify_rois"].update(instances=len(ids), bucket=clf._bucket(len(ids)))

    pairs = []
    for _ in range(2):
        roi, inst = nuclei_roi(rng)
        classes = rng.integers(1, CELL_CLASSES, inst.max() + 1)
        classes[0] = 0
        pairs.append((roi, classes[inst].astype("int32")))
    tr = CellTrainer(clf)
    tr.cache_features(pairs)  # the first use, then the capture
    cache = tr.cache_features(pairs)  # both replay
    buckets = [int(entry[0].shape[0]) for entry in cache]
    own = True
    with torch.inference_mode():
        for (roi, _), (feats, _, _) in zip(pairs, cache):
            _, boxes = extract_instance_boxes(clf.proposer.propose(roi))
            want = clf._roi_features(torch.from_numpy(roi).cuda(),
                                     torch.from_numpy(clf.pad_boxes(boxes)).cuda())
            own = own and torch.equal(feats, want)
    distinct = (not torch.equal(cache[0][0], cache[1][0])
                and cache[0][0].data_ptr() != cache[1][0].data_ptr())
    same = len(set(buckets)) == 1
    feats_programs = list(clf.programs["roi_features"].programs.values())
    out["cache_features"] = {"buckets": buckets, "programs": len(feats_programs),
                             "replays": sum(p.replays for p in feats_programs),
                             "entries_equal_their_rois_eager_features": own,
                             "entries_distinct": distinct}
    if not (same and own and distinct):
        bad["cache_features"] = out["cache_features"]

    head0 = {k: v.clone() for k, v in clf.head.state_dict().items()}

    def head_trainer():
        clf.head.load_state_dict(head0)
        return CellTrainer(clf)

    batches = [cache[i % 2] for i in range(CELL_STEPS)]
    out["head_step"], bad_head = step_route(
        head_trainer, batches, lambda t, losses: adamw_state(clf.head.parameters(), t.opt, losses))
    out["head_step"]["bucket"] = buckets[0]
    del tr, cache, clf, batches
    gc.collect()
    torch.cuda.empty_cache()

    def flow_trainer():
        return FlowNetTrainer(FlowNetProposer.load_pretrained("transformed", device="cuda"))

    out["flownet_step"], bad_flow = step_route(
        flow_trainer, flow_batches(rng, CELL_STEPS),
        lambda t, losses: adamw_state(t.proposer.net.parameters(), t.opt, losses))
    out["flownet_step"].update(features=[32, 64, 128], batch=4, size=64)
    bad.update({f"head_step {k}": v for k, v in bad_head.items()})
    bad.update({f"flownet_step {k}": v for k, v in bad_flow.items()})
    for name, fam in out.items():
        if fam.get("bit_equal_to_first_use") is False:
            bad[name] = "a replay differs from the first use"
        if not fam["programs"] or not fam["replays"]:
            bad[name] = f"programs {fam['programs']}, replays {fam['replays']}"
    return out, bad


def phase_cell(work, seed):
    """The cell level at SD-v1.5 + ResNet-152 width, 11 classes: (1) the
    diffusers-directory loader, bit-equal to the in-memory bundle; (2)
    ``train(component="segmentor")`` and ``inference`` through the API; (3)
    the classifier at PUMA density, card vs CPU; (4) the flow proposer at
    1024², card vs CPU."""
    import numpy as np
    import torch
    from PIL import Image

    from ldiffusion_tpu_torch.api import LDiffusionModel
    from ldiffusion_tpu_torch.cell.classifier import (
        CellSegClassifier,
        extract_instance_boxes,
        roi_resize_64,
    )
    from ldiffusion_tpu_torch.cell.instance import FlowNetProposer
    from ldiffusion_tpu_torch.data.dataset import load_image
    from ldiffusion_tpu_torch.diffusion.pipeline import (
        DEFAULT_PROMPT_IDS,
        one_step_transform,
        trajectory_text_emb,
    )
    from ldiffusion_tpu_torch.evaluate import panoptic_quality
    from ldiffusion_tpu_torch.models.convert import save_unet_dir

    rng = np.random.default_rng(seed + 7)
    row = {"classes": CELL_CLASSES, "rois": CELL_ROIS, "dtype": "bfloat16 SD, float32 ResNet-152"}

    # (1) the loader at full width: write the bundle as a diffusers directory
    comps = sd15_components(seed, torch.bfloat16)
    sd_dir = os.path.join(work, "sd15_dir")
    t0 = time.perf_counter()
    write_sd_dir(sd_dir, comps)
    row["sd_dir_write_s"] = time.perf_counter() - t0
    row["sd_dir_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                              for d, _, fs in os.walk(sd_dir) for f in fs)
    model = LDiffusionModel(sd_dir, "cell", work_dir=os.path.join(work, "cell_work"))
    t0 = time.perf_counter()
    loaded = model._load_components()  # no components=: the directory, bf16
    torch.cuda.synchronize()
    row["sd_dir_load_s"] = time.perf_counter() - t0
    if loaded.prompt_ids != DEFAULT_PROMPT_IDS:
        raise AssertionError(f"cell: the tokenizer gave {loaded.prompt_ids}")
    # the projection is not in a diffusers directory: carried over (the load
    # draws its own from a seed)
    loaded.proj.load_state_dict(comps.proj.state_dict())
    roi = os.path.join(work, "cell_loader_roi.png")
    Image.fromarray((nuclei_roi(rng)[0] * 255).astype(np.uint8)).save(roi)
    with torch.inference_mode():
        x = torch.from_numpy(load_image(roi, (1024, 1024)))[None].cuda()
        outs = [one_step_transform(c, x, trajectory_text_emb(c, 1)) for c in (comps, loaded)]
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError("cell: the directory's transform differs from the in-memory "
                             f"bundle's by {float((outs[0] - outs[1]).abs().max())}")
    row["loader_transform_bit_equal"] = True
    del comps, outs
    gc.collect()
    torch.cuda.empty_cache()

    # (2) training and inference through the API
    args = cell_pairs(os.path.join(work, "cell_pairs"), CELL_ROIS, rng)
    unet_dir = os.path.join(work, "cell_unet")
    save_unet_dir(unet_dir, loaded.unet_config, loaded.unet.state_dict(),
                  loaded.proj.state_dict())
    wide = os.path.join(work, "cell_wide.png")
    Image.fromarray((nuclei_roi(rng)[0][:768] * 255).astype(np.uint8)).save(wide)
    square = os.path.join(args.image_dir, "roi_0.png")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with GnRouteWatch() as watch:
        reset_counters()  # the cell path starts here
        t0 = time.perf_counter()
        ckpt = model.train(args, component="segmentor", ldiffusion_weight=unet_dir)["segmentor"]
        torch.cuda.synchronize()
        row["train_call_s"] = time.perf_counter() - t0
        per_roi = {}
        for name, path in (("square", square), ("non_square", wide)):
            t0 = time.perf_counter()
            decoded, mask = model.inference(path, None, os.path.dirname(ckpt), CELL_CLASSES)
            torch.cuda.synchronize()
            with Image.open(path) as f:
                size = f.size
            if decoded.size != size or mask.shape != size[::-1] or int(mask.max()) >= CELL_CLASSES:
                raise AssertionError(f"cell: inference on {name}: decoded {decoded.size}, mask "
                                     f"{mask.shape} max {mask.max()}, image {size}")
            per_roi[name] = {"s": time.perf_counter() - t0, **model.cell_seconds}
        launches = read_counters()  # the cell path ends here
        routes = read_routes()
    row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    check_bf16_routes("cell", routes)
    watch.check("cell", routes)
    if min(launches[k] for k in INFERENCE_KERNELS) == 0:
        raise AssertionError(f"cell: a kernel was not launched on the cell path: {launches}")
    if not os.path.exists(ckpt):
        raise AssertionError(f"cell: no checkpoint at {ckpt}")
    tr = model.cell_trainer
    transforms = CELL_ROIS + len(per_roi)  # every train/validation ROI, then each inference
    per_roi_launches = {k: launches[k] / transforms for k in INFERENCE_KERNELS}
    api_programs = {name: program_stats({name: jit.programs}) for name, jit in (
        ("head_step", tr.program), ("classify_rois", tr.model.programs["roi_logits"]),
        ("roi_features", tr.model.programs["roi_features"]))}
    row.update({"checkpoint": os.path.relpath(ckpt, work), "inference": per_roi,
                "feature_cache_s": tr.feature_cache_seconds, "s_per_epoch": tr.epoch_seconds,
                "launches": launches, "launches_by_route": routes,
                "launches_per_roi": per_roi_launches, "api_programs": api_programs,
                "groupnorm_shapes": dict(watch.shapes)})
    # the training ROIs' transforms replay from the third (one DiffusionTransform
    # a build): each still counts one ROI's launches
    if per_roi_launches != {"flash_attention_fwd": 17, "groupnorm_silu": 113}:
        raise AssertionError(f"cell: launches per ROI {per_roi_launches}")
    if not api_programs["head_step"]["replays"]:
        raise AssertionError(f"cell: the head step never replayed: {api_programs}")
    row["profiled_inference"] = device_profile(
        lambda: model.inference(square, None, os.path.dirname(ckpt), CELL_CLASSES))
    del model, loaded, tr
    gc.collect()
    torch.cuda.empty_cache()

    # (3) the classifier at PUMA density, untransformed ROI, ResNet-152: the
    # card (TF32 off) against the CPU, then as shipped (TF32 on) on a
    # classifier of its own (a program keeps the TF32 setting of its capture)
    image, _ = nuclei_roi(rng)
    clf = {dev: CellSegClassifier(CELL_CLASSES, device=dev) for dev in ("cuda", "cpu")}
    for c in clf.values():
        c.load(ckpt)
    instances = clf["cuda"].proposer.propose(image)
    ids, boxes = extract_instance_boxes(instances)
    classes = {dev: c.classify_rois(image, boxes) for dev, c in clf.items()}
    agree = float(np.mean(classes["cuda"] == classes["cpu"]))
    bucket = CellSegClassifier._bucket(len(ids))
    bb = torch.from_numpy(clf["cuda"].pad_boxes(boxes)).cuda()
    img_t = torch.from_numpy(image).cuda()
    with torch.inference_mode():
        patches = (roi_resize_64(img_t, bb) - clf["cuda"]._norm[0]) / clf["cuda"]._norm[1]
        enc_ms = cuda_ms(lambda: clf["cuda"].encode(patches), 3)
        torch.backends.cudnn.allow_tf32 = True
        enc_tf32_ms = cuda_ms(lambda: clf["cuda"].encode(patches), 3)
        torch.backends.cudnn.allow_tf32 = False
        resize_ms = cuda_ms(lambda: roi_resize_64(img_t, bb), 10)
    del clf, patches
    shipped_clf = CellSegClassifier(CELL_CLASSES, device="cuda")
    shipped_clf.load(ckpt)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN: as shipped
    shipped = []
    for _ in range(4):  # the first use, the capture, replays
        shipped_clf.predict_mask(image)
        shipped.append(dict(shipped_clf.last_predict))
    torch.backends.cudnn.allow_tf32 = False
    row["classifier_puma_density"] = {
        "instances": len(ids), "bucket": bucket, "class_agreement_cuda_cpu": agree,
        "min_agreement": CELL_CLASS_AGREEMENT, "predict_mask_tf32_as_shipped": shipped,
        "resnet152_ms_per_bucket_f32": enc_ms, "resnet152_ms_per_bucket_tf32": enc_tf32_ms,
        "roi_resize_64_ms": resize_ms}
    if len(ids) < CELL_MIN_INSTANCES:
        raise AssertionError(f"cell: {len(ids)} instances, fewer than {CELL_MIN_INSTANCES}")
    if agree < CELL_CLASS_AGREEMENT:
        raise AssertionError(f"cell: card and CPU classes agree on only {agree:.4%}")
    del shipped_clf
    gc.collect()
    torch.cuda.empty_cache()

    # (4) the cell level's programs (cell_programs), then the flow proposer
    # at 1024², card vs CPU
    crowded = crowded_roi(rng)
    row["programs"], bad = cell_programs(rng, ckpt, image, crowded)
    props = {dev: FlowNetProposer.load_pretrained("transformed", device=dev)
             for dev in ("cuda", "cpu")}
    maps = {dev: p.propose(crowded) for dev, p in props.items()}
    times = []
    for _ in range(3):  # the capture, replays
        t0 = time.perf_counter()
        props["cuda"].propose(crowded)
        times.append(time.perf_counter() - t0)
    pq = panoptic_quality(maps["cuda"], maps["cpu"])["pq"]
    row["flow_proposer"] = {"instances_cuda": int(maps["cuda"].max()),
                            "instances_cpu": int(maps["cpu"].max()), "pq_cuda_vs_cpu": pq,
                            "min_pq": CELL_PQ_AGREEMENT, "propose_s": times,
                            "n_iter": props["cuda"].n_iter}
    log("cell", json.dumps(row))
    if bad:
        raise AssertionError(f"cell: the programs' checks failed: {bad}")
    if pq < CELL_PQ_AGREEMENT or not maps["cuda"].max():
        raise AssertionError(f"cell: flow proposer card vs CPU PQ {pq}, "
                             f"{maps['cuda'].max()} instances")
    return row


# ---------------------------------------------------------------------------
# the segmentor command line
# ---------------------------------------------------------------------------

CLI_ROIS = 6        # training cases of both datasets (fold 0: 4 train, 2 validation)
CLI_TEST_ROIS = 2   # imagesTs, predicted by each run
CLI_IGNORE = 7      # the ignore label of dataset 1, painted on a band of each label map
CLI_REGIONS = {"background": 0, "tissue": [1, 2, 3, 4, 5, 6], "c12": [1, 2], "c1": [1]}
CLI_REGIONS_ORDER = [6, 2, 1]
RESENC_M_PLAN = ((512, 512), 2, (32, 64, 128, 256, 512, 512, 512), (1, 3, 4, 6, 6, 6, 6))
# A mask of the same f32 net and checkpoint on the card (TF32 off) and on the
# CPU: only the order of sums differs, so a pixel flips only where two logits
# tie to rounding (the tiny phase's image-level tolerance).
CLI_MASK_AGREEMENT = 0.995
# float16 probabilities: 7 values each within 2^-11 relative, so a softmax
# row sums to 1 within 7·2^-12.
NPZ_SUM_TOL = 4e-3


def cli_tiny(seed):
    """The pieces this slice adds, tiny, f32, on cuda against the CPU from the
    same values: a BatchNorm ResEnc DynUNet's training forward, backward and
    running statistics; two Adan steps; the regions loss with an ignore mask
    and its gradient; the DA5 stack with fixed draws."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.optim import Adan
    from ldiffusion_tpu_torch.data.augment import apply_augment, draw_augment_params
    from ldiffusion_tpu_torch.losses.dice import dc_and_focal_sigmoid_loss
    from ldiffusion_tpu_torch.models.dynunet import DynUNet, DynUNetConfig
    from ldiffusion_tpu_torch.models.layers import init_random_
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    rng = np.random.default_rng(seed + 8)
    errs = {}
    cfg = DynUNetConfig(in_channels=3, num_classes=3, features_per_stage=(8, 16, 32),
                        strides=(1, 2, 2), norm="batch", block_type="residual",
                        n_blocks_per_stage=(1, 2, 2))
    cpu = init_random_(DynUNet(cfg), torch.Generator().manual_seed(seed))
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(rng.normal(size=(2, 3, 32, 32)).astype(np.float32))
    outs = {}
    for name, net in (("cpu", cpu), ("cuda", gpu)):
        heads = net(x.to(next(net.parameters()).device), train=True)
        sum(h.square().mean() for h in heads).backward()
        outs[name] = heads
    errs["batchnorm_resenc_forward"] = per_tensor_err([h.detach() for h in outs["cuda"]],
                                                      [h.detach() for h in outs["cpu"]])
    errs["batchnorm_resenc_grads"] = seg_tensor_err(
        {k: p.grad for k, p in gpu.named_parameters()},
        {k: p.grad for k, p in cpu.named_parameters()})
    errs["batchnorm_running_stats"] = per_tensor_err(
        [b for k, b in gpu.named_buffers() if "running" in k],
        [b for k, b in cpu.named_buffers() if "running" in k])
    params = {"cpu": [p.detach().clone() for p in cpu.parameters()]}
    params["cuda"] = [p.cuda() for p in params["cpu"]]
    grads = [[torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32))
              for p in params["cpu"]] for _ in range(2)]
    for name, ps in params.items():
        ps = [torch.nn.Parameter(p) for p in ps]
        opt = Adan(ps, lr=1e-2, weight_decay=3e-5)
        for step in grads:
            for p, g in zip(ps, step):
                p.grad = g.to(p.device)
            opt.step()
        params[name] = ps
    errs["adan"] = per_tensor_err([p.detach() for p in params["cuda"]],
                                  [p.detach() for p in params["cpu"]])
    logits = torch.from_numpy(rng.normal(size=(2, 3, 16, 16)).astype(np.float32))
    regions = torch.from_numpy((rng.random((2, 3, 16, 16)) < 0.4).astype(np.float32))
    mask = torch.from_numpy((rng.random((2, 16, 16)) < 0.8).astype(np.float32))
    loss = {}
    for name in ("cpu", "cuda"):
        lg = logits.to(name).clone().requires_grad_(True)  # a leaf on each device
        val = dc_and_focal_sigmoid_loss(lg, regions.to(name), loss_mask=mask.to(name))
        val.backward()
        loss[name] = (val.detach(), lg.grad)
    errs["regions_loss"] = per_tensor_err([loss["cuda"][0].reshape(1), loss["cuda"][1]],
                                          [loss["cpu"][0].reshape(1), loss["cpu"][1]])
    da5 = dataclasses.replace(get_variant("nnUNetTrainerDA5").augment, p_rotation=0.0,
                              p_scaling=0.0)
    da5 = dataclasses.replace(da5, **{k: 1.0 for k in (
        "p_rot90", "p_transpose", "p_median", "p_noise", "p_blur", "p_brightness",
        "p_contrast", "p_gamma_invert", "p_gamma", "p_mirror", "p_blank_rect",
        "p_brightness_gradient", "p_local_gamma", "p_sharpen")})
    data = torch.from_numpy(rng.normal(size=(2, 3, 32, 32)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 4, (2, 32, 32)))
    drawn = draw_augment_params(data.shape, da5, torch.Generator().manual_seed(seed))
    d_cpu, s_cpu = apply_augment(data, seg, drawn, da5)
    d_gpu, s_gpu = apply_augment(data.cuda(), seg.cuda(),
                                 {k: v.cuda() for k, v in drawn.items()}, da5)
    errs["da5"] = per_tensor_err([d_gpu], [d_cpu])
    if not torch.equal(s_gpu.cpu(), s_cpu):
        raise AssertionError("cli tiny: the DA5 stack moved the labels differently")
    row = {"errors": errs, "tol": CLI_TINY_TOL}
    log("cli_tiny", json.dumps(row))
    bad = {k: v for k, v in errs.items() if not v <= CLI_TINY_TOL}
    if bad:
        raise AssertionError(f"cli tiny: cuda vs cpu outside {CLI_TINY_TOL}: {bad}")
    return row


# the new pieces' tiny cuda-vs-CPU checks, relative to each tensor's scale:
# f32 on both sides, only the order of sums differs (the seg phase's bound)
CLI_TINY_TOL = 1e-4


def cli_datasets(work, seed):
    """Six synthetic 1024² PUMA training pairs and two test pairs through the
    one-step transform of seeded random SD-v1.5-width bf16 components
    (``build_transformed_dataset``), then two dataset.json regimes over the
    same images: Dataset001 the seven labels with ``"ignore": 7`` painted on a
    band of each label map, Dataset002 nested regions. Returns the raw root
    and the build's launches, routes and seconds."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from ldiffusion_tpu_torch.segmentor.dataset_builder import (
        DiffusionTransform,
        build_transformed_dataset,
    )

    rng = np.random.default_rng(seed + 9)
    pairs = seg_pairs(os.path.join(work, "cli_pairs"), CLI_ROIS + CLI_TEST_ROIS, rng)
    imgs = sorted(os.path.join(pairs.image_dir, f) for f in os.listdir(pairs.image_dir))
    labs = sorted(os.path.join(pairs.label_dir, f) for f in os.listdir(pairs.label_dir))
    comps = sd15_components(seed, torch.bfloat16)
    build_root = os.path.join(work, "cli_build")
    with GnRouteWatch() as watch:
        reset_counters()  # the cli path's device part starts here
        t0 = time.perf_counter()
        _, built = build_transformed_dataset(
            imgs[:CLI_ROIS], labs[:CLI_ROIS], imgs[CLI_ROIS:], labs[CLI_ROIS:], 7, "tissue",
            DiffusionTransform(comps), build_root, image_size=1024)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches = read_counters()  # ... and ends here: the CLI runs no kernel
        routes = read_routes()
    del comps
    gc.collect()
    torch.cuda.empty_cache()
    check_bf16_routes("cli", routes)
    watch.check("cli", routes)
    n = CLI_ROIS + CLI_TEST_ROIS
    want = {"flash_attention_fwd": 17 * n, "groupnorm_silu": 113 * n}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"cli: the dataset build launched {launches}, expected {want}")
    raw = os.path.join(work, "cli_raw")
    ignore = os.path.join(raw, "Dataset001_Ignore")
    shutil.copytree(built, ignore)
    shutil.copytree(built, os.path.join(raw, "Dataset002_Regions"))
    for split in ("labelsTr", "labelsTs"):
        for f in os.listdir(os.path.join(ignore, split)):
            path = os.path.join(ignore, split, f)
            with Image.open(path) as im:
                lab = np.asarray(im, np.uint8).copy()
            lab[:, 448:576] = CLI_IGNORE  # a band through every class
            Image.fromarray(lab).save(path)
    with open(os.path.join(built, "dataset.json")) as f:
        dj = json.load(f)
    with open(os.path.join(ignore, "dataset.json"), "w") as f:
        json.dump({**dj, "labels": {**dj["labels"], "ignore": CLI_IGNORE}}, f, indent=2)
    with open(os.path.join(raw, "Dataset002_Regions", "dataset.json"), "w") as f:
        json.dump({**dj, "labels": CLI_REGIONS, "regions_class_order": CLI_REGIONS_ORDER}, f,
                  indent=2)
    return raw, {"launches": launches, "launches_by_route": routes,
                 "launches_per_roi": {k: launches[k] / n for k in INFERENCE_KERNELS},
                 "groupnorm_shapes": dict(watch.shapes), "rois": n,
                 "dataset_build_s_per_roi": build_s / n}


def cli_timing(fold_dir):
    """The trainer's ``timing`` lines of ``training_log.txt``, by name."""
    out = {}
    with open(os.path.join(fold_dir, "training_log.txt")) as f:
        for line in f:
            if ": timing " in line:
                what, payload = line.split(": timing ", 1)[1].split(" ", 1)
                out[what] = json.loads(payload)
    return out


def cli_run_figures(fold_dir, commands):
    """s/iteration (median after the first), host ms a batch, validation
    s/case, peak memory and the native routes of one run, from its log."""
    import numpy as np

    timing = cli_timing(fold_dir)
    train = timing["training"]
    routes = train["native_routes"]
    check_native_routes(f"cli ({fold_dir})", routes, NATIVE_2D)
    return {"commands_s": commands,
            "s_per_iteration_median_after_first": float(np.median(train["iteration_s"][1:])),
            "s_per_iteration_median_replays": float(np.median(train["iteration_s"][2:])),
            "iteration_s": train["iteration_s"],
            "host_ms_per_batch_median_after_first": float(
                np.median(train["host_batch_s"][1:]) * 1e3),
            "validation_s_per_case": timing["validation"]["validation_case_s"],
            "checkpoint_s": train["checkpoint_s"],
            "max_memory_allocated": max((t["max_memory_allocated"] for t in timing.values()
                                         if t["max_memory_allocated"] is not None),
                                        default=None),
            "native_routes": routes}


def cli_check_npz(out_dir, regions: bool):
    import numpy as np

    n = 0
    for f in sorted(os.listdir(out_dir)):
        if not f.endswith(".npz"):
            continue
        with np.load(os.path.join(out_dir, f)) as z:
            p = z["probabilities"]
        if p.dtype != np.float16 or p.shape[:2] != (1024, 1024) or p.shape[2] not in (3, 7):
            raise AssertionError(f"cli: {f} holds {p.dtype} {p.shape}")
        p = p.astype(np.float32)
        if regions and not (p.min() >= 0 and p.max() <= 1):
            raise AssertionError(f"cli: {f} region probabilities outside [0, 1]")
        if not regions and np.abs(p.sum(-1) - 1).max() > NPZ_SUM_TOL:
            raise AssertionError(f"cli: {f} softmax rows do not sum to 1")
        n += 1
    if n != CLI_TEST_ROIS:
        raise AssertionError(f"cli: {n} npz files in {out_dir}")


def cli_profile_iteration(plan_path, variant_name, dataset_json, seed):
    """One profiled training iteration of a run's recipe, plan and label
    regime, on a synthetic batch: a replay of its program (after the eager
    iteration and the captured one)."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.segmentor.cli import _read_dataset_json
    from ldiffusion_tpu_torch.segmentor.label_manager import label_manager_from_dataset_json
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    plan = SegPlan.load(plan_path)
    variant = get_variant(variant_name)
    lm = label_manager_from_dataset_json(_read_dataset_json(dataset_json))
    with tempfile.TemporaryDirectory() as out:
        tr = SegmentorTrainer(plan, variant.config, output_dir=out, variant=variant,
                              label_manager=lm, device="cuda")
        rng = np.random.default_rng(seed)
        shape = (plan.batch_size, *plan.patch_size)
        batch = (rng.normal(size=(*shape, 3)).astype(np.float32),
                 np.stack([train_labels(rng, plan.patch_size[0]) for _ in range(shape[0])]))
        for _ in range(2):
            tr.train_step(*batch, lr=1e-3)
        (program,) = tr.train_program.programs.values()
        prof = device_profile(lambda: tr.train_step(*batch, lr=1e-3))
        prof.update(replays=program.replays, capture_s=program.capture_s)
        if program.replays != 2:
            raise AssertionError(f"cli: the profiled iteration was not a replay: {prof}")
        del tr, program
    gc.collect()
    torch.cuda.empty_cache()
    return prof


def phase_cli(work, seed):
    """The 2D nnU-Net command line on the card at full width (module
    docstring, phase 8)."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch import native
    from ldiffusion_tpu_torch.core.checkpoint import load_pytree
    from ldiffusion_tpu_torch.data.augment import augment_batch
    from ldiffusion_tpu_torch.models.convert import flatten_tree
    from ldiffusion_tpu_torch.models.dynunet import DynUNet
    from ldiffusion_tpu_torch.segmentor import cli
    from ldiffusion_tpu_torch.segmentor.label_manager import label_manager_from_dataset_json
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    tiny = cli_tiny(seed)
    raw, build = cli_datasets(work, seed)
    pp, res = os.path.join(work, "cli_pp"), os.path.join(work, "cli_res")
    d1, d2 = os.path.join(raw, "Dataset001_Ignore"), os.path.join(raw, "Dataset002_Regions")
    env = {**os.environ, "LDIFFUSION_RAW": raw, "LDIFFUSION_PREPROCESSED": pp,
           "LDIFFUSION_RESULTS": res, "PYTHONPATH": HERE}

    def user(*argv):  # the command as users call it: a process of its own
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ldiffusion_tpu_torch.segmentor", *argv],
                              env=env, cwd=HERE, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"cli: {' '.join(argv)} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        return wall

    roots = {"plan_and_preprocess": ["--raw", raw, "--preprocessed", pp],
             "train": ["--raw", raw, "--preprocessed", pp, "--results", res],
             "predict": ["--raw", raw, "--results", res]}

    def inproc(*argv):  # cli.main(argv) in this process, on the card
        if argv[0] == "train":
            native.reset_routes()  # each run's own crop/resample calls
        t0 = time.perf_counter()
        out = cli.main(list(argv) + roots.get(argv[0], []), device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    # ---- run A: ignore label, the 1024²/7-class plan, DA5, as users run it
    a = {"plan_and_preprocess": user("plan_and_preprocess", "-d", "1",
                                     "--verify_dataset_integrity")}
    a["train"] = user("train", "-d", "1", "-c", "2d", "-f", "0", "-tr", "nnUNetTrainerDA5",
                      "--epochs", "2", "--iters", "4", "--npz")
    out_a = os.path.join(work, "cli_pred_a")
    a["predict"] = user("predict", "-i", os.path.join(d1, "imagesTs"), "-o", out_a, "-d", "1",
                        "-f", "0", "-tr", "nnUNetTrainerDA5", "--save_probabilities")
    a["evaluate_folder"] = user("evaluate_folder", os.path.join(d1, "labelsTs"), out_a,
                                "-djfile", os.path.join(d1, "dataset.json"))
    plan_a = SegPlan.load(os.path.join(pp, "Dataset001_Ignore", "plans.json"))
    if (tuple(plan_a.patch_size), tuple(plan_a.features_per_stage), plan_a.batch_size,
            plan_a.num_classes) != (FULL_PLAN[0], FULL_PLAN[1], 2, 7):
        raise AssertionError(f"cli: run A's plan is not the 1024²/7-class plan: {plan_a}")
    fold_a = os.path.join(res, "Dataset001_Ignore", "nnUNetTrainerDA5__ldPlans__2d", "fold_0")
    cli_check_npz(out_a, regions=False)
    cli_check_npz(os.path.join(fold_a, "validation"), regions=False)

    # ---- runs B and C in this process, cuDNN's TF32 as users have it
    torch.backends.cudnn.allow_tf32 = True
    try:
        b = {}
        b["plan_and_preprocess"], _ = inproc(
            "plan_and_preprocess", "-d", "2", "-pl", "nnUNetPlannerResEncM",
            "-overwrite_plans_name", "nnUNetResEncUNetMPlans")
        rb = ("-tr", "nnUNetTrainerAdanCosAnneal", "-p", "nnUNetResEncUNetMPlans")
        torch.cuda.reset_peak_memory_stats()
        b["train"], fold_b = inproc("train", "-d", "2", "-c", "2d", "-f", "0", *rb,
                                    "--epochs", "2", "--iters", "4")
        out_b = os.path.join(work, "cli_pred_b")
        b["predict"], _ = inproc("predict", "-i", os.path.join(d2, "imagesTs"), "-o", out_b,
                                 "-d", "2", "-f", "0", *rb, "--save_probabilities")
        b["evaluate_folder"], _ = inproc("evaluate_folder", os.path.join(d2, "labelsTs"), out_b,
                                         "-djfile", os.path.join(d2, "dataset.json"))
        c = {}
        torch.cuda.reset_peak_memory_stats()
        rc = ("-tr", "nnUNetTrainerBN")
        c["train"], fold_c = inproc("train", "-d", "1", "-c", "2d", "-f", "0", *rc,
                                    "--epochs", "2", "--iters", "4")
        c["train_val"], _ = inproc("train", "-d", "1", "-c", "2d", "-f", "0", *rc, "--val")
        out_c = os.path.join(work, "cli_pred_c")
        c["predict"], _ = inproc("predict", "-i", os.path.join(d1, "imagesTs"), "-o", out_c,
                                 "-d", "1", "-f", "0", *rc, "-chk", "checkpoint_final.pkl")
        c["determine_postprocessing"], _ = inproc(
            "determine_postprocessing", "-i", os.path.join(fold_c, "validation"),
            "-ref", os.path.join(fold_c, "validation_gt"),
            "-o", os.path.join(work, "cli_pp_c.json"))
        c["apply_postprocessing"], _ = inproc(
            "apply_postprocessing", "-i", out_c, "-o", os.path.join(work, "cli_pp_out_c"),
            "-pp_pkl_file", os.path.join(work, "cli_pp_c.json"))
    finally:
        torch.backends.cudnn.allow_tf32 = False

    # ---- gates
    plan_b = SegPlan.load(os.path.join(pp, "Dataset002_Regions", "nnUNetResEncUNetMPlans.json"))
    got = (tuple(plan_b.patch_size), plan_b.batch_size, tuple(plan_b.features_per_stage),
           tuple(plan_b.n_blocks_per_stage))
    if got != RESENC_M_PLAN or plan_b.block_type != "residual":
        raise AssertionError(f"cli: run B's plan is not ResEnc-M: {got}")
    ck_b = load_pytree(os.path.join(fold_b, "checkpoint_final.pkl"))
    with torch.device("meta"):
        meta_count = sum(p.numel() for p in DynUNet(plan_b.network_config()).parameters())
    flat = flatten_tree(ck_b["params"])
    resenc_count = sum(int(np.prod(v.shape)) for v in flat.values())
    if resenc_count != meta_count:
        raise AssertionError(f"cli: ResEnc-M holds {resenc_count} parameters, the plan "
                             f"{meta_count}")
    cli_check_npz(out_b, regions=True)
    ck_c = load_pytree(os.path.join(fold_c, "checkpoint_final.pkl"))
    stats = flatten_tree(ck_c["batch_stats"])
    if not stats or not all(np.isfinite(v).all() for v in stats.values()):
        raise AssertionError("cli: run C's checkpoint has no finite batch_stats")
    moved = max(float(np.abs(v - (1.0 if k.endswith("var") else 0.0)).max())
                for k, v in stats.items())
    if not moved > 0:
        raise AssertionError("cli: run C's running statistics never moved")
    dj1 = os.path.join(d1, "dataset.json")
    lm1 = label_manager_from_dataset_json(cli._read_dataset_json(dj1))
    plan_c = SegPlan.load(os.path.join(os.path.dirname(fold_c), "plans.json"))
    case = sorted(os.listdir(os.path.join(d1, "imagesTs")))[0]
    image = cli._load_png_channels([os.path.join(d1, "imagesTs", case)])
    masks = {}
    mirror = get_variant("nnUNetTrainerBN").mirror_tta
    for name in ("cuda", "cpu"):
        pred = SlidingWindowPredictor.from_checkpoints(
            plan_c, [os.path.join(fold_c, "checkpoint_final.pkl")], dtype=torch.float32,
            device=name, label_manager=lm1, use_mirroring=mirror)
        masks[name] = lm1.convert_logits_to_segmentation(pred.predict_logits(image))
        del pred
    agreement = float((masks["cuda"] == masks["cpu"]).mean())
    if agreement < CLI_MASK_AGREEMENT:
        raise AssertionError(f"cli: run C's f32 masks card vs CPU agree on {agreement:.4f}")

    # ---- figures
    da5 = dataclasses.replace(get_variant("nnUNetTrainerDA5").augment, p_rotation=0.0,
                              p_scaling=0.0)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2, 3, 1024, 1024, device="cuda")
    s = torch.zeros(2, 1024, 1024, dtype=torch.long, device="cuda")
    da5_ms = profiled_device_ms(lambda: augment_batch(x, s, da5, gen), 10)
    da5_every = dataclasses.replace(da5, p_median=1.0, p_rot90=1.0, p_blank_rect=1.0,
                                    p_brightness_gradient=1.0, p_local_gamma=1.0,
                                    p_sharpen=1.0)
    da5_every_ms = profiled_device_ms(lambda: augment_batch(x, s, da5_every, gen), 3)
    del x, s
    prof_a = cli_profile_iteration(os.path.join(pp, "Dataset001_Ignore", "plans.json"),
                                   "nnUNetTrainerDA5", dj1, seed)
    prof_b = cli_profile_iteration(
        os.path.join(pp, "Dataset002_Regions", "nnUNetResEncUNetMPlans.json"),
        "nnUNetTrainerAdanCosAnneal", os.path.join(d2, "dataset.json"), seed)
    runs = {"A": cli_run_figures(fold_a, a), "B": cli_run_figures(fold_b, b),
            "C": cli_run_figures(fold_c, c)}
    for name, run in runs.items():
        out = {"A": out_a, "B": out_b, "C": out_c}[name]
        run["predict_s_per_roi_command_wall"] = run["commands_s"]["predict"] / CLI_TEST_ROIS
        with open(os.path.join(out, "summary.json")) if name != "C" else \
                open(os.path.join(fold_c, "validation", "summary.json")) as f:
            run["foreground_dice"] = json.load(f)["foreground_mean"]["Dice"]
    runs["A"]["profiled_iteration"] = prof_a
    runs["B"]["profiled_iteration"] = prof_b
    row = {"gpu": gpu_line(), "runs": runs, "build": build, "tiny": tiny["errors"],
           "resenc_m_parameters": resenc_count, "bn_stats_moved_max": moved,
           "c_mask_agreement_card_vs_cpu": agreement,
           "da5_device_ms_per_batch": da5_ms, "da5_every_transform_device_ms": da5_every_ms,
           "plans": {"A": [list(plan_a.patch_size), plan_a.batch_size],
                     "B": [list(plan_b.patch_size), plan_b.batch_size,
                           list(plan_b.n_blocks_per_stage)]},
           "command_s_total": sum(sum(r["commands_s"].values()) for r in runs.values())}
    log("cli", json.dumps(row))
    return {"launches": build["launches"], "launches_by_route": build["launches_by_route"],
            "row": row}


# ---------------------------------------------------------------------------
# the segmentor workflow after training
# ---------------------------------------------------------------------------

WF_TRAINER = "nnUNetTrainerDA5"  # run A's recipe
# the spatial DA card vs CPU from the same draws: f32 on both sides, the data
# within the cuda-vs-CPU bound of the other pieces; a label moves only where
# a sample point sits within rounding of a half pixel
WF_SPATIAL_TOL = 1e-4
WF_LABEL_AGREEMENT = 0.995


def workflow_inputs(work, seed, user):
    """Run A's datasets, plans, fold 0 and fold 0's predictions of imagesTs
    with their probabilities: the cli phase's when it ran in this
    invocation, else made here the same way. Returns (raw, pp, res, fold 0's
    predictions, the dataset build's figures or None)."""
    raw, pp, res = (os.path.join(work, f"cli_{s}") for s in ("raw", "pp", "res"))
    out_a = os.path.join(work, "cli_pred_a")
    if os.path.isdir(out_a):
        return raw, pp, res, out_a, None
    _, build = cli_datasets(work, seed)
    user("plan_and_preprocess", "plan_and_preprocess", "-d", "1")
    user("train fold 0", "train", "-d", "1", "-c", "2d", "-f", "0", "-tr", WF_TRAINER,
         "--epochs", "2", "--iters", "4", "--npz")
    user("predict fold 0", "predict", "-i", os.path.join(raw, "Dataset001_Ignore", "imagesTs"),
         "-o", out_a, "-d", "1", "-f", "0", "-tr", WF_TRAINER, "--save_probabilities")
    return raw, pp, res, out_a, build


def read_pngs(folder):
    """{file: array} of a folder's PNGs."""
    import numpy as np
    from PIL import Image

    out = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".png"):
            with Image.open(os.path.join(folder, f)) as im:
                out[f] = np.asarray(im)
    return out


def read_npz(folder, name):
    import numpy as np

    with np.load(os.path.join(folder, name)) as z:
        return z["probabilities"]


def workflow_small_inputs(root, plans_json):
    """Small generated inputs of the host commands: two datasets and a
    plans.json (move_plans), an MSD task folder (convert_msd), an old-format
    dataset (convert_old_dataset)."""
    import shutil

    import numpy as np

    from ldiffusion_tpu_torch.data.converters import generate_integration_test_dataset

    for i in (5, 6):
        generate_integration_test_dataset(os.path.join(root, "raw", f"Dataset00{i}_Test"),
                                          n_cases=2, size=32, num_classes=3)
    os.makedirs(os.path.join(root, "pp", "Dataset005_Test"))
    shutil.copy(plans_json, os.path.join(root, "pp", "Dataset005_Test", "plans.json"))
    msd, old = os.path.join(root, "Task09_Spleen"), os.path.join(root, "Task02_Old")
    for folder, subs in ((msd, ("imagesTr", "labelsTr", "imagesTs")), (old, ("imagesTr",
                                                                              "labelsTr"))):
        for sub in subs:
            os.makedirs(os.path.join(folder, sub))
            for i in range(2):
                np.save(os.path.join(folder, sub, f"case{i}.npy"), np.full((4, 8, 8), i, np.int16))
    with open(os.path.join(msd, "dataset.json"), "w") as f:
        json.dump({"name": "Spleen", "modality": {"0": "CT"}, "numTraining": 2,
                   "labels": {"0": "background", "1": "spleen"}}, f)
    with open(os.path.join(old, "dataset.json"), "w") as f:
        json.dump({"name": "Old", "modality": {"0": "MR", "1": "T2"}, "tensorImageSize": "4D",
                   "labels": {"0": "background", "1": "tumor"}, "numTraining": 2,
                   "numTest": 0, "training": [], "test": []}, f)
    return msd, old


def phase_workflow(work, seed):
    """The nnU-Net workflow after training on the card (module docstring,
    phase 9)."""
    import shutil
    import zipfile

    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.checkpoint import load_pytree
    from ldiffusion_tpu_torch.data.augment import (
        AugmentConfig,
        apply_augment,
        augment_batch,
        draw_augment_params,
    )
    from ldiffusion_tpu_torch.models.convert import dynunet_from_flax, flatten_tree
    from ldiffusion_tpu_torch.segmentor import cli
    from ldiffusion_tpu_torch.segmentor.label_manager import label_manager_from_dataset_json
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    raw, pp, res = (os.path.join(work, f"cli_{s}") for s in ("raw", "pp", "res"))
    env = {**os.environ, "LDIFFUSION_RAW": raw, "LDIFFUSION_PREPROCESSED": pp,
           "LDIFFUSION_RESULTS": res, "PYTHONPATH": HERE}
    commands = {}

    def start(name, *argv):  # the command as users call it: a process of its own
        log_path = os.path.join(work, f"wf_{name.replace(' ', '_')}.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            proc = subprocess.Popen([sys.executable, "-m", "ldiffusion_tpu_torch.segmentor",
                                     *argv], env=env, cwd=HERE, stdout=log,
                                    stderr=subprocess.STDOUT, text=True)
        return name, argv, log_path, proc, t0

    def finish(started):
        name, argv, log_path, proc, t0 = started
        rc = proc.wait(timeout=600)
        commands[name] = time.perf_counter() - t0
        if rc:
            with open(log_path) as f:
                raise AssertionError(f"workflow: {' '.join(argv)} exited {rc}:\n"
                                     f"{f.read()[-6000:]}")

    def user(name, *argv):
        finish(start(name, *argv))

    def inproc(name, *argv):  # a host command through cli.main in this process
        t0 = time.perf_counter()
        out = cli.main(list(argv), device="cuda")
        commands[name] = time.perf_counter() - t0
        return out

    t_phase = time.perf_counter()
    reset_counters()  # the workflow's device part: the dataset build when it runs here
    raw, pp, res, out_a, build = workflow_inputs(work, seed, user)
    d1 = os.path.join(raw, "Dataset001_Ignore")
    ts = os.path.join(d1, "imagesTs")
    cfg_dir = os.path.join(res, "Dataset001_Ignore", f"{WF_TRAINER}__ldPlans__2d")
    final = ("-chk", "checkpoint_final.pkl")

    # ---- 2-4: the second fold, the cross-validation summary, the best configuration
    user("train fold 1", "train", "-d", "1", "-c", "2d", "-f", "1", "-tr", WF_TRAINER,
         "--epochs", "1", "--iters", "4", "--npz")
    cv = inproc("accumulate_crossval_results", "accumulate_crossval_results", "-m", cfg_dir)
    per_fold = []
    for f in (0, 1):
        with open(os.path.join(cfg_dir, f"fold_{f}", "validation", "summary.json")) as fh:
            per_fold.append(len(json.load(fh)["metric_per_case"]))
    if len(cv["metric_per_case"]) != sum(per_fold) or \
            not math.isfinite(cv["foreground_mean"]["Dice"]):
        raise AssertionError(f"workflow: the CV summary holds {len(cv['metric_per_case'])} "
                             f"cases (folds {per_fold}), Dice {cv['foreground_mean']['Dice']}")
    inproc("find_best_configuration", "find_best_configuration", "-d", "1", "-c", "2d",
           "-tr", WF_TRAINER, "--raw", raw, "--preprocessed", pp, "--results", res)
    with open(os.path.join(res, "Dataset001_Ignore", "inference_information.json")) as f:
        info = json.load(f)
    if info["best_configuration"] != "2d" or not math.isfinite(info["score"]) or \
            not isinstance(info["postprocessing"], list):
        raise AssertionError(f"workflow: inference_information.json {info}")

    # ---- 5: predict_from_modelfolder against predict, both folds, the final checkpoints,
    # side by side; meanwhile (step 7) the zip of those checkpoints is deflated on a host
    # core in a thread of this process (zlib lets go of the interpreter lock)
    share = os.path.join(work, "wf_share", os.path.basename(cfg_dir))
    for rel in ("plans.json", "dataset.json", "fold_0/checkpoint_final.pkl",
                "fold_1/checkpoint_final.pkl", "fold_0/postprocessing.json",
                "fold_1/postprocessing.json"):
        os.makedirs(os.path.dirname(os.path.join(share, rel)), exist_ok=True)
        shutil.copy(os.path.join(cfg_dir, rel), os.path.join(share, rel))
    zip_path = os.path.join(work, "wf_model.zip")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        export = pool.submit(inproc, "export_model", "export_model", share, "-o", zip_path)
        out_m, out_p = os.path.join(work, "wf_modelfolder"), os.path.join(work, "wf_predict")
        both = [start("predict_from_modelfolder", "predict_from_modelfolder", "-i", ts,
                      "-o", out_m, "-m", cfg_dir, "-f", "0", "1", *final,
                      "--save_probabilities"),
                start("predict", "predict", "-i", ts, "-o", out_p, "-d", "1", "-f", "0", "1",
                      "-tr", WF_TRAINER, *final)]
        for started in both:
            finish(started)
        export.result()
    masks = read_pngs(out_m)
    if len(masks) != CLI_TEST_ROIS or any(not np.array_equal(m, read_pngs(out_p)[f])
                                          for f, m in masks.items()):
        raise AssertionError("workflow: predict_from_modelfolder and predict masks differ")
    cli_check_npz(out_m, regions=False)

    # ---- 6: ensembles: both folds with fold 0 alone; run B's regions with themselves
    out_e = os.path.join(work, "wf_ensemble")
    inproc("ensemble", "ensemble", "-i", out_m, out_a, "-o", out_e, "--save_npz")
    for f in masks:
        npz = f[:-4] + ".npz"
        mean = np.mean(np.stack([read_npz(out_m, npz).astype(np.float32),
                                 read_npz(out_a, npz).astype(np.float32)]), axis=0)
        if not (np.array_equal(read_pngs(out_e)[f], np.argmax(mean, axis=-1).astype(np.uint8))
                and np.array_equal(read_npz(out_e, npz), mean.astype(np.float16))):
            raise AssertionError(f"workflow: the ensemble of {f} is not the mean's argmax")
    out_b = os.path.join(work, "cli_pred_b")
    regions_checked = os.path.isdir(out_b)
    if regions_checked:
        out_e2 = os.path.join(work, "wf_ensemble_regions")
        d2 = os.path.join(raw, "Dataset002_Regions")
        inproc("ensemble -d 2", "ensemble", "-i", out_b, out_b, "-o", out_e2, "-d", "2",
               "--raw", raw)
        lm2 = label_manager_from_dataset_json(cli._read_dataset_json(
            os.path.join(d2, "dataset.json")))
        for f, m in read_pngs(out_e2).items():
            p = read_npz(out_b, f[:-4] + ".npz").astype(np.float32)
            if not np.array_equal(m, lm2.convert_probabilities_to_segmentation(p)
                                  .astype(np.uint8)):
                raise AssertionError(f"workflow: the regions ensemble of {f} is not painted")

    # ---- 7: the model as a zip (exported beside step 5): install, download (file://),
    # predict again
    inst = os.path.join(work, "wf_installed", os.path.basename(cfg_dir))
    inproc("install_model", "install_model", zip_path, "-o", inst)
    down = os.path.join(work, "wf_downloaded", os.path.basename(cfg_dir))
    inproc("download_model", "download_model", "file://" + zip_path, "-o", down)
    with zipfile.ZipFile(zip_path) as z:
        names = sorted(z.namelist())
    for folder in (inst, down):
        got = sorted(os.path.relpath(os.path.join(r, f), folder)
                     for r, _, fs in os.walk(folder) for f in fs)
        if got != names:
            raise AssertionError(f"workflow: {folder} holds {got}, the zip {names}")
    # the installed model predicts in this process, profiled, cuDNN's TF32 as users have it
    out_i = os.path.join(work, "wf_installed_pred")
    torch.backends.cudnn.allow_tf32 = True
    try:
        t0 = time.perf_counter()
        prof = device_profile(lambda: cli.main(
            ["predict_from_modelfolder", "-i", ts, "-o", out_i, "-m", inst, "-f", "0", "1",
             *final], device="cuda"))
        commands["predict_from_modelfolder (installed, profiled)"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = False
    if any(not np.array_equal(m, masks[f]) for f, m in read_pngs(out_i).items()) or \
            len(read_pngs(out_i)) != len(masks):
        raise AssertionError("workflow: the installed model's masks differ")

    # ---- 8: overlays, plans moved, datasets converted, on small generated inputs
    small = os.path.join(work, "wf_small")
    msd, old = workflow_small_inputs(small, os.path.join(cfg_dir, "plans.json"))
    inproc("plot_overlays", "plot_overlays", ts, out_m, "-o", os.path.join(small, "overlays"))
    overlays = read_pngs(os.path.join(small, "overlays"))
    if sorted(overlays) != sorted(masks) or \
            any(o.shape != masks[k].shape + (3,) for k, o in overlays.items()):
        raise AssertionError("workflow: plot_overlays wrote "
                             f"{ {k: v.shape for k, v in overlays.items()} }")
    inproc("move_plans", "move_plans", "-s", "5", "-t", "6", "--raw",
           os.path.join(small, "raw"), "--preprocessed", os.path.join(small, "pp"))
    with open(os.path.join(small, "pp", "Dataset006_Test", "plans.json")) as f, \
            open(os.path.join(cfg_dir, "plans.json")) as g:
        if f.read() != g.read():
            raise AssertionError("workflow: move_plans did not copy the plans")
    msd_out, old_out = os.path.join(small, "Dataset009_Spleen"), os.path.join(small,
                                                                            "Dataset002_Old")
    inproc("convert_msd", "convert_msd", "-i", msd, "-o", msd_out)
    inproc("convert_old_dataset", "convert_old_dataset", "-i", old, "-o", old_out,
           "--file_ending", ".npy")
    with open(os.path.join(msd_out, "dataset.json")) as f:
        dj_msd = json.load(f)
    with open(os.path.join(old_out, "dataset.json")) as f:
        dj_old = json.load(f)
    if dj_msd["labels"] != {"background": 0, "spleen": 1} or \
            dj_old["labels"] != {"background": 0, "tumor": 1} or \
            dj_old["channel_names"] != {"0": "MR", "1": "T2"} or "training" in dj_old or \
            np.load(os.path.join(msd_out, "labelsTr", "case1.npy")).shape != (4, 8, 8):
        raise AssertionError(f"workflow: converted dataset.json {dj_msd} {dj_old}")

    # ---- 9: resume fold 1 with --c; the spatial DA on the card against the CPU
    latest = os.path.join(cfg_dir, "fold_1", "checkpoint_latest.pkl")
    ck = load_pytree(latest)
    plan = SegPlan.load(os.path.join(cfg_dir, "plans.json"))
    variant = get_variant(WF_TRAINER)
    lm1 = label_manager_from_dataset_json(cli._read_dataset_json(os.path.join(cfg_dir,
                                                                              "dataset.json")))
    with tempfile.TemporaryDirectory() as out:
        tr = SegmentorTrainer(plan, variant.config, output_dir=out, variant=variant,
                              label_manager=lm1, device="cuda")
        tr.load_checkpoint(latest)
        want = dynunet_from_flax(ck["opt_state"]["momentum"], tr.net_config)
        got = tr._opt_buffers("momentum_buffer")
        loaded_equal = all(torch.equal(got[k].cpu(), want[k]) for k in want)
        momentum_max = max(float(v.abs().max()) for v in want.values())
        del tr, got
    if not loaded_equal or not momentum_max > 0:
        raise AssertionError("workflow: the loaded momentum is not the checkpoint's "
                             f"(max |m| {momentum_max})")
    inproc("train --c", "train", "-d", "1", "-c", "2d", "-f", "1", "-tr", WF_TRAINER,
           "--epochs", "2", "--iters", "4", "--c", "--raw", raw, "--preprocessed", pp,
           "--results", res)
    with open(os.path.join(cfg_dir, "fold_1", "training_log.txt")) as f:
        resumed = "resumed from checkpoint_latest.pkl at epoch 1" in f.read()
    ck3 = load_pytree(os.path.join(cfg_dir, "fold_1", "checkpoint_final.pkl"))
    losses = ck3["logger"]["data"]["train_loss"]
    m3, m2 = (flatten_tree(c["opt_state"]["momentum"]) for c in (ck3, ck))
    moved = max(float(np.abs(m3[k] - m2[k]).max()) for k in m2)
    if not resumed or ck3["epoch"] != 2 or len(losses) != 2 or \
            not all(math.isfinite(v) for v in losses) or not moved > 0:
        raise AssertionError(f"workflow: --c resumed {resumed}, epoch {ck3['epoch']}, losses "
                             f"{losses}, momentum moved {moved}")

    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 10)
    cfg = AugmentConfig(p_rotation=1.0, p_scaling=1.0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 1024, 1024)).astype(np.float32))
    s = torch.from_numpy(np.stack([np.kron(rng.integers(0, 7, (16, 16)),
                                           np.ones((64, 64), np.int64)) for _ in range(2)]))
    drawn = draw_augment_params(x.shape, cfg, torch.Generator().manual_seed(seed))
    d_cpu, s_cpu = apply_augment(x, s, drawn, cfg)
    d_gpu, s_gpu = apply_augment(x.cuda(), s.cuda(), {k: v.cuda() for k, v in drawn.items()},
                                 cfg)
    spatial_err = per_tensor_err([d_gpu], [d_cpu])
    label_agreement = float((s_gpu.cpu() == s_cpu).float().mean())
    if not spatial_err <= WF_SPATIAL_TOL or label_agreement < WF_LABEL_AGREEMENT:
        raise AssertionError(f"workflow: spatial DA card vs CPU: data {spatial_err}, labels "
                             f"{label_agreement}")
    xg, sg = x.cuda(), s.cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    spatial_only = dataclasses.replace(cfg, **{k: 0.0 for k in (
        "p_noise", "p_blur", "p_brightness", "p_contrast", "p_lowres", "p_gamma_invert",
        "p_gamma", "p_mirror")})
    spatial_ms = profiled_device_ms(lambda: augment_batch(xg, sg, spatial_only, gen), 5)
    del x, s, xg, sg, d_gpu, s_gpu

    launches, routes = read_counters(), read_routes()
    cv_cases = len(cv["metric_per_case"])
    row = {"gpu": gpu_line(), "commands_s": commands,
           "command_s_total": sum(commands.values()),
           "side_by_side": ["export_model", "predict_from_modelfolder", "predict"],
           "phase_s": time.perf_counter() - t_phase,
           "built_datasets_here": build is not None, "build": build,
           "cv_cases": cv_cases, "cv_foreground_dice": cv["foreground_mean"]["Dice"],
           "find_best_s": commands["find_best_configuration"],
           "cv_prediction_s_per_case_command_wall": commands["find_best_configuration"]
           / cv_cases,
           "inference_information": info,
           "predict_from_modelfolder_s_per_roi_command_wall":
               commands["predict_from_modelfolder"] / CLI_TEST_ROIS,
           "ensemble_s_per_case": commands["ensemble"] / CLI_TEST_ROIS,
           "regions_ensemble_checked": regions_checked,
           "export_s": commands["export_model"], "install_s": commands["install_model"],
           "download_s": commands["download_model"], "zip_bytes": os.path.getsize(zip_path),
           "zip_names": names,
           "resume": {"momentum_loaded_bit_equal": loaded_equal, "epochs": ck3["epoch"],
                      "train_loss": losses, "momentum_moved_max": moved},
           "spatial_da": {"data_rel_err_card_vs_cpu": spatial_err, "tol": WF_SPATIAL_TOL,
                          "label_agreement": label_agreement,
                          "device_ms_per_batch_2x3x1024x1024": spatial_ms},
           "profiled_predict_from_modelfolder": prof,
           "launches": launches}
    log(json.dumps({"workflow": row}))
    return {"launches": launches, "launches_by_route": routes, "built": build is not None,
            "row": row}


# ---------------------------------------------------------------------------
# the volumetric (3D) segmentor pathway
# ---------------------------------------------------------------------------

VOL_TRAIN = 4                      # training volumes (fold 0: 3 train, 1 validation)
VOL_SHAPE = (160, 256, 256)        # float32, 42 MB a volume
VOL_SPACING = (2.5, 0.8, 0.8)      # anisotropic: 3.125 > ANISO_THRESHOLD, separate-z
VOL_ITERS = 12                     # iterations of the one epoch of each configuration
VOL_TRAINED = ("3d_lowres", "3d_cascade_fullres")  # trained by `train` processes
VOL_FULLRES = ((80, 128, 128), 2, (32, 64, 128, 256, 320, 320))
VOL_LOWRES_PATCH = (112, 96, 96)
VOL_MAX_FEATURES = 320             # the planner's 3D width (MAX_FEATURES_3D)


def vol_tiny(work, seed):
    """The 3D pieces, tiny and f32 on cuda against the CPU from the same
    values: one trainer step of a cascade-width (1 + 2 channels) 3D plan with
    batch Dice (DA off), the volumes' device DA with the same draws, and the
    3D sliding window's logits from the stepped net."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.data.augment import (
        AugmentConfig,
        apply_augment_3d,
        draw_augment_params_3d,
    )
    from ldiffusion_tpu_torch.segmentor.planner3d import SegPlan3D
    from ldiffusion_tpu_torch.segmentor.predictor import SlidingWindowPredictor
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer

    rng = np.random.default_rng(seed + 10)
    plan = SegPlan3D(patch_size=(16, 32, 32), batch_size=2, spacing=VOL_SPACING,
                     features_per_stage=(8, 16, 32), strides=((1, 1, 1), (1, 2, 2), (2, 2, 2)),
                     kernel_sizes=((1, 3, 3), (3, 3, 3), (3, 3, 3)), n_conv_per_stage=2,
                     num_classes=3, in_channels=1, normalization="zscore",
                     median_shape=(16, 32, 32), batch_dice=True, previous_stage="3d_lowres")
    cfg = SegmentorTrainConfig(compute_dtype="float32")
    data = rng.normal(size=(2, 16, 32, 32, 3)).astype(np.float32)
    seg = np.kron(rng.integers(-1, 3, (2, 4, 8, 8)), np.ones((1, 4, 4, 4), np.int64))
    trainers, losses = {}, {}
    for dev in ("cpu", "cuda"):  # the same seeded initialisation on both
        tr = SegmentorTrainer(plan, cfg, output_dir=os.path.join(work, f"vol_tiny_{dev}"),
                              augment=no_augment(), device=dev)
        losses[dev] = float(tr.loss_and_grads(*tr._to_device(data, seg)))
        tr.apply_update(lr=cfg.initial_lr)
        trainers[dev] = tr
    cpu, cuda = trainers["cpu"], trainers["cuda"]
    errs = {"loss": abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"]),
            "params": seg_tensor_err(cuda.net.state_dict(), cpu.net.state_dict()),
            "momentum": seg_tensor_err(cuda._momentum_state(), cpu._momentum_state())}
    every = AugmentConfig(p_noise=1.0, p_mirror=0.5)
    x = torch.from_numpy(data).movedim(-1, 1)
    drawn = draw_augment_params_3d(x.shape, every, torch.Generator().manual_seed(seed))
    out_cpu = apply_augment_3d(x, torch.from_numpy(seg), drawn)
    out_cuda = apply_augment_3d(x.cuda(), torch.from_numpy(seg).cuda(),
                                {k: v.cuda() for k, v in drawn.items()})
    errs["augment"] = float((out_cuda[0].cpu() - out_cpu[0]).abs().max())
    if not torch.equal(out_cuda[1].cpu(), out_cpu[1]):
        raise AssertionError("vol tiny: the 3D device DA moved the labels differently")
    volume = rng.normal(size=(20, 40, 44, 3)).astype(np.float32)
    logits = {dev: SlidingWindowPredictor(plan, [tr.net.state_dict()], dtype=torch.float32,
                                          device=dev).predict_logits(volume)
              for dev, tr in trainers.items()}
    logit_err = float(np.abs(logits["cuda"] - logits["cpu"]).max() / np.abs(logits["cpu"]).max())
    row = {"loss_cpu": losses["cpu"], "loss_cuda": losses["cuda"], "errors": errs,
           "tol": SEG_TINY_TOL, "predictor_logits_rel_err": logit_err,
           "predictor_tol": CLI_TINY_TOL}
    log("vol_tiny", json.dumps(row))
    bad = {k: v for k, v in errs.items() if not v <= SEG_TINY_TOL[k]}
    if bad or not logit_err <= CLI_TINY_TOL:
        raise AssertionError(f"vol tiny: cuda vs cpu outside the tolerance: {bad} "
                             f"(predictor {logit_err})")
    return row


def vol_dataset(raw, seed):
    """Four training volumes and one test volume of VOL_SHAPE float32 with
    the VOL_SPACING sidecar, drawn from the seed: a large ellipsoid (label 1)
    holding a small one (label 2) at a random place, each a step brighter
    than its surroundings, under Gaussian noise."""
    import numpy as np

    ds = os.path.join(raw, "Dataset300_Vol3D")
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        os.makedirs(os.path.join(ds, sub), exist_ok=True)
    rng = np.random.default_rng(seed + 11)
    zz, yy, xx = np.ogrid[:VOL_SHAPE[0], :VOL_SHAPE[1], :VOL_SHAPE[2]]
    for i in range(VOL_TRAIN + 1):
        c = rng.uniform((50, 90, 90), (110, 166, 166))
        r1, r2 = rng.uniform((28, 50, 50), (40, 75, 75)), rng.uniform((10, 18, 18), (16, 30, 30))
        c2 = c + rng.uniform(-0.4, 0.4, 3) * (r1 - r2)
        lab = np.zeros(VOL_SHAPE, np.uint8)
        lab[((zz - c[0]) / r1[0]) ** 2 + ((yy - c[1]) / r1[1]) ** 2
            + ((xx - c[2]) / r1[2]) ** 2 <= 1] = 1
        lab[((zz - c2[0]) / r2[0]) ** 2 + ((yy - c2[1]) / r2[1]) ** 2
            + ((xx - c2[2]) / r2[2]) ** 2 <= 1] = 2
        vol = rng.standard_normal(VOL_SHAPE, dtype=np.float32) * np.float32(0.5) + 2.0
        vol += lab.astype(np.float32)
        split, case = ("Ts", "test_0") if i == VOL_TRAIN else ("Tr", f"vol_{i}")
        np.save(os.path.join(ds, f"images{split}", f"{case}_0000.npy"), vol)
        np.save(os.path.join(ds, f"labels{split}", f"{case}.npy"), lab)
        with open(os.path.join(ds, f"images{split}", f"{case}_0000.json"), "w") as f:
            json.dump({"spacing": list(VOL_SPACING)}, f)
    with open(os.path.join(ds, "dataset.json"), "w") as f:
        json.dump({"channel_names": {"0": "MR"},
                   "labels": {"background": 0, "organ": 1, "lesion": 2},
                   "numTraining": VOL_TRAIN, "file_ending": ".npy"}, f, indent=2)
    return ds


def vol_profile_window(pp_dir, seed, n=3):
    """``n`` training iterations of the 3d_fullres plan as the CLI runs them
    (bf16, the trainer's own sampler, host 3D DA and prefetch thread over the
    preprocessed store) after two warm-up iterations, under the profiler; and
    which of the port's own kernels they launched (none: the 3D net holds no
    attention or GroupNorm)."""
    import torch

    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.segmentor.plans_file import PlansFile
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer

    plan = PlansFile(os.path.join(pp_dir, "plans_3d.json")).get_configuration("3d_fullres")
    ds = PreprocessedDataset.load(os.path.join(pp_dir, "ldPlans_3d_fullres"))
    with tempfile.TemporaryDirectory() as out:
        tr = SegmentorTrainer(plan, SegmentorTrainConfig(seed=seed), output_dir=out,
                              device="cuda")
        train_iter, val_iter = tr._iterators(ds, ds)
        try:
            for _ in range(2):
                tr.train_step(*next(train_iter), lr=1e-3)
            reset_counters()
            prof = device_profile(lambda: [float(tr.train_step(*next(train_iter), lr=1e-3))
                                           for _ in range(n)])
            prof["launches"] = read_counters()
        finally:
            train_iter.close()
            val_iter.close()
        del tr
    gc.collect()
    torch.cuda.empty_cache()
    prof["iterations"] = n
    return prof


def phase_vol(work, seed):
    """The volumetric nnU-Net command line on the card at the planner's full
    3D width (module docstring, phase 10)."""
    import numpy as np

    from ldiffusion_tpu_torch.core.checkpoint import load_pytree
    from ldiffusion_tpu_torch.segmentor import cli
    from ldiffusion_tpu_torch.segmentor.plans_file import PlansFile

    tiny = vol_tiny(work, seed)
    t0 = time.perf_counter()
    raw = os.path.join(work, "vol_raw")
    ds = vol_dataset(raw, seed)
    data_s = time.perf_counter() - t0
    pp, res = os.path.join(work, "vol_pp"), os.path.join(work, "vol_res")
    env = {**os.environ, "LDIFFUSION_RAW": raw, "LDIFFUSION_PREPROCESSED": pp,
           "LDIFFUSION_RESULTS": res, "PYTHONPATH": HERE}
    commands, outputs = {}, {}

    def user(name, *argv):  # the command as users call it: a process of its own
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ldiffusion_tpu_torch.segmentor", *argv],
                              env=env, cwd=HERE, capture_output=True, text=True, timeout=900)
        commands[name] = time.perf_counter() - t0
        if proc.returncode:
            raise AssertionError(f"vol: {' '.join(argv)} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        outputs[name] = proc.stdout
        return proc.stdout

    did = ("-d", "300")
    iters = ("--epochs", "1", "--iters", str(VOL_ITERS))
    t0 = time.perf_counter()  # a host command: in this process (the cli phase runs it as users do)
    cli.main(["plan_and_preprocess", *did, "--raw", raw, "--preprocessed", pp], device="cuda")
    commands["plan_and_preprocess (in process)"] = time.perf_counter() - t0
    # the 3d_fullres plan's net trains in the cascade's fullres stage (its
    # plan, 1 + 2 input channels) and steps in the profiled window below
    for cfg in VOL_TRAINED:
        user(f"train {cfg}", "train", *did, "-c", cfg, "-f", "0", *iters)
    preds = {}
    for cfg in ("3d_cascade_fullres",):  # the fullres net predicts in its own validation
        preds[cfg] = os.path.join(work, f"vol_pred_{cfg}")
        user(f"predict {cfg}", "predict", "-i", os.path.join(ds, "imagesTs"), "-o", preds[cfg],
             *did, "-c", cfg, "-f", "0")
    fold_full = os.path.join(res, "Dataset300_Vol3D",
                             "nnUNetTrainer__ldPlans__3d_cascade_fullres", "fold_0")
    t0 = time.perf_counter()  # a host command: in this process
    cli.main(["evaluate_folder", os.path.join(fold_full, "validation_gt"),
              os.path.join(fold_full, "validation"), "-djfile",
              os.path.join(ds, "dataset.json")], device="cuda")
    commands["evaluate_folder (in process)"] = time.perf_counter() - t0

    # ---- gates
    pp_dir = os.path.join(pp, "Dataset300_Vol3D")
    pf = PlansFile(os.path.join(pp_dir, "plans_3d.json"))
    plans = {name: pf.get_configuration(name) for name in pf.configuration_names()}
    if set(plans) != {"3d_fullres", "3d_lowres", "3d_cascade_fullres"}:
        raise AssertionError(f"vol: planned {sorted(plans)}")
    full = plans["3d_fullres"]
    if (tuple(full.patch_size), full.batch_size, tuple(full.features_per_stage)) != VOL_FULLRES:
        raise AssertionError(f"vol: the fullres plan is not the planner's default: {full}")
    if tuple(plans["3d_lowres"].patch_size) != VOL_LOWRES_PATCH or \
            any(p.features_per_stage[-1] != VOL_MAX_FEATURES for p in plans.values()):
        raise AssertionError(f"vol: the lowres plan: {plans['3d_lowres']}")
    runs = {}
    for cfg in VOL_TRAINED:
        fold = os.path.join(res, "Dataset300_Vol3D", f"nnUNetTrainer__ldPlans__{cfg}", "fold_0")
        timing = cli_timing(fold)
        train = timing["training"]
        check_native_routes(f"vol {cfg}", train["native_routes"], NATIVE_3D)
        ck = load_pytree(os.path.join(fold, "checkpoint_final.pkl"))
        losses = ck["logger"]["data"]["train_loss"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"vol: {cfg} trained to a non-finite loss {losses}")
        with open(os.path.join(fold, "validation", "summary.json")) as f:
            dice = json.load(f)["foreground_mean"]["Dice"]
        it = train["iteration_s"]
        runs[cfg] = {"s_per_iteration_median_last_half": float(np.median(it[len(it) // 2:])),
                     "iteration_s": it,
                     "host_ms_per_batch_median_after_first": float(
                         np.median(train["host_batch_s"][1:]) * 1e3),
                     "validation_s_per_case": timing["validation"]["validation_case_s"],
                     "checkpoint_s": train["checkpoint_s"],
                     "max_memory_allocated": max((t["max_memory_allocated"]
                                                  for t in timing.values()
                                                  if t["max_memory_allocated"] is not None),
                                                 default=None),
                     "train_loss": losses, "val_foreground_dice": dice,
                     "native_routes": train["native_routes"],
                     "in_channels": plans[cfg].network_config().in_channels,
                     "command_s": commands[f"train {cfg}"]}
    if runs["3d_cascade_fullres"]["in_channels"] != 1 + 2:
        raise AssertionError("vol: the cascade's input is not 1 + 2 channels")
    cached = os.path.join(pp_dir, "predicted_next_stage", "3d_cascade_fullres")
    if len([f for f in os.listdir(cached) if f.endswith(".npy")]) != VOL_TRAIN:
        raise AssertionError(f"vol: the lowres stage's cache holds {os.listdir(cached)}")
    if "lowres-stage prediction(s)" not in outputs["train 3d_cascade_fullres"] or \
            "consumed the lowres stage" not in outputs["predict 3d_cascade_fullres"]:
        raise AssertionError("vol: the cascade did not report consuming the lowres stage")
    predict = {}
    for cfg, out in preds.items():
        mask = np.load(os.path.join(out, "test_0.npy"))
        if mask.shape != VOL_SHAPE or not set(np.unique(mask).tolist()) <= {0, 1, 2}:
            raise AssertionError(f"vol: {cfg} mask {mask.shape} labels {np.unique(mask)}")
        line = [ln for ln in outputs[f"predict {cfg}"].splitlines()
                if ln.startswith("timing predict ")][-1]
        predict[cfg] = {**json.loads(line[len("timing predict "):])[0],
                        "command_s": commands[f"predict {cfg}"]}
    with open(os.path.join(fold_full, "validation", "summary.json")) as f:
        eval_dice = json.load(f)["foreground_mean"]["Dice"]

    # ---- figures: one profiled window of fullres iterations
    prof = vol_profile_window(pp_dir, seed)
    if any(prof["launches"].values()) or prof["ours_by_kernel_ms"]:
        raise AssertionError(f"vol: the 3D path launched the port's kernels: {prof['launches']}")
    row = {"gpu": gpu_line(), "tiny": tiny["errors"],
           "tiny_predictor_logits_rel_err": tiny["predictor_logits_rel_err"],
           "plans": {k: {"patch": list(p.patch_size), "batch": p.batch_size,
                         "spacing": list(p.spacing), "features": list(p.features_per_stage),
                         "batch_dice": p.batch_dice} for k, p in plans.items()},
           "dataset_write_s": data_s, "commands_s": commands,
           "command_s_total": sum(commands.values()), "runs": runs, "predict": predict,
           "cascade_validation_foreground_dice": eval_dice,
           "profiled_fullres_window": prof}
    log("vol", json.dumps(row))
    return {"launches": prof["launches"], "row": row}


# ---------------------------------------------------------------------------
# the generation tail
# ---------------------------------------------------------------------------

GEN_TINY_TOL = TINY_TRANSFORM_TOL  # f32 both sides, TF32 off: summation order only
GEN_TINY_EMBED = (8, 16)           # the tiny VAE halves the image: one stride-2 stage
GEN_EMBED = (16, 32, 96, 256)      # SD-v1.5 width: three stride-2 stages, 256² → 32²
GEN_SAMPLE_STEPS = 5               # tools.sample: PLMS 5 steps visit 6 timesteps, 6 PNGs
GEN_PLV_STEPS = 25                 # tools.pixel_latent_vector: 25 // 5 = 5 steps, 6 timesteps
GEN_PAIRS = 2                      # synthetic PUMA pairs for pixel_latent_vector
GEN_BATCH, GEN_SIZE = 4, 256       # the multimodal augment: four 256² RGB-D triplets
GEN_ROI, GEN_CLASSES = 1024, 7     # TissueSegNet on one 1024² ROI, 7 classes
GEN_MASK_IDS = (0, 60, 120, 180)   # the RGB-D masks' pixel ids (data/rgbd.py's map)

# A tool run as ``python -m`` runs it (``runpy.run_module``), in a process of
# its own, with the kernel wrappers' counts and the GroupNorm route watch of
# this script around it; the counts come back on the last line.
COUNTED_RUN = r"""
import json, runpy, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
module, sys.argv = sys.argv[2], [sys.argv[2]] + sys.argv[3:]
cs.reset_counters()
with cs.GnRouteWatch() as watch:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
print("LAUNCHES " + json.dumps({"launches": cs.read_counters(), "routes": cs.read_routes(),
                                "gn_expected": watch.expected, "gn_shapes": watch.shapes}))
"""


def gen_tiny(seed):
    """5-step DDIM and LMS loops over the tiny UNet, ``multimodal_augment``
    with a tiny ControlNet (every weight drawn, zero convolutions included),
    and both conductor nets in eval mode: f32 on cuda (TF32 off) against the
    CPU, the same weights and draws. Errors are max abs over max(1, max|cpu|)."""
    import torch

    from ldiffusion_tpu_torch.diffusion.multimodal import multimodal_augment
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents, trajectory_text_emb
    from ldiffusion_tpu_torch.diffusion.schedulers import laplace_noise, make_scheduler
    from ldiffusion_tpu_torch.models.conductor import (
        TissueSegNet,
        TissueSegNetConfig,
        TissueSegWithDepthHeatmap,
    )
    from ldiffusion_tpu_torch.models.controlnet import ControlNet
    from ldiffusion_tpu_torch.models.layers import init_random_

    gen = torch.Generator().manual_seed(seed)
    comps = SDComponents.random(seed=seed, device="cpu")
    tiny = TissueSegNetConfig.tiny(GEN_CLASSES)
    nets = {"controlnet": ControlNet(comps.unet_config, conditioning_embed_channels=GEN_TINY_EMBED),
            "seg": TissueSegNet(tiny),
            "depth": TissueSegWithDepthHeatmap(GEN_CLASSES, tiny.backbone_dims,
                                               tiny.backbone_depths)}
    for net in nets.values():
        init_random_(net, gen).eval()
    latents = torch.randn((1, 4, 32, 32), generator=gen)
    rgb, dtm = torch.rand((2, 64, 64, 3), generator=gen), torch.rand((2, 64, 64, 1), generator=gen)
    enc, lap = torch.randn((2, 32, 32, 4), generator=gen), laplace_noise((2, 32, 32, 4), gen)
    image, depth = torch.randn((2, 3, 64, 64), generator=gen), torch.rand((2, 1, 64, 64), generator=gen)
    outs = {}
    reset_counters()
    for dev in ("cuda", "cpu"):
        comps.to(device=dev)
        for net in nets.values():
            net.to(dev)
        o = {}
        with torch.inference_mode():
            emb = trajectory_text_emb(comps, 1)
            for name in ("ddim", "lms"):
                sch = make_scheduler(name)
                ts = sch.set_timesteps(5)
                state, z = sch.init_state(), latents.to(dev)
                for i, t in enumerate(ts.values):
                    idx = i if name == "lms" else t
                    eps = comps.unet(sch.scale_model_input(z, idx), t, emb)
                    z, state = sch.step(ts, state, eps, idx, z)
                o[f"{name}_5_steps"] = comps.vae.decode_latents(z)
            o["multimodal_augment"] = multimodal_augment(
                comps, nets["controlnet"], rgb.to(dev), dtm.to(dev), enc_noise=enc.to(dev),
                noise=lap.to(dev))
            o["tissue_seg_net"] = nets["seg"](image.to(dev))["out"]
            for k, v in nets["depth"](image.to(dev), depth.to(dev)).items():
                o[f"depth_heatmap_{k}"] = v
        outs[dev] = {k: v.float().cpu() for k, v in o.items()}
        if dev == "cuda":
            launched = read_counters()
    errors = {k: float((outs["cuda"][k] - ref).abs().max()) / max(1.0, float(ref.abs().max()))
              for k, ref in outs["cpu"].items()}
    row = {"errors": errors, "tol": GEN_TINY_TOL, "cuda_launches": launched}
    log("gen tiny", json.dumps(row))
    for k, err in errors.items():
        if not bool(torch.isfinite(outs["cuda"][k]).all()) or not err <= GEN_TINY_TOL:
            raise AssertionError(f"gen tiny: {k} cuda vs cpu differs by {err}")
    if min(launched[k] for k in INFERENCE_KERNELS) == 0:
        raise AssertionError(f"gen tiny: a kernel was not launched on cuda: {launched}")
    return row


def gen_rgbd(root, rng):
    """GEN_BATCH synthetic GEN_SIZE² RGB / DTM / mask TIF triplets under
    ``root/train/{rgb,dtm,masks}``, the RGB-D dataset's layout."""
    import numpy as np
    from PIL import Image

    dirs = {sub: os.path.join(root, "train", sub) for sub in ("rgb", "dtm", "masks")}
    for d in dirs.values():
        os.makedirs(d)
    for i in range(GEN_BATCH):
        tissue_like(rng, GEN_SIZE, GEN_SIZE).save(os.path.join(dirs["rgb"], f"tile_{i}.tif"))
        tissue_like(rng, GEN_SIZE, GEN_SIZE).convert("L").save(
            os.path.join(dirs["dtm"], f"tile_{i}.tif"))
        ids = np.asarray(GEN_MASK_IDS, np.uint8)[rng.integers(0, 4, (16, 16))]
        Image.fromarray(ids).resize((GEN_SIZE, GEN_SIZE), Image.NEAREST).save(
            os.path.join(dirs["masks"], f"tile_{i}.tif"))
    return root


def gen_augment(work, seed, rng):
    """``multimodal_augment`` of one batch of GEN_BATCH RGB-D triplets read
    by ``RgbDtmMaskDataset``, SD-v1.5-width bf16 components and ControlNet
    from seeded random weights: one call, three timed, one profiled."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.data.rgbd import RgbDtmMaskDataset
    from ldiffusion_tpu_torch.diffusion.multimodal import multimodal_augment
    from ldiffusion_tpu_torch.models.controlnet import ControlNet
    from ldiffusion_tpu_torch.models.layers import init_random_

    t0 = time.perf_counter()
    ds = RgbDtmMaskDataset(gen_rgbd(os.path.join(work, "gen_rgbd"), rng), "train",
                           mask_size=GEN_SIZE, image_size=GEN_SIZE)
    items = [ds[i] for i in range(len(ds))]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items])) for k in ("rgb", "dtm", "mask")}
    data_s = time.perf_counter() - t0
    rgb, dtm = batch["rgb"].cuda(), batch["dtm"].cuda()
    comps = sd15_components(seed, torch.bfloat16)
    with torch.device("meta"):
        cn = ControlNet(comps.unet_config, conditioning_embed_channels=GEN_EMBED)
    cn = init_random_(cn.to_empty(device="cuda"), torch.Generator(device="cuda").manual_seed(seed + 1))
    cn = cn.to(dtype=torch.bfloat16, memory_format=torch.channels_last).eval()
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def call():
        return multimodal_augment(comps, cn, rgb, dtm, generator=gen)

    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        prof = device_profile(call)
    if tuple(out.shape) != (GEN_BATCH, GEN_SIZE, GEN_SIZE, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"gen: the augment gave {tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    row = {"batch": GEN_BATCH, "size": GEN_SIZE, "dtype": "bfloat16",
           "controlnet_parameters": sum(p.numel() for p in cn.parameters()),
           "dataset_read_s": data_s, "first_call_s": first,
           "s_per_batch_median": float(np.median(times)), "s_per_batch_runs": times,
           "max_memory_allocated": peak, "profiled_call": prof}
    del comps, cn
    return out, batch, row


def gen_conductor(recon, batch, rng, seed):
    """TissueSegNet on one GEN_ROI² ROI, TissueSegWithDepthHeatmap on the
    augmented batch with its DTMs, CombinedLoss on the result; eval mode,
    ConvNeXt-Tiny 96-768, seeded random weights, cuDNN's TF32 as shipped."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD
    from ldiffusion_tpu_torch.losses.dice import CombinedLoss
    from ldiffusion_tpu_torch.models.conductor import (
        TissueSegNet,
        TissueSegNetConfig,
        TissueSegWithDepthHeatmap,
    )
    from ldiffusion_tpu_torch.models.layers import init_random_

    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    seg = init_random_(TissueSegNet(TissueSegNetConfig(GEN_CLASSES)).cuda(), g).eval()
    dep = init_random_(TissueSegWithDepthHeatmap(GEN_CLASSES).cuda(), g).eval()
    roi = np.asarray(tissue_like(rng, GEN_ROI, GEN_ROI), np.float32) / 255.0
    x = torch.from_numpy((roi - IMAGENET_MEAN) / IMAGENET_STD).permute(2, 0, 1)[None].cuda()
    rgb = recon.permute(0, 3, 1, 2).contiguous()
    depth = batch["dtm"].permute(0, 3, 1, 2).cuda()
    masks = batch["mask"].cuda()
    loss_fn = CombinedLoss(GEN_CLASSES)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for cuDNN: as shipped
    try:
        with torch.inference_mode():
            out = seg(x)["out"]
            heads = dep(rgb, depth)
            loss = loss_fn(heads["seg"], masks)
            row = {"tissue_seg_net_ms": cuda_ms(lambda: seg(x), 3),
                   "depth_heatmap_ms": cuda_ms(lambda: dep(rgb, depth), 3),
                   "combined_loss_ms": cuda_ms(lambda: loss_fn(heads["seg"], masks), 3)}
    finally:
        torch.backends.cudnn.allow_tf32 = False
    shapes = {"out": tuple(out.shape), **{k: tuple(v.shape) for k, v in heads.items()}}
    want = {"out": (1, GEN_CLASSES, GEN_ROI, GEN_ROI),
            "seg": (GEN_BATCH, GEN_CLASSES, GEN_SIZE, GEN_SIZE),
            "heatmap": (GEN_BATCH, GEN_CLASSES, GEN_SIZE, GEN_SIZE)}
    finite = all(bool(torch.isfinite(t).all()) for t in (out, *heads.values(), loss))
    if shapes != want or not finite:
        raise AssertionError(f"gen: conductor outputs {shapes}, finite {finite}")
    row.update({"combined_loss": float(loss),
                "tissue_seg_net_parameters": sum(p.numel() for p in seg.parameters()),
                "depth_heatmap_parameters": sum(p.numel() for p in dep.parameters())})
    return row


def phase_gen(work, seed):
    """The generation tail on the card (module docstring, phase 11)."""
    import csv

    import numpy as np
    import torch
    from PIL import Image

    t_phase = time.perf_counter()
    row = {"gpu": gpu_line(), "tiny": gen_tiny(seed)}
    sd_dir = os.path.join(work, "sd15_dir")  # the cell phase's, when it ran
    row["sd_dir_from_cell_phase"] = os.path.isdir(sd_dir)
    if not row["sd_dir_from_cell_phase"]:
        t0 = time.perf_counter()
        write_sd_dir(sd_dir, sd15_components(seed, torch.bfloat16))
        gc.collect()
        torch.cuda.empty_cache()
        row["sd_dir_write_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 11)
    roi = os.path.join(work, "gen_roi.png")
    tissue_like(rng, 512, 512).save(roi)
    pairs = seg_pairs(os.path.join(work, "gen_pairs"), GEN_PAIRS, rng)
    env = {**os.environ, "PYTHONPATH": HERE}
    commands, by_process = {}, {}

    def start(module, *argv):  # the tool as users call it, a process of its own, counted
        log_path = os.path.join(work, f"gen_{module.rsplit('.', 1)[-1]}.log")
        with open(log_path, "w") as out:
            proc = subprocess.Popen([sys.executable, "-c", COUNTED_RUN, HERE, module, *argv],
                                    env=env, cwd=work, stdout=out, stderr=subprocess.STDOUT,
                                    text=True)
        return proc, log_path, time.perf_counter()

    def finish(started):  # each process's own wall, taken when it exits
        deadline = time.perf_counter() + 600
        while any(name not in commands for name in started):
            for name, (proc, _, t0) in started.items():
                if name not in commands and proc.poll() is not None:
                    commands[name] = time.perf_counter() - t0
            if time.perf_counter() > deadline:
                for proc, _, _ in started.values():
                    proc.kill()
                raise AssertionError(f"gen: the tools ran past 600 s: {sorted(started)}")
            time.sleep(0.05)
        for name, (proc, log_path, _) in started.items():
            with open(log_path) as f:
                out = f.read()
            if proc.returncode:
                raise AssertionError(f"gen: {name} exited {proc.returncode}:\n{out[-6000:]}")
            counted = json.loads([ln for ln in out.splitlines()
                                  if ln.startswith("LAUNCHES ")][-1][len("LAUNCHES "):])
            check_bf16_routes(f"gen {name}", counted["routes"])
            if counted["routes"]["groupnorm_silu"] != counted["gn_expected"]:
                raise AssertionError(f"gen {name}: groupnorm_silu launched "
                                     f"{counted['routes']['groupnorm_silu']} by "
                                     f"route, gn_route names {counted['gn_expected']}")
            by_process[name] = counted

    reset_counters()  # the generation path starts here (and in each tool's process)
    # the two tools side by side, as a user's shell would run them
    out_dir = os.path.join(work, "gen_sample")
    csv_path = os.path.join(work, "gen_pixel_latent_vectors.csv")
    finish({"sample": start("ldiffusion_tpu_torch.tools.sample", "--diffusion-path", sd_dir,
                            "--image", roi, "--num-steps", str(GEN_SAMPLE_STEPS),
                            "--out-dir", out_dir),
            "pixel_latent_vector": start(
                "ldiffusion_tpu_torch.tools.pixel_latent_vector", "--diffusion-path", sd_dir,
                "--image-dir", pairs.image_dir, "--label-dir", pairs.label_dir,
                "--num-inference-steps", str(GEN_PLV_STEPS), "--out", csv_path)})
    pngs = sorted(os.path.join(out_dir, f) for f in os.listdir(out_dir))
    if len(pngs) != GEN_SAMPLE_STEPS + 1 or not all(p.endswith(".png") for p in pngs):
        raise AssertionError(f"gen: tools.sample wrote {pngs}")
    for p in pngs:
        with Image.open(p) as im:
            if im.size != (512, 512) or im.mode != "RGB":
                raise AssertionError(f"gen: {p} is {im.size} {im.mode}")
    written = [os.stat(p).st_mtime_ns / 1e9 for p in pngs]  # one PNG a visit, in order
    step_s = np.diff(written).tolist()
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    header = ["image", "y", "x", "label"] + [f"step_{t}" for t in range(GEN_PLV_STEPS // 5 + 1)]
    if rows[0] != header or len(rows) != 1 + GEN_PAIRS * 64 * 64 or \
            not np.isfinite(np.asarray([r[4:] for r in rows[1:]], np.float64)).all():
        raise AssertionError(f"gen: the CSV's header {rows[0]}, {len(rows)} lines")

    with GnRouteWatch() as watch:
        recon, batch, row["augment"] = gen_augment(work, seed, rng)
    launched, routes = read_counters(), read_routes()
    watch.check("gen augment", routes)
    check_bf16_routes("gen augment", routes)
    gc.collect()
    torch.cuda.empty_cache()
    row["conductor"] = gen_conductor(recon, batch, rng, seed)

    launches = {k: n + sum(p["launches"][k] for p in by_process.values())
                for k, n in launched.items()}
    by_route = {k: {r: n + sum(p["routes"][k][r] for p in by_process.values())
                    for r, n in rs.items()} for k, rs in routes.items()}
    if min(launches[k] for k in INFERENCE_KERNELS) == 0:
        raise AssertionError(f"gen: a kernel of the path was not launched: {launches}")
    row.update({"commands_s": commands, "sample_pngs": len(pngs),
                "sample_s_per_step_median": float(np.median(step_s)), "sample_step_s": step_s,
                "pixel_latent_vector_rows": len(rows) - 1,
                "launches_by_process": {**{k: p["launches"] for k, p in by_process.items()},
                                        "augment (this process)": launched},
                "gn_shapes_by_process": {**{k: p["gn_shapes"] for k, p in by_process.items()},
                                         "augment (this process)": watch.shapes},
                "launches": launches, "launches_by_route": by_route,
                "phase_wall_s": time.perf_counter() - t_phase})
    log(json.dumps({"gen": row}))
    return {"launches": launches, "launches_by_route": by_route, "row": row}


# ---------------------------------------------------------------------------
# the int8 W8A8 modes
# ---------------------------------------------------------------------------

# The VAE of tests/test_quant_task_ab.py: its 256-channel convs pass the gate.
QUANT_TINY_VAE = dict(block_out_channels=(64, 256), layers_per_block=1, norm_num_groups=32)
QUANT_TINY_MODES = ("none", "int8", "int8_all", "int8_static")
# Quantized transforms, cuda vs CPU: the f32 activations differ by ~1e-6, a
# code flips where one straddles a rounding edge and the flips cascade
# through later quantizers (tests/test_torch_port_quant_transform.py, whose
# bounds these are): max abs below QUANT_TRANSFORM_TOL, and the mode's change
# of the output (mode − none) correlated above QUANT_MIN_EFFECT_CORR.
QUANT_TRANSFORM_TOL = 0.1
QUANT_MIN_EFFECT_CORR = 0.5
# int8 inputs fed to both devices: their int32 accumulators must be equal.
# (name, x (B, Cin, H, W), Cout, k, stride, ((top, bottom), (left, right)))
QUANT_ACC_CONVS = [("3x3_pad1", (1, 256, 32, 32), 256, 3, 1, ((1, 1), (1, 1))),
                   ("1x1", (2, 512, 16, 16), 256, 1, 1, ((0, 0), (0, 0))),
                   ("3x3_stride2_pad01", (1, 256, 33, 31), 256, 3, 2, ((0, 1), (0, 1))),
                   ("k27_padded", (1, 3, 17, 19), 8, 3, 1, ((1, 1), (1, 1)))]
# (name, M, K, N): a cross-attention key projection of 5 tokens (M ≤ 16: the
# zero-padded product on the card) and a self-attention projection
QUANT_ACC_MATMULS = [("to_k_5_tokens", 5, 768, 320), ("to_q_4096_tokens", 4096, 320, 320)]
QUANT_SITES_SD15 = 114   # gated sites of the one-step transform at SD-v1.5 width
QUANT_ROI = 1024         # the tissue ROI's side
QUANT_BENCH_BATCH, QUANT_BENCH_SIZE, QUANT_BENCH_STEPS = 8, 512, 5  # bench.py's defaults
PEAK_INT8 = 1979e12      # H100 SXM dense int8 tensor-core ops/s


def quant_tiny(seed):
    """(a) The one-step transform at the tiny UNet with QUANT_TINY_VAE under
    each mode, f32 on cuda (TF32 off) against the CPU, the same weights and
    image, the static scales calibrated on the CPU; and int8_conv /
    int8_matmul on the same int8 codes on both devices (accumulators equal)."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.diffusion.pipeline import (
        SDComponents,
        one_step_transform,
        trajectory_text_emb,
    )
    from ldiffusion_tpu_torch.models.vae import VAEConfig
    from ldiffusion_tpu_torch.ops import quant

    comps = SDComponents.random(seed=seed, device="cpu", vae_config=VAEConfig(**QUANT_TINY_VAE))
    img = torch.from_numpy(np.random.default_rng(seed + 12).normal(
        size=(1, 64, 64, 3)).astype(np.float32))
    with torch.inference_mode():
        emb = trajectory_text_emb(comps, 1)
    scales = quant.calibrate_static_scales(lambda x: one_step_transform(comps, x, emb), img)
    outs, hits = {}, {}
    try:
        for dev in ("cpu", "cuda"):
            comps.to(device=dev)
            outs[dev] = {}
            with torch.inference_mode():
                emb = trajectory_text_emb(comps, 1)
                for mode in QUANT_TINY_MODES:
                    quant.set_quant_mode(mode)
                    quant.set_static_amax(scales)
                    before = quant.int8_conv.launches + quant.int8_matmul.launches
                    outs[dev][mode] = one_step_transform(comps, img.to(dev), emb).float().cpu()
                    hits[mode] = quant.int8_conv.launches + quant.int8_matmul.launches - before
    finally:
        quant.set_quant_mode("none")
        quant.set_static_amax(None)
    row = {"static_sites": len(scales), "quantized_calls": hits, "modes": {}}
    for mode in QUANT_TINY_MODES:
        got, ref = outs["cuda"][mode], outs["cpu"][mode]
        r = {"max_abs_diff": float((got - ref).abs().max()),
             "mean_abs_diff": float((got - ref).abs().mean())}
        if mode != "none":
            eff_gpu = (got - outs["cuda"]["none"]).flatten().double()
            eff_cpu = (ref - outs["cpu"]["none"]).flatten().double()
            r["effect_corr"] = float(torch.corrcoef(torch.stack([eff_gpu, eff_cpu]))[0, 1])
            r["effect_max_abs"] = float(eff_cpu.abs().max())
        row["modes"][mode] = r

    gen = torch.Generator().manual_seed(seed)
    acc = {}
    for name, (b, cin, h, w), cout, k, stride, pad in QUANT_ACC_CONVS:
        xq = torch.randint(-127, 128, (b, cin, h, w), dtype=torch.int8, generator=gen)
        wq = torch.randint(-127, 128, (cout, cin, k, k), dtype=torch.int8, generator=gen)
        ref = quant.int8_conv_acc(xq, wq, (stride, stride), pad)
        got = quant.int8_conv_acc(xq.cuda().contiguous(memory_format=torch.channels_last),
                                  wq.cuda(), (stride, stride), pad).cpu()
        x = torch.randn((b, cin, h, w), generator=gen)
        wf = torch.randn((cout, cin, k, k), generator=gen) / math.sqrt(cin * k * k)
        bias = torch.randn((cout,), generator=gen)
        yc = quant.int8_conv(x, wf, (stride, stride), pad, bias, out_dtype=torch.float32)
        yg = quant.int8_conv(x.cuda().contiguous(memory_format=torch.channels_last), wf.cuda(),
                             (stride, stride), pad, bias.cuda(), out_dtype=torch.float32).cpu()
        acc[name] = {"acc_equal": bool(torch.equal(got, ref)),
                     "codes_equal": bool(torch.equal(quant._act_quant(x)[0],
                                                     quant._act_quant(x.cuda())[0].cpu())),
                     "out_max_abs_diff": float((yg - yc).abs().max()),
                     "out_max_abs": float(yc.abs().max())}
    for name, m, kk, n in QUANT_ACC_MATMULS:
        a = torch.randint(-127, 128, (m, kk), dtype=torch.int8, generator=gen)
        bw = torch.randint(-127, 128, (n, kk), dtype=torch.int8, generator=gen)
        ref = quant.int_mm(a, bw.t())
        got = quant.int_mm(a.cuda(), bw.cuda().t()).cpu()
        x = torch.randn((1, m, kk), generator=gen)
        wf = torch.randn((n, kk), generator=gen) / math.sqrt(kk)
        yc = quant.int8_matmul(x, wf, None, out_dtype=torch.float32)
        yg = quant.int8_matmul(x.cuda(), wf.cuda(), None, out_dtype=torch.float32).cpu()
        acc[name] = {"acc_equal": bool(torch.equal(got, ref)),
                     "out_max_abs_diff": float((yg - yc).abs().max()),
                     "out_max_abs": float(yc.abs().max())}
    row["int8_products_cuda_vs_cpu"] = acc
    log("quant tiny", json.dumps(row))
    for mode, r in row["modes"].items():
        if not bool(torch.isfinite(outs["cuda"][mode]).all()):
            raise AssertionError(f"quant tiny: {mode}: non-finite output on cuda")
        if mode == "none":
            if r["max_abs_diff"] > TINY_TRANSFORM_TOL:
                raise AssertionError(f"quant tiny: none: cuda vs cpu {r}")
            continue
        if r["max_abs_diff"] > QUANT_TRANSFORM_TOL or r["effect_corr"] < QUANT_MIN_EFFECT_CORR \
                or r["effect_max_abs"] <= 10 * TINY_TRANSFORM_TOL or not hits[mode]:
            raise AssertionError(f"quant tiny: {mode}: cuda vs cpu {r}, calls {hits[mode]}")
    for name, r in acc.items():
        if not r["acc_equal"] or not r.get("codes_equal", True) or \
                r["out_max_abs_diff"] > 1e-6 * r["out_max_abs"]:
            raise AssertionError(f"quant tiny: {name}: int8 product cuda vs cpu {r}")
    return row


class QConvShapes:
    """Records, while open, every int8 convolution a ``QConv`` launches,
    from the arguments ``models/layers.py`` hands ``int8_conv`` (input
    shape, Cout, kernel, stride, padding), with a count."""

    def __enter__(self):
        from ldiffusion_tpu_torch.models import layers

        self.calls, self.layers, self.int8_conv = {}, layers, layers.int8_conv

        def recorded(x, weight, stride, padding, *args, **kwargs):
            key = (tuple(x.shape), weight.shape[0], weight.shape[2], stride[0], padding)
            self.calls[key] = self.calls.get(key, 0) + 1
            return self.int8_conv(x, weight, stride, padding, *args, **kwargs)

        layers.int8_conv = recorded
        return self

    def __exit__(self, *exc):
        self.layers.int8_conv = self.int8_conv


GRAPH_REPS, GRAPH_REPLAYS = 5, 2


def graph_ms(fn) -> float:
    """Device ms per call of ``fn``: GRAPH_REPS calls captured into one CUDA
    graph (after two warm-up calls on a side stream), replayed GRAPH_REPLAYS
    times between CUDA events. A replay launches the graph's kernels back to
    back, so no host time falls between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _events_ms(graph.replay, GRAPH_REPLAYS) / (GRAPH_REPS * GRAPH_REPLAYS)
    del graph
    return ms


def quant_shape_row(shape, cout, k, stride, pad, calls, path, gen):
    """(b) One gated conv shape: int8_conv's device ms split into its four
    stages, the whole call, the bf16 cuDNN conv on the same shape (each
    timed by ``graph_ms``), and the bounds."""
    import torch
    import torch.nn.functional as F

    from ldiffusion_tpu_torch.ops import quant

    b, cin, h, w = shape
    x = torch.randn(shape, device="cuda", dtype=torch.bfloat16, generator=gen) \
        .contiguous(memory_format=torch.channels_last)
    wt = (torch.randn((cout, cin, k, k), device="cuda", generator=gen)
          / math.sqrt(cin * k * k)).to(torch.bfloat16)
    bias = torch.zeros(cout, device="cuda", dtype=torch.bfloat16)
    xq, sx = quant._act_quant(x)
    wq, sw = quant._sym_quant(wt, dims=(1, 2, 3))
    cols, (_, ho, wo) = quant.im2col(xq, (k, k), (stride, stride), pad)
    wcols = quant.weight_cols(wq)
    acc = quant.int8_conv_acc(xq, wq, (stride, stride), pad)
    (pt, pb), (pl, pr) = pad
    if pt != pb or pl != pr or pt != pl:
        raise AssertionError(f"quant shape {shape}: QConv pads symmetrically, not {pad}")
    times = {  # QConv quantizes its weight once, from f32, before the cast down
        "quantize_ms": graph_ms(lambda: quant._act_quant(x)),
        "weight_quantize_ms": graph_ms(lambda: quant._sym_quant(wt, (1, 2, 3))),
        "im2col_ms": graph_ms(lambda: quant.im2col(xq, (k, k), (stride, stride), pad)),
        "int_mm_ms": graph_ms(lambda: quant.int_mm(cols, wcols)),
        "dequantize_ms": graph_ms(lambda: quant.dequantize(
            acc, sx, sw.reshape(1, -1, 1, 1), bias.reshape(1, -1, 1, 1), torch.bfloat16)),
        "int8_conv_ms": graph_ms(lambda: quant.int8_conv(x, wt, (stride, stride), pad, bias,
                                                          out_dtype=torch.bfloat16,
                                                          weight_q=(wq, sw))),
        "bf16_cudnn_ms": graph_ms(lambda: F.conv2d(x, wt, bias, stride, pt)),
    }
    m, kk, n = b * ho * wo, k * k * cin, cout
    ops = 2.0 * m * kk * n
    gemm_bytes = m * kk + kk * n + 4 * m * n           # int8 A, B; int32 C
    conv_bytes = 2 * (b * cin * h * w + n * kk + m * n)  # bf16 x, w, y: a fused kernel's traffic
    row = {"path": path, "x": list(shape), "cout": cout, "k": k, "stride": stride,
           "pad": [list(p) for p in pad], "calls": calls, "M": m, "K": kk, "N": n, **times,
           "int8_over_bf16": times["int8_conv_ms"] / times["bf16_cudnn_ms"],
           "int_mm_bound_ms": max(ops / PEAK_INT8, gemm_bytes / PEAK_BYTES) * 1e3,
           "fused_int8_bound_ms": max(ops / PEAK_INT8, conv_bytes / PEAK_BYTES) * 1e3,
           "bf16_bound_ms": max(ops / PEAK_BF16, conv_bytes / PEAK_BYTES) * 1e3}
    return row


def phase_quant(work, seed):
    """The int8 W8A8 modes on the card (module docstring, phase 12)."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.api import LDiffusionModel
    from ldiffusion_tpu_torch.data.dataset import load_image
    from ldiffusion_tpu_torch.diffusion.pipeline import (
        laplace_reverse_transform,
        one_step_transform,
        trajectory_text_emb,
    )
    from ldiffusion_tpu_torch.ops import quant

    t_phase = time.perf_counter()
    row = {"gpu": gpu_line(), "tiny": quant_tiny(seed)}
    rng = np.random.default_rng(seed + 12)
    roi = os.path.join(work, "quant_roi.png")
    tissue_like(rng, QUANT_ROI, QUANT_ROI).save(roi)
    seg = write_segmentor(os.path.join(work, "quant_seg"), seg_plan(*FULL_PLAN), seed)
    comps = sd15_components(seed, torch.bfloat16)
    model = LDiffusionModel("sd15-seeded-random", "tissue", components=comps)
    x = torch.from_numpy(load_image(roi, (QUANT_ROI, QUANT_ROI)))[None].cuda()
    with torch.inference_mode():
        emb = trajectory_text_emb(comps, 1)
    t0 = time.perf_counter()
    scales = quant.calibrate_static_scales(lambda im: one_step_transform(comps, im, emb), x)
    row["calibrate_s"] = time.perf_counter() - t0
    row["calibrated_sites"] = len(scales)
    if len(scales) != QUANT_SITES_SD15:
        raise AssertionError(f"quant: calibrated {len(scales)} sites, not {QUANT_SITES_SD15}")

    tissue, transforms, masks, shapes = {}, {}, {}, {}
    images = torch.from_numpy(rng.normal(size=(QUANT_BENCH_BATCH, QUANT_BENCH_SIZE,
                                               QUANT_BENCH_SIZE, 3)).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bench = {}
    try:
        with GnRouteWatch() as watch:
            reset_counters()  # the quantized paths start here
            # (c) tissue inference at 1024², one ROI, each mode
            for mode in ("none", "int8", "int8_static"):
                quant.set_quant_mode(mode)
                quant.set_static_amax(scales if mode == "int8_static" else None)
                with QConvShapes() as rec:
                    model.inference_tissue(roi, None, seg, 7)  # warm-up
                if mode == "int8":
                    shapes["tissue_1024"] = rec.calls
                torch.cuda.synchronize()
                before = quant.int8_conv.launches
                t0 = time.perf_counter()
                _, masks[mode] = model.inference_tissue(roi, None, seg, 7)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                sites = quant.int8_conv.launches - before
                with torch.inference_mode():
                    transforms[mode] = one_step_transform(comps, x, emb)[0].float()
                tissue[mode] = {"s_per_roi": s, "gated_sites_hit": sites}
            # (d) bench.py's program: 512², batch 8, 5 PNDM steps with Laplace noise
            for mode in ("none", "int8_static"):
                quant.set_quant_mode(mode)
                quant.set_static_amax(None)
                r = {}
                with torch.inference_mode():
                    if mode == "int8_static":
                        # bench.py:114-125's stand-in: amax 1.0 at every site the
                        # program hits (listed on a 64² batch of one)
                        bench_sites = quant.record_quant_sites(
                            lambda im: laplace_reverse_transform(
                                comps, im, QUANT_BENCH_STEPS, generator=gen), images[:1, :64, :64])
                        quant.set_static_amax({k: 1.0 for k in bench_sites})
                        r["static_sites"] = len(bench_sites)
                    with QConvShapes() as rec:  # warm-up
                        out = laplace_reverse_transform(comps, images, QUANT_BENCH_STEPS,
                                                        generator=gen)
                    if mode == "int8_static":
                        shapes["bench_512_b8"] = rec.calls
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    times = []
                    for _ in range(3):
                        t0 = time.perf_counter()
                        out = laplace_reverse_transform(comps, images, QUANT_BENCH_STEPS,
                                                        generator=gen)
                        torch.cuda.synchronize()
                        times.append(time.perf_counter() - t0)
                    peak = torch.cuda.max_memory_allocated()
                    prof = device_profile(lambda: laplace_reverse_transform(
                        comps, images, QUANT_BENCH_STEPS, generator=gen))
                if tuple(out.shape) != (QUANT_BENCH_BATCH, QUANT_BENCH_SIZE, QUANT_BENCH_SIZE, 3) \
                        or not bool(torch.isfinite(out).all()):
                    raise AssertionError(f"quant bench {mode}: output {tuple(out.shape)}")
                s = float(np.median(times))
                r.update({"s_per_batch": s, "s_runs": times,
                          "patches_per_s": QUANT_BENCH_BATCH / s, "max_memory_allocated": peak,
                          "profiled_wall_s": prof["wall_s"],
                          "device_busy_ms": prof["device_busy_ms"],
                          "device_idle_share": prof["device_idle_share"],
                          "by_family_ms": prof["by_family_ms"]})
                bench[mode] = r
            launches, routes = read_counters(), read_routes()  # the quantized paths end here
    finally:
        quant.set_quant_mode("none")
        quant.set_static_amax(None)
    check_bf16_routes("quant", routes)
    watch.check("quant", routes)
    if min(launches[k] for k in INFERENCE_KERNELS) == 0:
        raise AssertionError(f"quant: a kernel of the path was not launched: {launches}")

    for mode in ("int8", "int8_static"):
        diff = (transforms[mode] - transforms["none"]).abs()
        tissue[mode].update({"transform_max_abs_vs_none": float(diff.max()),
                             "transform_mean_abs_vs_none": float(diff.mean()),
                             "mask_agreement_vs_none": float(np.mean(masks[mode] ==
                                                                     masks["none"]))})
        if tissue[mode]["gated_sites_hit"] != QUANT_SITES_SD15 or not float(diff.max()) > 0:
            raise AssertionError(f"quant {mode}: {tissue[mode]}")
    for mode, t in transforms.items():
        if not bool(torch.isfinite(t).all()) or masks[mode].shape != (QUANT_ROI, QUANT_ROI):
            raise AssertionError(f"quant {mode}: transform or mask malformed")
    if tissue["none"]["gated_sites_hit"] != 0:
        raise AssertionError(f"quant none: {tissue['none']}")

    # (b) every distinct gated conv shape of both programs
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    table = []
    for path, calls in shapes.items():
        for (shape, cout, k, stride, pad), n in sorted(calls.items()):
            table.append(quant_shape_row(shape, cout, k, stride, pad, n, path, gen))
            log("quant shape", json.dumps(table[-1]))
    for path in shapes:
        rows = [r for r in table if r["path"] == path]
        row[f"convs_{path}"] = {
            "distinct_shapes": len(rows), "calls": sum(r["calls"] for r in rows),
            "int8_conv_ms": sum(r["int8_conv_ms"] * r["calls"] for r in rows),
            "bf16_cudnn_ms": sum(r["bf16_cudnn_ms"] * r["calls"] for r in rows),
            **{k: sum(r[k] * r["calls"] for r in rows)
               for k in ("quantize_ms", "im2col_ms", "int_mm_ms", "dequantize_ms",
                         "weight_quantize_ms")},
            "shapes_where_int8_wins": sum(r["int8_over_bf16"] < 1 for r in rows)}
    row.update({"tissue_1024": tissue, "bench_512_b8": bench,
                "bench_static_scales": "amax 1.0 at every site (bench.py:114-125)",
                "launches": launches, "launches_by_route": routes,
                "phase_wall_s": time.perf_counter() - t_phase})
    log(json.dumps({"quant": row}))
    return {"launches": launches, "launches_by_route": routes, "row": row}


# ---------------------------------------------------------------------------
# distribution: NCCL at world size 1, FSDP2 stage 1, DDP stage 2, torchrun
# ---------------------------------------------------------------------------

# The FSDP2 stage-1 step against the one-device step (bf16 compute over f32
# masters, the same weights and draws). FSDP2 hands the convolutions
# contiguous weights where the one-device UNet keeps channels_last ones, so
# cuDNN may add in another order and the bf16 results differ by rounding:
# the loss DIST_LOSS_RTOL and the gradient norm DIST_NORM_RTOL relative,
# each gradient tensor within DIST_GRAD_SHARE of its largest value. AdamW's
# first step is lr·g/(|g| + eps) = ±lr wherever |g| >> eps, so the updated
# parameters agree exactly (up to rounding of the f32 parameter, 2^-22·|p|)
# except where a gradient's sign flips under that rounding; those elements
# move 2·lr apart at most, and are at most DIST_FLIP_SHARE of all.
DIST_LOSS_RTOL = 2e-3
DIST_NORM_RTOL = 2e-2
DIST_GRAD_SHARE = 5e-2
DIST_FLIP_SHARE = 1e-2
# The DDP stage-2 step against the one-device step (bf16 compute, f32
# parameters, the same weights and draws): DDP at world size 1 averages
# over one rank. The loss 1e-3 relative; each momentum buffer (the step's
# clipped gradient plus the decay) within DIST_SEG_MOMENTUM of its largest
# value (cuDNN's backward may add in another order; a conv bias in front of
# a norm has a gradient of 0 in exact arithmetic, so its buffer is rounding
# noise, held absolutely); each parameter's update within that share of
# lr·(1 + μ)·max|momentum|; BatchNorm's running statistics (the group's sums, where
# one process takes var_mean) within 1e-3 of their largest value. The BN
# net's statistics differ in f32 rounding, which bf16 activations turn into
# gradient differences up to 0.7% of a tensor's largest value (a CPU
# rehearsal at the tiny plan); DIST_SEG_MOMENTUM leaves 4x. The group's
# arithmetic itself (two ranks, a factor of W) is held on the CPU by
# tests/test_torch_port_dist_seg.py.
DIST_SEG_LOSS_RTOL = 1e-3
DIST_SEG_MOMENTUM = 3e-2
DIST_LAUNCH_TIMEOUT_S = 600
# The steps over the mesh through their programs (eager first use, capture,
# replays) against the eager route from the same state: stage 1 at 512²
# (an eager step takes 2.5-6 s: three steps through the program, two eager,
# keep the phase short), the segmentor at the 1024² plan
DIST_ROUTE_STEPS = 3
DIST_SEG_ROUTE_STEPS = 4


def whole(t):
    """A copy on the card of ``t`` whole (a DTensor gathered)."""
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().clone()


def launches_since(before) -> dict:
    """The launches and the launches by route since ``before`` =
    (``read_counters()``, ``read_routes()``)."""
    counts, routes = before
    return {"launches": {k: n - counts[k] for k, n in read_counters().items()},
            "launches_by_route": {name: {r: n - routes[name].get(r, 0)
                                         for r, n in by_route.items()}
                                  for name, by_route in read_routes().items()}}


def held_to_eager(where: str, captured: dict, eager: dict, run_again) -> dict:
    """The captured route's tensors against the eager route's: bit-equal, or
    within twice the difference between two eager runs (``run_again()``,
    called only when they are not bit-equal; ``captured`` is emptied before
    it, to free its tensors). Raises otherwise; returns the figures."""
    diff = {k: max_abs_diff(captured[k], eager[k]) for k in eager}
    captured.clear()
    spread = None
    if any(diff.values()):
        again = run_again()
        spread = {k: max_abs_diff(again[k], eager[k]) for k in eager}
    bad = {k: (diff[k], spread[k]) for k in diff if diff[k] and not diff[k] <= 2 * spread[k]}
    if bad:
        raise AssertionError(f"{where}: the captured steps left the eager route: {bad}")
    return {"captured_vs_eager_max_abs": diff, "eager_vs_eager_max_abs": spread,
            "bit_equal": not any(diff.values()),
            "bound": "bit-equal, or at most twice the eager-vs-eager difference"}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dist_stage1(work, seed, mesh):
    """One stage-1 step at SD-v1.5 width on a 512² image, through the
    one-device trainer and through ``DiffusionWarmupTrainer(mesh=...)``
    under FSDP2, from the same seeded weights and draws; then the FSDP2
    trainer's state through ``save_state`` / ``load_state``."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    rng = np.random.default_rng(seed + 13)
    images, labels = tr_batch(rng, 512)
    x = torch.as_tensor(images, device="cuda")
    y = torch.as_tensor(labels, device="cuda").long()
    cfg = DiffusionTrainConfig(num_inference_steps=25, num_classes=7)
    runs, draws, ref, sections = {}, None, {}, {}
    t_mark = [time.perf_counter()]

    def mark(key):  # the wall of each part, to trace the phase's time
        torch.cuda.synchronize()
        now = time.perf_counter()
        sections[key] = sections.get(key, 0.0) + now - t_mark[0]
        t_mark[0] = now

    base = sd15_components(seed + 1, torch.float32)  # built once: ~7 s at this width
    for name in ("one_device", "fsdp2"):
        comps = copy.deepcopy(base) if name == "one_device" else base
        mark("components")
        tr = DiffusionWarmupTrainer(comps, cfg, work_dir=os.path.join(work, f"dist_{name}"),
                                    mesh=mesh if name == "fsdp2" else None)
        mark("trainer")
        if draws is None:
            draws = tr.draw(x, y)
            mark("draws")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # the compared step, between CUDA events (a profiled 512² step takes
        # ~15 s to parse; the device's busy ms are the train phase's)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with GnRouteWatch() as watch:
            reset_counters()  # the step's launches, counted from 0
            t0 = time.perf_counter()
            start.record()
            loss, _ = tr.loss_and_grads(x, y, *draws)
            grads = [whole(m.grad) for m in tr.master]  # before the clip scales them
            norm = tr.apply_update()
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, routes = read_counters(), read_routes()
        mark("step")
        check_bf16_routes(f"dist {name}", routes)
        watch.check(f"dist {name}", routes)
        params = [whole(m) for m in tr.master]
        run = {"loss": float(loss), "grad_norm": float(norm), "step_wall_s": wall,
               "device_span_ms": start.elapsed_time(end),
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "peak_reserved_bytes": torch.cuda.max_memory_reserved(), "launches": launches,
               "launches_by_route": routes}
        if name == "one_device":
            ref["params"], ref["grads"] = params, grads
        else:
            run["sharded_params"] = sum(hasattr(m, "to_local") for m in tr.master)
            # the gradients and the parameters after the step, against the one-device step's
            lr, grad_share, flips, moved, n = cfg.learning_rate, 0.0, 0, 0.0, 0
            for g0, g1, a, b in zip(ref["grads"], grads, ref["params"], params):
                grad_share = max(grad_share, float((g1 - g0).abs().max()
                                                   / g0.abs().max().clamp_min(1e-30)))
                d = ((a - b).abs() - 2.0 ** -22 * a.abs()).clamp_min(0.0)
                flips += int((d > 0.1 * lr).sum())
                moved = max(moved, float(d.max()) / lr)
                n += d.numel()
            run["vs_one_device"] = {"grad_share": grad_share, "flipped_share": flips / n,
                                    "largest_param_diff_over_lr": moved, "elements": n}
            ref.clear()  # the device memory the programs' check needs
            grads = params = None
        mark("gather_and_compare")
        if name == "fsdp2":
            run["programs"] = dist_stage1_programs(tr, x, y)
            mark("programs")
        runs[name] = run
        log(f"dist stage1 {name}", json.dumps(run))
        del tr, comps, params
        if name == "fsdp2":
            del base
        gc.collect()
        torch.cuda.empty_cache()
        mark("free")
    one, sharded = runs["one_device"], runs["fsdp2"]
    out = {"images": [512, 512], "labels": [64, 64], "dtype": "bfloat16 compute, f32 masters",
           "one_device": one, "fsdp2": sharded, "sections_s": sections,
           "loss_rel_diff": abs(sharded["loss"] - one["loss"]) / abs(one["loss"]),
           "grad_norm_rel_diff": abs(sharded["grad_norm"] - one["grad_norm"]) / one["grad_norm"]}
    if out["loss_rel_diff"] > DIST_LOSS_RTOL or out["grad_norm_rel_diff"] > DIST_NORM_RTOL:
        raise AssertionError(f"dist stage1: FSDP2 step off the one-device step: {out}")
    diff = sharded["vs_one_device"]
    if diff["grad_share"] > DIST_GRAD_SHARE or diff["flipped_share"] > DIST_FLIP_SHARE or \
            diff["largest_param_diff_over_lr"] > 2.0 + 1e-3:
        raise AssertionError(f"dist stage1: gradients or updated parameters apart: {diff}")
    if one["launches"] != sharded["launches"] or \
            one["launches_by_route"] != sharded["launches_by_route"]:
        raise AssertionError(f"dist stage1: the kernels' launches differ under FSDP2: "
                             f"{one['launches_by_route']} vs {sharded['launches_by_route']}")
    if sharded["launches"]["groupnorm_silu_backward"] != GN_BWD_PER_STEP_512:
        raise AssertionError(f"dist stage1: groupnorm_silu_backward launched "
                             f"{sharded['launches_by_route']['groupnorm_silu_backward']}, "
                             f"expected {GN_BWD_PER_STEP_512} in all")
    if min(sharded["launches"].values()) == 0 or not sharded["sharded_params"]:
        raise AssertionError(f"dist stage1: {sharded['launches']}, "
                             f"{sharded['sharded_params']} DTensor parameters")
    per_step = sharded["programs"]["launches_each_step"]
    if any(step["launches_by_route"] != sharded["launches_by_route"] or
           step["launches"] != sharded["launches"] for step in per_step):
        raise AssertionError(f"dist stage1: the program's steps launched {per_step}, the "
                             f"eager FSDP2 step {sharded['launches_by_route']}")
    return out


def dist_stage1_programs(tr, x, y):
    """The FSDP2 trainer after its compared step: DIST_ROUTE_STEPS steps
    through ``train_step``, its batch shape's program (the eager first use,
    then state S; the capture, FSDP2's all-gathers and reduce-scatters, the
    losses' all-reduce and the clip's norm inside the graph; replays), then
    one replay profiled (device activity only); the steps after the first
    use against as many ``step_fn`` calls from S (the eager route; the first
    use is that route by construction): losses, gradient norms, gathered
    masters and AdamW moments held by ``held_to_eager``. Each step's
    launches by route, s/step by route, the capture's s, the allocated and
    reserved peaks of the programs' steps."""
    import numpy as np
    import torch

    st = tr.opt.state
    n0, values, per_step = len(tr.history), [], []
    eager_s = []

    def step():
        before = read_counters(), read_routes()
        m = tr.train_step(x, y)
        values.append([m[k] for k in TRAIN_ROUTE_KEYS])
        per_step.append(launches_since(before))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()  # the eager first use: state S after it
    held = list(tr.master) + [v for m in tr.master for v in st[m].values() if torch.is_tensor(v)]
    start = [t.detach().clone() for t in held]
    gen_state = tr.generator.get_state()

    def result(vals):
        return {"values": [torch.tensor(vals)], "masters": [whole(m) for m in tr.master],
                "exp_avg": [whole(st[m]["exp_avg"]) for m in tr.master],
                "exp_avg_sq": [whole(st[m]["exp_avg_sq"]) for m in tr.master]}

    for _ in range(DIST_ROUTE_STEPS - 1):
        step()
    peaks = {"max_memory_allocated": torch.cuda.max_memory_allocated(),
             "max_memory_reserved": torch.cuda.max_memory_reserved()}
    captured = result(values[1:])
    (program,) = tr.program.programs.values()
    before = read_counters(), read_routes()
    t0 = time.perf_counter()
    profiled = device_profile(lambda: tr.train_step(x, y))
    profile_s = time.perf_counter() - t0
    per_step.append(launches_since(before))
    hist = [h["seconds"] for h in tr.history[n0:]]

    def eager_route():
        with torch.no_grad():
            for t, t0 in zip(held, start):
                t.copy_(t0)
        tr.generator.set_state(gen_state)
        vals = []
        for _ in range(DIST_ROUTE_STEPS - 1):
            t0 = time.perf_counter()
            out = tr.step_fn(x, y)
            vals.append(torch.stack([v.detach().float() for v in out]).tolist())
            eager_s.append(time.perf_counter() - t0)
        return result(vals)

    eager = eager_route()
    held_row = held_to_eager("dist stage1", captured, eager, eager_route)
    del captured, eager, start
    row = {"steps": DIST_ROUTE_STEPS, "losses": [v[0] for v in values], **held_row,
           "compared": "the steps after the first use, from its state",
           "step_s": hist, "first_use_step_s": hist[0],
           "eager_step_s": float(np.median([hist[0], *eager_s])),
           "capture_step_s": hist[1],
           "replayed_step_s": float(np.median(hist[2:DIST_ROUTE_STEPS])),
           "capture_s": program.capture_s, "replays": program.replays,
           "programs": len(tr.program.programs), **peaks,
           "launches_each_step": per_step, "profiled_replay": profiled,
           "profile_and_parse_s": profile_s,
           "profiled_replay_is_a_replay": program.replays == DIST_ROUTE_STEPS}
    log("dist stage1 programs", json.dumps(row))
    if not row["profiled_replay_is_a_replay"] or program.graph is None:
        raise AssertionError(f"dist stage1: {program.replays} replays, graph "
                             f"{program.graph is not None}")
    return row


def dist_checkpoint_round_trip(work, seed, mesh):
    """Gather, save (rank 0), load and re-shard an FSDP2 trainer's state
    after a step (the tiny configs, f32, a 64² image: at SD-v1.5 width the
    file is 10.3 GB, 81 s of host I/O a round trip, dist run 1): the
    parameters and the AdamW moments come back bit-equal."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    comps = SDComponents.random(seed=seed, device="cuda")
    tr = DiffusionWarmupTrainer(comps, DiffusionTrainConfig(num_inference_steps=25,
                                                            compute_dtype="float32",
                                                            num_classes=7),
                                work_dir=os.path.join(work, "dist_ck"), mesh=mesh)
    tr.train_step(*tr_batch(np.random.default_rng(seed + 16), 64))
    state = tr.opt.state
    before = [(m.to_local().clone(), state[m]["exp_avg"].to_local().clone(),
               state[m]["exp_avg_sq"].to_local().clone()) for m in tr.master]
    path = os.path.join(work, "dist_state.pkl")
    t0 = time.perf_counter()
    tr.save_state(path)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    with torch.no_grad():
        for m in tr.master:
            m.zero_()
    state.clear()
    t0 = time.perf_counter()
    tr.load_state(path)
    load_s = time.perf_counter() - t0
    os.remove(path)
    equal = all(torch.equal(a, m.to_local()) and torch.equal(b, state[m]["exp_avg"].to_local())
                and torch.equal(c, state[m]["exp_avg_sq"].to_local())
                for (a, b, c), m in zip(before, tr.master))
    if not equal or not all(hasattr(m, "to_local") for m in tr.master):
        raise AssertionError("dist: the sharded checkpoint did not round-trip bit-equal")
    return {"config": "tiny, f32", "bytes": size, "save_s": save_s, "load_s": load_s,
            "bit_equal": equal, "tensors": 3 * len(before)}


def dist_stage2(work, seed, mesh):
    """One segmentor step at the seg phase's plan (1024², batch 2, bf16)
    data-parallel over the mesh, plain and nnUNetTrainerBN (batch Dice and
    the BatchNorm over the group), against the one-device step from the
    same weights and draws; then the mesh trainer's programs
    (``dist_stage2_programs``)."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.models.convert import dynunet_batch_stats_to_flax
    from ldiffusion_tpu_torch.models.convert import flatten_tree
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    plan = seg_plan(*FULL_PLAN)
    rng = np.random.default_rng(seed + 14)
    data = rng.normal(size=(plan.batch_size, *plan.patch_size, 3)).astype(np.float32)
    seg = np.stack([train_labels(rng, size=plan.patch_size[0])
                    for _ in range(plan.batch_size)]).astype(np.int32)
    out = {}
    for variant in (None, "nnUNetTrainerBN"):
        runs = {}
        for name, m in (("one_device", None), ("ddp", mesh)):
            config = SegmentorTrainConfig()
            v = get_variant(variant, base=config) if variant else None
            tr = SegmentorTrainer(plan, config, output_dir=os.path.join(work, "dist_seg", name),
                                  variant=v, device="cuda", mesh=m)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = float(tr.train_step(data, seg, lr=0.01))
            torch.cuda.synchronize()
            runs[name] = {"loss": loss, "step_wall_s": time.perf_counter() - t0,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "momentum": {k: b.detach().float().cpu()
                                       for k, b in tr._momentum_state().items()},
                          "params": {k: p.detach().float().cpu()
                                     for k, p in tr.net.named_parameters()},
                          "stats": {k: torch.as_tensor(a) for k, a in flatten_tree(
                              dynunet_batch_stats_to_flax(tr.net.state_dict(),
                                                          tr.net_config)).items()}}
            if m is not None:
                runs[name]["programs"] = dist_stage2_programs(tr, data, seg)
            del tr
        one, ddp = runs["one_device"], runs["ddp"]

        def scale(k, t):  # a conv bias in front of a norm has a gradient of 0: rounding noise
            return t.abs().max().clamp_min(1.0 if k.endswith("conv.bias") else 1e-30)

        def worst(a, b):
            return max(float((a[k] - b[k]).abs().max() / scale(k, b[k])) for k in b) \
                if b else 0.0

        mom = worst(ddp["momentum"], one["momentum"])
        # SGD-nesterov's first step moves a parameter by lr·(1 + μ)·buffer
        step = 0.01 * (1 + SegmentorTrainConfig().momentum)
        upd = max(float((ddp["params"][k] - one["params"][k]).abs().max()
                        / (step * scale(k, one["momentum"][k]))) for k in one["params"])
        row = {"loss_one_device": one["loss"], "loss_ddp": ddp["loss"],
               "loss_rel_diff": abs(ddp["loss"] - one["loss"]) / abs(one["loss"]),
               "momentum_diff": mom, "update_diff": upd,
               "running_stats_diff": worst(ddp["stats"], one["stats"]),
               "batch_norm_tensors": len(one["stats"]), "programs": ddp["programs"],
               "step_wall_s": {k: r["step_wall_s"] for k, r in runs.items()},
               "peak_bytes": {k: r["peak_bytes"] for k, r in runs.items()}}
        key = variant or "default"
        out[key] = row
        log(f"dist stage2 {key}", json.dumps(row))
        if row["loss_rel_diff"] > DIST_SEG_LOSS_RTOL or mom > DIST_SEG_MOMENTUM or \
                upd > DIST_SEG_MOMENTUM or row["running_stats_diff"] > 1e-3 or \
                (variant is not None) != bool(row["batch_norm_tensors"]):
            raise AssertionError(f"dist stage2 {key}: the mesh step off the one-device step: "
                                 f"{row}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_stage2_programs(tr, data, seg):
    """The data-parallel segmentor after its compared step (its train
    program's eager first use; state S): DIST_SEG_ROUTE_STEPS steps through
    ``train_step`` (the capture, with the gradients' all-reduce, the batch
    Dice's and BatchNorm's sums and the loss's sum inside the graph, then
    replays) and 2 validation steps through ``val_step`` (the eager first
    use, the capture), against ``step_fn`` and ``_val_step`` called eagerly
    from S: losses, validation sums, parameters, buffers and the optimizer's
    state held by ``held_to_eager``. The s/iteration by route, each ending
    in the loss's read."""
    import numpy as np
    import torch

    held = [*tr.net.parameters(), *tr.net.buffers(),
            *(v for p in tr.net.parameters() for v in tr.opt.state[p].values()
              if torch.is_tensor(v))]
    start = [t.detach().clone() for t in held]
    gen_state = tr.generator.get_state()
    walls = {"eager": [], "programs": []}

    def run(captured: bool):
        with torch.no_grad():
            for t, t0 in zip(held, start):
                t.copy_(t0)
        tr.generator.set_state(gen_state)
        torch.cuda.synchronize()
        tr.net.train()
        losses = []
        for _ in range(DIST_SEG_ROUTE_STEPS):
            t0 = time.perf_counter()
            if captured:
                losses.append(float(tr.train_step(data, seg, lr=0.01)))
            else:
                rate = torch.full((), 0.01, dtype=torch.float32, device="cuda")
                losses.append(float(tr.step_fn(*tr._to_device(data, seg), rate)[0]))
            walls["programs" if captured else "eager"].append(time.perf_counter() - t0)
        tr.net.eval()
        sums = []
        with torch.no_grad():
            for _ in range(2):
                out = tr.val_step(data, seg) if captured else \
                    tr._val_step(*tr._to_device(data, seg))
                sums.extend(t.clone() for t in out)
        tr.net.train()
        return {"losses": [torch.tensor(losses)], "validation": sums,
                "state": [t.detach().clone() for t in held]}

    eager = run(False)
    captured = run(True)
    (train,), (val,) = tr.train_program.programs.values(), tr.val_program.programs.values()
    row = {"steps": DIST_SEG_ROUTE_STEPS, "validation_steps": 2,
           **held_to_eager("dist stage2", captured, eager, lambda: run(False)),
           "replays": {"train": train.replays, "validation": val.replays},
           "capture_s": {"train": train.capture_s, "validation": val.capture_s},
           "eager_s_per_iteration": float(np.median(walls["eager"])),
           "replayed_s_per_iteration": float(np.median(walls["programs"][1:])),
           "capture_step_s": walls["programs"][0]}
    if row["replays"] != {"train": DIST_SEG_ROUTE_STEPS, "validation": 1} or \
            train.graph is None or val.graph is None:
        raise AssertionError(f"dist stage2: replays {row['replays']}")
    return row


def dist_launcher(work, seed):
    """``python -m torch.distributed.run --nproc_per_node 1 -m
    ldiffusion_tpu_torch.ldiffusion`` on a ``random:`` path (stage 1, 64²,
    two training pairs a batch of one): exit 0, the UNet directory and rank
    0's loss log of the ten epochs written."""
    import numpy as np

    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig

    root = os.path.join(work, "dist_launch")
    args = train_pairs(os.path.join(root, "pairs"), 3, np.random.default_rng(seed + 15))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
           "-m", "ldiffusion_tpu_torch.ldiffusion", "--diffusion-path", "random:tiny",
           "--image-dir", args.image_dir, "--label-dir", args.label_dir, "--num-epochs", "1",
           "--batch-size", "1", "--num-inference-steps", "5", "--num-classes", "7",
           "--component", "ldiffusion"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (HERE, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                          timeout=DIST_LAUNCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    unet = sorted(glob.glob(os.path.join(root, "train_save", "unet", "*", "unet_params.npz")))
    csv = sorted(glob.glob(os.path.join(root, "train_save", "loss", "*", "contrast_loss.csv")))
    rows = open(csv[0]).read().splitlines() if csv else []
    row = {"returncode": proc.returncode, "wall_s": wall, "unet_params": len(unet),
           "loss_csv_rows": len(rows), "stdout_tail": proc.stdout[-600:]}
    log("dist launcher", json.dumps(row))
    epochs = DiffusionTrainConfig().num_epochs  # stage 1's ten epochs (the reference's)
    if proc.returncode != 0 or len(unet) != 1 or len(rows) != 1 + epochs or \
            rows[0] != "epoch,loss":
        raise AssertionError(f"dist launcher: {row}\n{proc.stderr[-3000:]}")
    return row


def phase_dist(work, seed):
    """The port's distribution on the card (module docstring, phase 13)."""
    import torch
    import torch.distributed as dist

    from ldiffusion_tpu_torch.core import dist as pdist
    from ldiffusion_tpu_torch.core.config import MeshConfig

    t_phase = time.perf_counter()
    row = {"gpu": gpu_line()}
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not pdist.maybe_init_distributed() or dist.get_backend() != "nccl":
            raise AssertionError("dist: no NCCL process group")
        nccl = torch.cuda.nccl.version()
        row["process_group"] = {"backend": dist.get_backend(),
                                "nccl_version": ".".join(map(str, nccl)) if
                                isinstance(nccl, tuple) else str(nccl),
                                "world_size": dist.get_world_size()}
        log("dist process group", json.dumps(row["process_group"]))
        mesh = pdist.make_mesh(MeshConfig())
        t0 = time.perf_counter()
        row["stage1"] = dist_stage1(work, seed, mesh)
        row["stage1_wall_s"] = time.perf_counter() - t0
        row["checkpoint"] = dist_checkpoint_round_trip(work, seed, mesh)
        log("dist checkpoint", json.dumps(row["checkpoint"]))
        t0 = time.perf_counter()
        row["stage2"] = dist_stage2(work, seed, mesh)
        row["stage2_wall_s"] = time.perf_counter() - t0
    finally:
        pdist.finish_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    row["launcher"] = dist_launcher(work, seed)
    row["phase_wall_s"] = time.perf_counter() - t_phase
    log(json.dumps({"dist": row}))
    fsdp2 = row["stage1"]["fsdp2"]
    return {"launches": fsdp2["launches"], "launches_by_route": fsdp2["launches_by_route"]}


def tr_batch(rng, size):
    """A (images, labels) batch of one synthetic size² ROI with 64² labels."""
    import numpy as np

    from ldiffusion_tpu_torch.data.dataset import IMAGENET_MEAN, IMAGENET_STD

    img = np.asarray(tissue_like(rng, size, size), np.float32) / 255.0
    return ((img - IMAGENET_MEAN) / IMAGENET_STD)[None], train_labels(rng)[None]


def kernel_family(name: str) -> str:
    n = name.lower()
    if "nccl" in n:
        return "collective (NCCL)"
    if "flash_fwd" in n:
        return "flash_attention_fwd (ours)"
    if "flash_bwd" in n:
        return "flash_attention_bwd (ours)"
    if any(k in n for k in ("gn_resident", "gn_stream", "gn_stats", "gn_finalize", "gn_apply")):
        return "groupnorm_silu (ours)"
    if any(k in n for k in ("conv", "cudnn", "implicit", "winograd", "dgrad", "fprop")):
        return "convolution (cuDNN)"
    if any(k in n for k in ("gemm", "cutlass", "cublas", "sm90_xmma", "ampere")):
        return "matmul (cuBLAS)"
    if "reduce" in n or "norm" in n or "softmax" in n:
        return "reduction / norm / softmax (PyTorch)"
    if "memcpy" in n or "memset" in n:
        return "copy / memset"
    return "elementwise and other (PyTorch)"


def device_profile(fn):
    """Run ``fn`` once under torch.profiler: wall seconds (host clock, ending in
    a synchronize), device busy ms, idle share, ms by kernel family, top
    kernels. Device activity only: every figure is read from the kernels,
    and host-op events made a profiled training step cost ~50 s to record
    and parse."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_kernel_ms(prof)
    busy = sum(kernels.values())
    families = {}
    for name, ms in kernels.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    ours = {}  # the port's kernels by name, template arguments dropped
    for name, ms in kernels.items():
        if kernel_family(name).endswith("(ours)"):
            short = name.split("<")[0].split("::")[-1].replace("void ", "")
            ours[short] = ours.get(short, 0.0) + ms
    return {"wall_s": wall, "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / (wall * 1e3)) if busy else None,
            "by_family_ms": dict(sorted(families.items(), key=lambda kv: -kv[1])),
            "ours_by_kernel_ms": dict(sorted(ours.items(), key=lambda kv: -kv[1])),
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def profile_roi(model, roi, seg, predictor, comps):
    """Device time by kernel over one 1024² single-ROI inference (API call,
    checkpoint loading included), the device's idle share over it, and the
    time of the compute alone (transform + sliding window, models resident)."""
    import numpy as np
    import torch

    from ldiffusion_tpu_torch.data.dataset import load_image
    from ldiffusion_tpu_torch.diffusion.pipeline import one_step_transform, trajectory_text_emb

    def compute():
        x = torch.from_numpy(load_image(roi, (1024, 1024)))[None].cuda()
        t = one_step_transform(comps, x, trajectory_text_emb(comps, 1))[0]
        return predictor.seg(t).cpu().numpy()

    with torch.inference_mode():
        compute()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compute()
            times.append(time.perf_counter() - t0)
    prof = device_profile(lambda: model.inference_tissue(roi, None, seg, 7))
    row = {"compute_s_per_roi": float(np.median(times)), "compute_s_runs": times,
           "api_wall_s": prof.pop("wall_s"), **prof}
    log("profile", json.dumps(row))
    return row


KERNEL_META = {
    "flash_attention_fwd": {
        "route": "cuda", "source": "ldiffusion_tpu_torch/csrc/flash_fwd_wgmma.cu",
        "replaces": "ldiffusion_tpu/ops/attention.py:41 (_flash_kernel, K1); "
                    ":102 (_flash_kvgrid_kernel, K2)",
        # launches of each path shape per ROI (UNet levels 0-2, VAE mid-block)
        "per_call": [5, 5, 5, 2]},
    "groupnorm_silu": {
        "route": "cuda", "source": "ldiffusion_tpu_torch/csrc/groupnorm_sm90.cu",
        # the resident and streamed routes; the first kernel, timed as "v1"
        "sources": ["ldiffusion_tpu_torch/csrc/groupnorm_sm90.cu",
                    "ldiffusion_tpu_torch/csrc/groupnorm.cu"],
        "replaces": "ldiffusion_tpu/ops/groupnorm.py:82 (_gn_kernel, K3); "
                    ":147 (_gn_stats_kernel, K4a); :168 (_gn_apply_kernel, K4b)",
        "per_call": None},
    "flash_attention_fwd_lse": {
        "route": "cuda", "source": "ldiffusion_tpu_torch/csrc/flash_fwd_wgmma.cu",
        "replaces": "ldiffusion_tpu/ops/attention.py:180 (_flash_kernel_lse, K5); its exp2 "
                    "softmax is tools/bench_attn_exp2.py:29 (_kernel, K7)",
        "per_call": TRAIN_PER_STEP["flash_attention_fwd_lse"]},
    "flash_attention_bwd": {
        "route": "cuda", "source": "ldiffusion_tpu_torch/csrc/flash_bwd_wgmma.cu",
        "replaces": "ldiffusion_tpu/ops/attention.py:245 (_flash_bwd_kernel, K6); its exp2 "
                    "softmax is tools/bench_attn_exp2.py:29 (_kernel, K7)",
        "per_call": TRAIN_PER_STEP["flash_attention_bwd"]},
    "groupnorm_silu_backward": {
        "route": "cuda", "source": "ldiffusion_tpu_torch/csrc/groupnorm_sm90.cu",
        "replaces": "none: ldiffusion_tpu/ops/groupnorm.py:319 (_gn_bwd) takes XLA's vjp",
        "per_call": None},
}


def kernel_summary(kernel_rows, launches, routes, by_path):
    """One entry per kernel, timed at its heaviest path shape (attention: the
    largest ms x launches per ROI or train step; GroupNorm: the largest map);
    the attention kernels also with their launches by route and the mma.sync
    kernels' time; the inference kernels with their launches on each main
    path that ran (``launches_by_path``)."""
    out = []
    for name, rows in kernel_rows.items():
        meta = KERNEL_META[name]
        if meta["per_call"]:
            rows_w = [(r["ms"] * n, r) for r, n in zip(rows, meta["per_call"])]
            top = max(rows_w, key=lambda p: p[0])[1]
        else:
            top = max(rows, key=lambda r: math.prod(r["shape"]))
        out.append({"name": name, "route": meta["route"], "source": meta["source"],
                    "replaces": meta["replaces"], "launches": launches.get(name, 0),
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": top["ms"], "plain_ms": top["plain_ms"],
                    "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
                    "library_ms": top["library_ms"], "shape": top["shape"]})
        for key in ("mma_ms", "mma_device_ms", "device_ms", "library_device_ms", "v1_ms",
                    "v1_device_ms", "sources", "eager_ms", "prev_ms"):
            if key in meta:
                out[-1][key] = meta[key]
            if key in top:
                out[-1][key] = top[key]
        if name in routes:
            out[-1]["launches_by_route"] = routes[name]
        paths = {p: n[name] for p, n in by_path.items() if name in n}
        if paths:
            out[-1]["launches_by_path"] = paths
        if name.startswith("groupnorm_silu"):  # each route at its largest map
            out[-1]["largest_by_route"] = {
                r["route"]: {k: r[k] for k in ("shape", "ms", "device_ms", "v1_device_ms",
                                               "library_device_ms", "bound_ms") if k in r}
                for r in sorted(rows, key=lambda r: math.prod(r["shape"]))}
    return out


# ---------------------------------------------------------------------------

def sass_counts(name: str) -> dict:
    """Hopper's warpgroup MMA (HGMMA) and TMA load (UTMALDG) instructions in
    the SASS of csrc/<name>.cu's library, as cuobjdump lists them."""
    import re

    from ldiffusion_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,tiny,full,train,seg,cell,cli,workflow,vol,gen,quant,dist",
                    help="comma-separated subset of "
                         "kernels,tiny,full,train,seg,cell,cli,workflow,vol,gen,quant,dist")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 1
    try:
        from ldiffusion_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the ldiffusion_tpu_torch package is not importable ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(gpu_line())  # the card's name and power limit, as nvidia-smi gives them
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.3f} s (nvcc, sm_90a, {len(_build.SOURCES)} "
        "sources in parallel)")
    for name in _build.SOURCES:
        log(f"--- ptxas {name}\n" + (_build.BUILD_DIR / f"{name}.log").read_text())

    for name in ("flash_fwd_wgmma", "flash_bwd_wgmma"):
        sass = sass_counts(name)
        log(f"sass {name}", json.dumps(sass))
        if min(sass.values()) == 0:
            raise AssertionError(f"{name}: no Hopper instructions in its SASS: {sass}")

    kernel_rows, launches, routes = {}, {}, {}
    by_path = {}  # each main path's launches, counted from 0 just before it
    walls = {"build": build_s}  # each phase's wall s, to trace the run's time
    left = {}  # device bytes still allocated after each phase

    @contextlib.contextmanager
    def wall(name):
        t0 = time.perf_counter()
        yield
        walls[name] = time.perf_counter() - t0
        gc.collect()  # what a phase leaves allocated once its objects are gone
        left[name] = torch.cuda.memory_allocated()
        # the next phase starts without this one's cached blocks: a capture
        # empties the cache first (a capture in the seg phase after the
        # kernels phase took 9.1 s, 0.08-0.13 s once the phases emptied it)
        torch.cuda.empty_cache()

    if "kernels" in phases:
        with wall("kernels"):
            kernel_rows = phase_kernels(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if "tiny" in phases:
            with wall("tiny"):
                phase_tiny(work, args.seed)
        if "full" in phases:  # the inference path's kernels: their launches there
            with wall("full"):
                full = phase_full(work, args.seed)
            by_path["full"] = full["launches"]
            launches.update({k: full["launches"][k] for k in INFERENCE_KERNELS})
            for name in INFERENCE_KERNELS:
                routes[name] = full["launches_by_route"][name]
        if "train" in phases:  # the training path's kernels: their launches there
            with wall("train"):
                train, train_routes = phase_train(work, args.seed)
            by_path["train"] = train
            log("train_launches", json.dumps({"launches": train,
                                              "launches_by_route": train_routes}))
            trained = ("flash_attention_fwd_lse", "flash_attention_bwd", "groupnorm_silu_backward")
            launches.update({k: train[k] for k in trained})
            for name in trained:
                routes[name] = train_routes[name]
        if "seg" in phases:  # stage 2 runs the inference kernels in its dataset build
            with wall("seg"):
                seg = phase_seg(work, args.seed)
            by_path["seg"] = seg["launches"]
            for name in INFERENCE_KERNELS:
                if name not in launches:
                    launches[name] = seg["launches"][name]
                    routes[name] = seg["launches_by_route"][name]
        if "cell" in phases:  # the cell level transforms every ROI it sees
            with wall("cell"):
                cell = phase_cell(work, args.seed)
            by_path["cell"] = cell["launches"]
            for name in INFERENCE_KERNELS:
                if name not in launches:
                    launches[name] = cell["launches"][name]
                    routes[name] = cell["launches_by_route"][name]
        if "cli" in phases:  # the segmentor CLI's dataset is built by the transform
            with wall("cli"):
                cli_out = phase_cli(work, args.seed)
            by_path["cli"] = cli_out["launches"]
            for name in INFERENCE_KERNELS:
                if name not in launches:
                    launches[name] = cli_out["launches"][name]
                    routes[name] = cli_out["launches_by_route"][name]
        if "workflow" in phases:  # run A after training; its datasets' build when alone
            with wall("workflow"):
                wf = phase_workflow(work, args.seed)
            by_path["workflow"] = wf["launches"]
            for name in INFERENCE_KERNELS:
                if name not in launches and wf["built"]:
                    launches[name] = wf["launches"][name]
                    routes[name] = wf["launches_by_route"][name]
        if "vol" in phases:  # the 3D pathway: cuDNN convolutions, none of our kernels
            with wall("vol"):
                by_path["vol"] = phase_vol(work, args.seed)["launches"]
        if "gen" in phases:  # the generation tail: the SD blocks at batch 1 and 4
            with wall("gen"):
                gen = phase_gen(work, args.seed)
            by_path["gen"] = gen["launches"]
            for name in INFERENCE_KERNELS:
                if name not in launches:
                    launches[name] = gen["launches"][name]
                    routes[name] = gen["launches_by_route"][name]
        if "quant" in phases:  # the int8 modes: the same kernels, int8 convs between them
            with wall("quant"):
                q = phase_quant(work, args.seed)
            by_path["quant"] = q["launches"]
            for name in INFERENCE_KERNELS:
                if name not in launches:
                    launches[name] = q["launches"][name]
                    routes[name] = q["launches_by_route"][name]
        if "dist" in phases:  # stage 1 under FSDP2: the training kernels' launches there
            with wall("dist"):
                d = phase_dist(work, args.seed)
            by_path["dist"] = d["launches"]
            for name in d["launches"]:
                if name not in launches:
                    launches[name] = d["launches"][name]
                    routes[name] = d["launches_by_route"][name]

    log(json.dumps({"phase_wall_s": walls}))
    log(json.dumps({"memory_allocated_after_phase": left}))
    log(json.dumps({"kernels": kernel_summary(kernel_rows, launches, routes, by_path)}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
