"""Stage-1 fine-tuning traffic: ``DiffusionWarmupTrainer.train_step`` back to
back, as its ``train`` loop calls it, each step on the next batch of a pool
of seeded tissue-like pairs in the form ``SegmentationDataset.iter_batches``
yields (images (B, s, s, 3) float32 ImageNet-normalised, labels (B, l, l)
int32).

Traffic parameters: ``batch``, ``image_size``, ``label_size``, ``classes``,
``pool`` (pairs made in set-up), ``checked_steps`` (the first steps, which
set-up drives through the same call and the reference follows).

Set-up builds one trainer from the benchmark's weights and drives it
through the checked steps (the first eager, the second captured, then
replays): every shape is warm before the window. After step 1 it keeps a
host copy of each trained tensor's first gradient as AdamW got it (its
first moment over 1 − β1), after the last checked step of the master
weights.
The check frees the trainer, runs the reference's steps on the same pairs
with the same seed, and reads the losses, the first gradient and the change
over the checked steps against the reference's (``readings_of``); the
cell's ``limits`` name the readings it compares.
"""
from __future__ import annotations

import contextlib
import gc

import numpy as np
import torch

from portbench import data, program, weights
from portbench.harness import setup_part, span
from portbench.reference import counts as arithmetic
from portbench.reference import diffusion, models
from portbench.reference.stage1 import Indices, Stage1

# a trained tensor whose reference first gradient is below this share of the
# median tensor's moves by round-off alone under AdamW: left out of the change
STILL_SHARE = 1e-3


def _pool(run):
    t = run.cell["traffic"]
    gen = torch.Generator(device=run.device).manual_seed(
        weights.sub_seed(run.seed, weights.INPUTS))
    rois = data.tissue_rois(t["pool"], t["image_size"], gen, run.device)
    labels = data.label_maps(t["pool"], t["label_size"], t["classes"], gen, run.device)
    return diffusion.normalise(rois).cpu().numpy(), labels.cpu().numpy()


def _batch(state, i):
    b, n = state["batch"], len(state["images"])
    rows = [(i * b + r) % n for r in range(b)]
    return state["images"][rows], state["labels"][rows]


def _train_config(run):
    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig

    tr = run.config["train"]
    return DiffusionTrainConfig(
        batch_size=run.cell["traffic"]["batch"], num_inference_steps=tr["num_inference_steps"],
        learning_rate=tr["learning_rate"], betas=tuple(tr["betas"]), eps=tr["eps"],
        weight_decay=tr["weight_decay"], grad_clip=tr["grad_clip"],
        latent_size=run.cell["traffic"]["label_size"], image_size=run.cell["traffic"]["image_size"],
        param_dtype=tr["param_dtype"], compute_dtype=tr["compute_dtype"], remat=tr["remat"],
        seed=weights.sub_seed(run.seed, weights.TRAINER), num_classes=tr["num_classes"])


def setup(run):
    from ldiffusion_tpu_torch.losses.infonce import InfoNceLoss
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    cfg, tr = run.config, run.config["train"]
    with setup_part(run, "weights"):
        states = program.sd_states(cfg, run.seed, run.device, torch.float32, vgg=True)
        comps = program.program_components(cfg, states, run.device)
        loss = InfoNceLoss(vgg=program.program_vgg(states["vgg"], run.device),
                           temperature=tr["temperature"], num_negatives=tr["num_negatives"],
                           num_anchors=tr["num_anchors"], num_classes=tr["num_classes"])
        del states
    with setup_part(run, "trainer"):
        trainer = DiffusionWarmupTrainer(comps, _train_config(run), work_dir=run.tmp,
                                         info_nce=loss)
    with setup_part(run, "pool"):
        images, labels = _pool(run)
    state = {"trainer": trainer, "images": images, "labels": labels,
             "batch": run.cell["traffic"]["batch"], "next": 0, "losses": []}
    beta1 = tr["betas"][0]
    for i in range(run.cell["traffic"]["checked_steps"]):
        with setup_part(run, f"checked_step_{i + 1}"):  # eager, capture, replays
            metrics = trainer.train_step(*_batch(state, i))
        state["losses"].append(metrics["loss"])
        if i == 0:  # the first gradient as AdamW got it: its first moment / (1 − β1)
            with setup_part(run, "host_copies"):
                moments = [trainer.opt.state[m].get("exp_avg", torch.zeros_like(m))
                           for m in trainer.master]
                state["grad"] = [g.div_(1.0 - beta1) for g in _to_host(moments)]
    with setup_part(run, "host_copies"):
        state["params"] = _to_host(trainer.master)
    state["names"] = [f"{k}.{n}" for k, n in trainer.names]
    state["next"] = run.cell["traffic"]["checked_steps"]
    return state


def window(run, state, seconds):
    import time

    trainer, steps, failed = state["trainer"], 0, 0
    t0 = time.perf_counter()
    while True:
        with span("load_batch"):
            images, labels = _batch(state, state["next"] + steps)
        with span("train_step"):
            metrics = trainer.train_step(images, labels)
        steps += 1
        failed += not np.isfinite(metrics["loss"])
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    return {"steps": steps, "batch": state["batch"], "seconds": elapsed,
            "attempted": steps, "failed": failed}


def _to_host(tensors) -> list:
    """float32 host copies of device tensors, in one pinned block, with no
    device memory of their own."""
    n = sum(t.numel() for t in tensors)
    block = torch.empty(n, dtype=torch.float32, pin_memory=torch.cuda.is_available())
    out, off = [], 0
    for t in tensors:
        view = block[off:off + t.numel()].view(t.shape)
        view.copy_(t.detach(), non_blocking=True)
        out.append(view)
        off += t.numel()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def _gap(prog, ref, floor):
    return abs(prog - ref) / max(ref, floor)


def readings_of(prog: dict, ref: dict, init: dict, device) -> dict:
    """What a run (the program's, or the control's) reads against the
    reference's. Each is {"losses": per checked step, "grad": each trained
    tensor's first clipped gradient, "params": each after the checked
    steps}; ``init`` holds the tensors before them. Readings:

    - ``loss_gap``: the worst step's relative loss gap;
    - ``grad_gap`` / ``change_gap``: each tensor's gap of norms, of the
      first gradient and of the change over the checked steps, against the
      reference's norm of that tensor or of the median tensor, whichever is
      larger, at the worst tensor (``grad_worst`` names it for the
      gradient); ``grad_gap_median``: at the median tensor;
    - ``grad_err`` / ``change_err``: the norm of the difference over all the
      trained tensors, relative to the reference's norm.

    Tensors whose reference first gradient is under ``STILL_SHARE`` of the
    median tensor's are left out of the change."""
    names = list(ref["grad"])
    rows = []  # per tensor: |g_p|, |g_r|, |g_p - g_r|, |Δ_p|, |Δ_r|, |Δ_p - Δ_r|
    with torch.no_grad():
        for k in names:
            gp, gr = prog["grad"][k].to(device), ref["grad"][k].to(device)
            pp, pr = prog["params"][k].to(device), ref["params"][k].to(device)
            rows.append(torch.stack([gp.norm(), gr.norm(), (gp - gr).norm(),
                                     (pp - init[k]).norm(), (pr - init[k]).norm(),
                                     (pp - pr).norm()]))
    gp, gr, gd, cp, cr, cd = torch.stack(rows).double().cpu().numpy().T
    median = float(np.median(gr))
    grad_gaps = np.array([_gap(a, b, median) for a, b in zip(gp, gr)])
    moving = gr >= STILL_SHARE * median
    change_median = float(np.median(cr[moving]))
    change_gaps = np.array([_gap(a, b, change_median) for a, b in zip(cp[moving], cr[moving])])
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
            "grad_gap": float(grad_gaps.max()), "grad_gap_median": float(np.median(grad_gaps)),
            "change_gap": float(change_gaps.max()),
            "grad_err": float(np.sqrt(np.sum(gd ** 2) / np.sum(gr ** 2))),
            "change_err": float(np.sqrt(np.sum(cd[moving] ** 2) / np.sum(cr[moving] ** 2))),
            "grad_worst": names[int(grad_gaps.argmax())]}


def _free(state):
    state.pop("trainer", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _init(run) -> dict:
    """The seeded weights before the first step, by module, and the trained ones by name."""
    init = program.sd_states(run.config, run.seed, run.device, torch.float32, vgg=True)
    return init, {f"{k}.{name}": t for k in ("unet", "proj") for name, t in init[k].items()}


def reference_readings(run, state, init: dict, prec=None, host: bool = False) -> dict:
    """The reference's checked steps on the program's pairs, from the same
    weights and seed (``readings_of``'s form); ``host``: its tensors copied
    to the host."""
    ref = Stage1(run.config, init, run.device, weights.sub_seed(run.seed, weights.TRAINER), prec)
    steps = []
    with models.reference_math():
        for i in range(run.cell["traffic"]["checked_steps"]):
            images, labels = (torch.as_tensor(x, device=run.device) for x in _batch(state, i))
            steps.append(ref.step(images, labels.long()))
    names = list(ref.trained)
    grad = [steps[0]["grads"][k] for k in names]
    params = [ref.trained[k].detach() for k in names]
    if host:
        grad, params = _to_host(grad), _to_host(params)
    return {"losses": [s["loss"] for s in steps], "grad": dict(zip(names, grad)), "params": dict(zip(names, params))}


def readings(run, state) -> dict:
    """The program's checked steps against the reference's (module docstring)."""
    _free(state)
    init, trained = _init(run)
    prog = {"losses": state["losses"], "grad": dict(zip(state["names"], state["grad"])),
            "params": dict(zip(state["names"], state["params"]))}
    return readings_of(prog, reference_readings(run, state, init), trained, run.device)


def check(run, state):
    """The readings the cell compares: those its ``limits`` name."""
    r = readings(run, state)
    return {k: (r[k], limit) for k, limit in run.cell["limits"].items()}


def control(run) -> dict:
    """The control's readings: the reference with its products in float8 in
    the program's place, against the float32 reference, on the pairs and
    seed of ``run``."""
    state = {"batch": run.cell["traffic"]["batch"]}
    state["images"], state["labels"] = _pool(run)
    init, trained = _init(run)
    low = reference_readings(run, state, init, models.Precision(fp8=True), host=True)
    return readings_of(low, reference_readings(run, state, init), trained, run.device)


def counts(cell, cfg) -> dict:
    """A step's FLOPs (forward and backward, no recomputation) and the
    attention calls that the attention kernels serve, at the cell's shapes
    (``reference.counts``)."""
    t, tr = cell["traffic"], cfg["train"]
    batch, size = t["batch"], t["image_size"]
    dev = torch.device("meta")
    state = {k: m.state_dict() for k, m in program.reference_modules(cfg, vgg=True).items()}
    ref = Stage1(cfg, state, dev, seed=0)
    n_t = len(diffusion.plms_timesteps(ref.steps)[0])
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    with dev:
        images = torch.zeros(batch, size, size, 3)
        labels = torch.zeros(batch, t["label_size"], t["label_size"], dtype=torch.long)
        noise = torch.zeros(n_t, batch, size // f, size // f, cfg["vae"]["latent_channels"])
        idx = Indices(torch.zeros(batch, tr["num_anchors"], dtype=torch.long),
                      torch.zeros(batch, tr["num_anchors"], dtype=torch.long),
                      torch.zeros(batch, tr["num_anchors"], tr["num_negatives"],
                                  dtype=torch.long),
                      torch.ones(batch, tr["num_anchors"], dtype=torch.bool))
    flops = arithmetic.flops(
        lambda: ref.loss(images, labels, noise, idx, remat=False)[0].backward())
    with models.recording() as calls:  # as the program runs it: remat on
        ref.loss(images, labels, noise, idx, remat=tr["remat"])[0].backward()
    kernel_d = arithmetic.FLASH_BWD_MAX_HEAD_DIM
    fwd = [c for c in calls["attention"] if c[2] >= arithmetic.FLASH_MIN_KEYS]
    with_bwd = [c for c in fwd if c[4] <= kernel_d]
    # remat records each of these twice: in the forward and in its recomputation
    bwd = with_bwd[:len(with_bwd) // 2] if tr["remat"] else with_bwd
    bounds = [arithmetic.attention_bound(*c, backward=False, lse=c[4] <= kernel_d) for c in fwd]
    bounds += [arithmetic.attention_bound(*c, backward=True, lse=True) for c in bwd]
    return {"flops_per_step": flops,
            "attention": {"forward_calls": len(fwd), "backward_calls": len(bwd),
                          "shapes_b_sq_sk_h_d": [list(c) for c in sorted(set(fwd))],
                          "ops_per_step": sum(b["ops"] for b in bounds),
                          "bytes_per_step": sum(b["bytes"] for b in bounds),
                          "bound_s_per_step": sum(b["bound_s"] for b in bounds)},
            "shapes": {"batch": batch, "image": [size] * 2, "labels": [t["label_size"]] * 2}}


@contextlib.contextmanager
def state_unchanged():
    """Fault: the step computes its gradients and norm but never updates."""
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    kept = DiffusionWarmupTrainer._update

    def _update(self):
        return torch.nn.utils.clip_grad_norm_(self.master, self.cfg.grad_clip)

    DiffusionWarmupTrainer._update = _update
    try:
        yield
    finally:
        DiffusionWarmupTrainer._update = kept


@contextlib.contextmanager
def half_batch():
    """Fault: the loss of the first half of the batch, its mean over those rows."""
    from ldiffusion_tpu_torch.losses.infonce import ContrastIndices
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    kept = DiffusionWarmupTrainer.local

    def local(self, images, labels, noise, indices):
        h = max(1, labels.shape[0] // 2)
        return (images[:h], labels[:h], noise[:, :h],
                ContrastIndices(*(t[:h] for t in indices)))

    DiffusionWarmupTrainer.local = local
    try:
        yield
    finally:
        DiffusionWarmupTrainer.local = kept


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}
