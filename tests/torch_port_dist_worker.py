"""One rank of the port's multi-process CPU tests (not a test module: it
imports only torch and the port, so a rank never imports JAX).

    python tests/torch_port_dist_worker.py TASK RANK WORLD DIR [ARGS...]

joins a gloo process group of WORLD ranks through ``file://DIR/init``,
reads its inputs from ``DIR/inputs.npz`` (made by the test, the JAX
package's draws among them) and writes ``DIR/out_<RANK>.npz``. ``TASK``:
  * ``stage1 DATA FSDP``: one stage-1 step of ``DiffusionWarmupTrainer``
    under FSDP2 on a (DATA, FSDP) mesh; the loss, gradients, norm, updated
    parameters and AdamW moments, gathered; then the state's round trip
    through ``save_state`` / ``load_state``;
  * ``seg``: one ``SegmentorTrainer`` step, data-parallel, plain and BN;
  * ``dice``: the batch-Dice loss and its gradient, averaged over ranks;
  * ``val``: the final validation, each rank its interleaved cases;
  * ``mesh``: the groups of a (data=2, tensor=2) mesh, and of a mesh over
    ranks 0 and 1 alone (the segmentor CLI's subgroup); no inputs;
  * ``graphs DATA FSDP``: both trainers over a (DATA, FSDP) mesh through
    their programs (``core/graphs.py:Jit``), one step of each under
    ``HostReadGuard``.

``HostReadGuard`` and ``card_optimizer`` serve the test processes too.
"""
import json
import os
import sys
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ldiffusion_tpu_torch.core.config import MeshConfig
from ldiffusion_tpu_torch.core.dist import make_mesh
from ldiffusion_tpu_torch.models.convert import flatten_tree, unflatten_tree


def _inputs(root, wait_s: float = 120.0):
    """``inputs.npz``, which the test may write after starting the ranks
    (it renames the file into place whole)."""
    path = os.path.join(root, "inputs.npz")
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > wait_s:
            raise TimeoutError(path)
        time.sleep(0.05)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


class HostReadGuard(TorchDispatchMode):
    """Records every op that reads a tensor's value to the host, what a
    captured step cannot hold (a copy to the host and a wait for the
    device): ``reads`` lists each as "op at file:line", the innermost
    frame of the port."""

    READS = (torch.ops.aten._local_scalar_dense, torch.ops.aten.is_nonzero,
             torch.ops.aten.nonzero, torch.ops.aten.equal)

    def __init__(self):
        super().__init__()
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.READS:
            import traceback

            port = [f for f in traceback.extract_stack() if "ldiffusion_tpu_torch" in f.filename]
            where = f"{port[-1].filename}:{port[-1].lineno}" if port else "?"
            self.reads.append(f"{func} at {where}")
        return func(*args, **(kwargs or {}))


def card_optimizer(opt, monkeypatch=None):
    """``opt`` (torch's Adam or AdamW) as the trainers make it on a card,
    ``capturable``: its step count and bias corrections on the parameters'
    device, before its first step. torch allows it on the CPU only through
    its list of devices, which is widened here (through ``monkeypatch``
    when given, so that a test undoes it); the CPU's own route keeps the
    count on the host and reads it every step, by design."""
    import torch.optim.adam as adam_module

    devices = adam_module._get_capturable_supported_devices
    (monkeypatch.setattr if monkeypatch else setattr)(
        adam_module, "_get_capturable_supported_devices",
        lambda *a, **k: [*devices(*a, **k), "cpu"])
    for group in opt.param_groups:
        group["capturable"] = True
    return opt


def _flat(prefix, tree):
    return {f"{prefix}/{k}": v for k, v in flatten_tree(tree).items()}


def stage1(root, data, fsdp):
    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.losses.infonce import ContrastIndices, InfoNceLoss
    from ldiffusion_tpu_torch.models.vgg import VGG19Features, vgg_from_flax
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    x = _inputs(root)
    cfg = json.loads(str(x["config"]))
    mesh = make_mesh(MeshConfig(data=data, fsdp=fsdp), device="cpu")
    vgg = VGG19Features()
    vgg.load_state_dict(vgg_from_flax(unflatten_tree(
        {k[4:]: v for k, v in x.items() if k.startswith("vgg/")})))
    info = InfoNceLoss(vgg=vgg.requires_grad_(False).eval(), num_anchors=cfg["anchors"],
                       num_negatives=cfg["negatives"], num_classes=cfg["classes"])
    comps = SDComponents.random(device="cpu")
    trainer = DiffusionWarmupTrainer(
        comps, DiffusionTrainConfig(compute_dtype="float32", num_classes=cfg["classes"],
                                    num_inference_steps=cfg["steps"], remat=cfg["remat"]),
        info_nce=info, mesh=mesh)
    idx = ContrastIndices(*(torch.from_numpy(x[k]) for k in
                            ("anchor", "positive", "negatives", "valid")))
    loss, _ = trainer.loss_and_grads(torch.from_numpy(x["images"]),
                                       torch.from_numpy(x["labels"]).long(),
                                       torch.from_numpy(x["noise"]), idx)
    out = {"loss": float(loss), **_flat("grad", trainer._flax(trainer.state_dicts(lambda m: m.grad)))}
    out["norm"] = float(trainer.apply_update())
    state = trainer.opt.state
    out.update(_flat("param", trainer._flax(trainer.state_dicts())))
    out.update(_flat("mu", trainer._flax(trainer.state_dicts(lambda m: state[m]["exp_avg"]))))
    out.update(_flat("nu", trainer._flax(trainer.state_dicts(lambda m: state[m]["exp_avg_sq"]))))
    # the sharded checkpoint: gathered, written by rank 0, read and re-sharded
    local = [(m.to_local().clone(), state[m]["exp_avg"].to_local().clone(),
              state[m]["exp_avg_sq"].to_local().clone()) for m in trainer.master]
    path = os.path.join(root, "state.pkl")
    trainer.save_state(path)
    dist.barrier()
    with torch.no_grad():
        for m in trainer.master:
            m.zero_()
    trainer.opt.state.clear()
    trainer.load_state(path)
    out["roundtrip_equal"] = all(
        torch.equal(a, m.to_local()) and torch.equal(b, state[m]["exp_avg"].to_local())
        and torch.equal(c, state[m]["exp_avg_sq"].to_local())
        for (a, b, c), m in zip(local, trainer.master))
    out["sharded"] = any(m.to_local().shape != m.shape for m in trainer.master)
    return out


def _seg_trainer(x, root, mesh, variant):
    from ldiffusion_tpu_torch.core.config import SegmentorTrainConfig
    from ldiffusion_tpu_torch.data.augment import AugmentConfig
    from ldiffusion_tpu_torch.models.convert import dynunet_from_flax
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.segmentor.variants import get_variant

    cfg = json.loads(str(x["config"]))
    plan = SegPlan(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["plan"].items()})
    config = SegmentorTrainConfig(compute_dtype="float32")
    v = get_variant(variant, base=config) if variant else None
    tr = SegmentorTrainer(plan, config,
                          output_dir=os.path.join(root, "seg"), variant=v,
                          augment=AugmentConfig(**cfg["augment"]), device="cpu", mesh=mesh)
    tree = unflatten_tree({k[7:]: x[k] for k in x if k.startswith("params/")})
    stats = unflatten_tree({k[6:]: x[k] for k in x if k.startswith("stats/")}) or None
    tr.net.load_state_dict(dynunet_from_flax(tree, tr.net_config, stats))
    return tr


def seg(root, data, with_bn):
    """One SGD step of the data-parallel segmentor (plain, or
    nnUNetTrainerBN)."""
    from ldiffusion_tpu_torch.models.convert import (
        dynunet_batch_stats_to_flax,
        dynunet_to_flax,
    )

    x = _inputs(root)
    mesh = make_mesh(MeshConfig(data=data), device="cpu")
    tr = _seg_trainer(x, root, mesh, "nnUNetTrainerBN" if with_bn else None)
    loss = tr.train_step(x["data"], x["seg"], lr=0.01)
    sd = tr.net.state_dict()
    return {"loss": float(loss), **_flat("params", dynunet_to_flax(sd, tr.net_config)),
            **_flat("momentum", dynunet_to_flax(tr._momentum_state(), tr.net_config)),
            **_flat("stats", dynunet_batch_stats_to_flax(sd, tr.net_config))}


def dice(root, data):
    """The batch-Dice loss of a 1x1 convolution's logits, replicated over
    the ranks: each rank its rows, the group's sums; the weight's gradient
    after the mean over the ranks (``mean_gradients``)."""
    from ldiffusion_tpu_torch.losses.dice import soft_dice_loss

    x = _inputs(root)
    mesh = make_mesh(MeshConfig(data=data), device="cpu")
    conv = torch.nn.Conv2d(x["data"].shape[-1], int(x["classes"]), 1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(x["weight"]))
        conv.bias.zero_()
    model = mesh.replicate_module(conv)
    inp = mesh.local_rows(torch.from_numpy(x["data"]).permute(0, 3, 1, 2))
    loss = soft_dice_loss(model(inp), mesh.local_rows(torch.from_numpy(x["seg"])),
                          group=mesh.batch_group)
    loss.backward()
    mesh.mean_gradients(model.parameters())
    return {"loss": float(loss), "grad": conv.weight.grad.numpy()}


def val(root, data):
    """The final validation on the ranks: each its interleaved cases."""
    x = _inputs(root)
    mesh = make_mesh(MeshConfig(data=data), device="cpu")
    tr = _seg_trainer(x, root, mesh, None)
    scored = []
    score = tr._score_validation
    tr._score_validation = lambda *a: scored.append(1) or score(*a)
    n = int(x["cases"])
    summary = tr.perform_actual_validation([x[f"image_{i}"] for i in range(n)],
                                           [x[f"label_{i}"] for i in range(n)])
    return {"cases": len(tr.val_case_seconds), "scored": len(scored),
            "summary": json.dumps(summary)}


def mesh_groups(root):
    """The ranks of a (data=2, tensor=2) mesh's groups, its rows of a batch
    of 8, a sum over its batch group and its barrier; then a mesh over ranks
    0 and 1: they sum over it and barrier, the others leave at once."""
    from ldiffusion_tpu_torch.core.dist import all_reduce_sum

    del root
    me = float(dist.get_rank())
    mesh = make_mesh(MeshConfig(data=2, tensor=2), device="cpu")
    mesh.barrier("whole_mesh")
    rows = mesh.row_slice(8)
    out = {"group": dist.get_process_group_ranks(mesh.group),
           "batch_group": dist.get_process_group_ranks(mesh.batch_group),
           "rows": [rows.start, rows.stop],
           "batch_sum": float(all_reduce_sum(torch.tensor(me), mesh.batch_group))}
    sub = make_mesh(MeshConfig(data=2), device="cpu", ranks=range(2))
    out["member"] = sub.member
    if sub.member:
        out["sub_group"] = dist.get_process_group_ranks(sub.group)
        out["sub_sum"] = float(all_reduce_sum(torch.tensor(me), sub.batch_group))
        sub.barrier("subgroup")
    return out


def graphs(root, data, fsdp):
    """Both trainers over a (DATA, FSDP) mesh through their ``Jit``s (on
    the CPU a program runs its function at every call): stage 1 (FSDP2)
    two steps of half the batch, the second under ``HostReadGuard``, then
    one of the whole batch (a second program); the segmentor (data-parallel,
    batch Dice) two train steps, the second guarded, and two validation
    steps, the first guarded. The optimizers as on a card
    (``card_optimizer``)."""
    from ldiffusion_tpu_torch.core.config import DiffusionTrainConfig, SegmentorTrainConfig
    from ldiffusion_tpu_torch.diffusion.pipeline import SDComponents
    from ldiffusion_tpu_torch.losses.infonce import InfoNceLoss
    from ldiffusion_tpu_torch.segmentor.planner import SegPlan
    from ldiffusion_tpu_torch.segmentor.trainer import SegmentorTrainer
    from ldiffusion_tpu_torch.train.ldiffusion import DiffusionWarmupTrainer

    x = _inputs(root)
    cfg = json.loads(str(x["config"]))
    mesh = make_mesh(MeshConfig(data=data, fsdp=fsdp), device="cpu")
    info = InfoNceLoss.create(device="cpu", num_anchors=cfg["anchors"],
                              num_negatives=cfg["negatives"], num_classes=cfg["classes"])
    tr = DiffusionWarmupTrainer(
        SDComponents.random(device="cpu"),
        DiffusionTrainConfig(compute_dtype="float32", num_classes=cfg["classes"],
                             num_inference_steps=cfg["steps"]), info_nce=info, mesh=mesh)
    card_optimizer(tr.opt)
    images, labels = x["images"], x["labels"]
    half = images.shape[0] // 2
    tr.train_step(images[:half], labels[:half])
    with HostReadGuard() as guard:
        tr.train_step(images[half:], labels[half:])
    tr.train_step(images, labels)
    out = {"stage1_reads": guard.reads,
           "stage1_losses": [h["loss"] for h in tr.history],
           "stage1_calls": sorted(p.calls for p in tr.program.programs.values()),
           "stage1_sharded": all(hasattr(m, "to_local") for m in tr.master)}

    plan = SegPlan(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["plan"].items()})
    st = SegmentorTrainer(plan, SegmentorTrainConfig(compute_dtype="float32"),
                          output_dir=os.path.join(root, "seg"), device="cpu", mesh=mesh)
    st.train_step(x["data"], x["seg"], lr=0.01)
    with HostReadGuard() as guard:  # the outputs are read after it
        loss = st.train_step(x["data"], x["seg"], lr=0.009).clone()
        val = [t.clone() for t in st.val_step(x["data"], x["seg"])]
    val_again = st.val_step(x["data"], x["seg"])
    out.update(seg_reads=guard.reads, seg_loss=float(loss),
               seg_train_calls=[p.calls for p in st.train_program.programs.values()],
               seg_val_calls=[p.calls for p in st.val_program.programs.values()],
               seg_val_equal=all(torch.equal(a, b) for a, b in zip(val, val_again)),
               seg_val_loss=float(val[0]))
    return out


TASKS = {"stage1": stage1, "seg": seg, "dice": dice, "val": val, "mesh": mesh_groups,
         "graphs": graphs}


def main(argv):
    task, rank, world, root = argv[0], int(argv[1]), int(argv[2]), argv[3]
    warnings.simplefilter("ignore")
    torch.manual_seed(0)
    torch.set_num_threads(1)  # the test process and the other test workers share the cores
    dist.init_process_group("gloo", init_method="file://" + os.path.join(root, "init"),
                            rank=rank, world_size=world)
    try:
        out = TASKS[task](root, *(int(a) for a in argv[4:]))
        np.savez(os.path.join(root, f"out_{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
