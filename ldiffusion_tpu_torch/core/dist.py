"""Process groups and the device mesh (counterpart of
``ldiffusion_tpu/core/dist.py``), on ``torch.distributed``.

One process drives one device. ``torch.distributed.run`` (torchrun) starts
the processes and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; ``maybe_init_distributed`` joins them
into a process group: NCCL on ``cuda:LOCAL_RANK``, gloo only when the caller
asked for ``device="cpu"``. Without a launcher it does nothing, and the
trainers run in one process.

The mesh has the JAX package's axes, ``(data, fsdp, tensor)``, over the
ranks in order (rank = (d·fsdp + f)·tensor + t):
  * ``data``: the batch is split over it, the parameters replicated;
  * ``fsdp``: the batch is split over it too, the parameters and the
    optimizer state sharded (FSDP2's ``fully_shard``, the counterpart of
    ``param_sharding_fn``; the reference's ZeRO-3);
  * ``tensor``: reserved, as in the JAX package: it shards nothing, and the
    batch is replicated over it.

``shard_module`` puts a module under FSDP2 over (data, fsdp): FSDP when
``data`` is 1, HSDP (replicated over ``data``, sharded over ``fsdp``)
otherwise, which is replication when ``fsdp`` is 1. The JAX package keeps
leaves under 2^18 elements replicated (``min_size_to_shard``); FSDP2 shards
every parameter of a unit, a layout choice that leaves the numbers as they
are. ``replicate_module`` and ``mean_gradients`` are the data-parallel
counterpart (the JAX data-parallel pjit, the reference's DDP): the module's
parameters and buffers are broadcast once from the batch group's first rank,
and after each backward the gradients are averaged over the group by one
all-reduce of one flat f32 buffer, the one gradient all-reduce that pjit
inserts into the JAX step. There is no ``DistributedDataParallel``: its
reducer buckets gradients in host-side state from autograd hooks, and a
captured CUDA graph (``core/graphs.py``) holds DDP only after many eager
iterations on a side stream. A step made of these device ops and
collectives is captured whole.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ldiffusion_tpu_torch.core.config import MeshConfig
from ldiffusion_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
COLLECTIVE_TIMEOUT = datetime.timedelta(hours=2)


def launched() -> bool:
    """True when a launcher (torchrun) set this process's rank environment."""
    return all(k in os.environ for k in _LAUNCHER_ENV)


def maybe_init_distributed(device=None) -> bool:
    """Join the launcher's process group (counterpart of
    ``maybe_init_multihost``, reference ``ldiffusion.py:37-38``). ``device``:
    None → NCCL on ``cuda:LOCAL_RANK`` (raises when there is no card);
    ``"cpu"`` → gloo. A no-op without a launcher environment and when the
    group is up already. Returns whether a process group is up."""
    if dist.is_available() and dist.is_initialized():
        return True
    if not launched():
        return False
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = process_device(device)
    # rank 0 builds the transformed dataset alone (``on_main``; 0.57 s a 1024²
    # ROI on an NVIDIA H100 80GB HBM3 at 700 W) while the others wait in a
    # collective: NCCL's default 10 minutes would end a build of ~1000 ROIs
    kw = dict(init_method="env://", rank=rank, world_size=world, timeout=COLLECTIVE_TIMEOUT)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return True


def finish_distributed() -> None:
    """Leave the process group, when one is up (at the end of a command)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_device(device=None, local_rank: int = -1) -> torch.device:
    """This process's device, decided here alone (the process group, the
    mesh and the API all take it from here): ``device`` when it names a card
    or the CPU; else ``cuda:LOCAL_RANK`` under a launcher; else
    ``cuda:local_rank`` when ``local_rank`` ≥ 0; else
    ``resolve_device(device)``."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if local_rank >= 0:
        return torch.device("cuda", local_rank)
    return dev


def _up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _up() else 0


def process_count() -> int:
    return dist.get_world_size() if _up() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier(name: str = "") -> None:
    """Every rank waits here (a no-op in one process); ``name`` says where,
    for a reader of a hang."""
    del name
    if _up():
        dist.barrier()


def on_main(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on rank 0, its (picklable) result handed to
    every rank (``broadcast_object_list``): work that writes files once,
    such as a dataset build or a split, whose result every rank reads."""
    out = [fn(*args, **kwargs) if is_main_process() else None]
    if _up():
        dist.broadcast_object_list(out, src=0)
    return out[0]


class _AllReduceSum(torch.autograd.Function):
    """Σ over ``group``; the backward sums the gradient over it, so each
    rank's term gets the whole loss's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks, autograd-aware: the backward
    all-reduces the gradient (``torch.distributed.nn.functional.all_reduce``'s
    rule, the counterpart of ``jax.lax.psum`` under ``grad``). ``group``
    None → ``x`` unchanged (one process)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def local_batch_slice(global_batch: int, n_proc: Optional[int] = None,
                      index: Optional[int] = None) -> slice:
    """This process's rows of a global batch (``ldiffusion_tpu/core/dist.py:131-137``;
    the reference's DistributedSampler, ``ldiffusion.py:100-110``). Every
    process holds as many rows: the averaged losses equal the global ones
    only then."""
    n_proc = process_count() if n_proc is None else n_proc
    index = process_index() if index is None else index
    assert global_batch % n_proc == 0, (global_batch, n_proc)
    per = global_batch // n_proc
    return slice(index * per, (index + 1) * per)


@dataclasses.dataclass
class MeshContext:
    """The (data, fsdp, tensor) mesh over ``ranks`` and this process's place
    in it. ``mesh`` is None in one process without a process group: the
    trainers then take their one-device path."""

    config: MeshConfig
    device: torch.device
    mesh: Optional[object] = None   # torch.distributed.device_mesh.DeviceMesh
    ranks: Sequence[int] = (0,)
    group: Optional[object] = None        # every rank of the mesh
    batch_group: Optional[object] = None  # the ranks of this process's tensor coordinate

    @property
    def n_data(self) -> int:
        return self.config.data

    @property
    def n_fsdp(self) -> int:
        return self.config.fsdp

    @property
    def n_tensor(self) -> int:
        return self.config.tensor

    @property
    def distributed(self) -> bool:
        return self.mesh is not None

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return process_index() in self.ranks

    @property
    def rank(self) -> int:
        """This process's index in the mesh."""
        return list(self.ranks).index(process_index()) if self.distributed else 0

    @property
    def world(self) -> int:
        return len(self.ranks)

    @property
    def batch_shards(self) -> int:
        return self.n_data * self.n_fsdp

    @property
    def batch_index(self) -> int:
        """Which of the ``batch_shards`` row blocks this process holds."""
        return self.rank // self.n_tensor

    def barrier(self, name: str = "") -> None:
        """The mesh's ranks wait here (a no-op without a process group)."""
        del name
        if self.distributed:
            dist.barrier(group=self.group)

    def row_slice(self, global_batch: int) -> slice:
        """This process's rows of a global batch: split over data×fsdp,
        replicated over tensor, as ``P((DATA_AXIS, FSDP_AXIS))`` splits it."""
        return local_batch_slice(global_batch, self.batch_shards, self.batch_index)

    def local_rows(self, x):
        """``x``'s rows ``row_slice`` names (counterpart of ``shard_batch``)."""
        return x[self.row_slice(x.shape[0])]

    def shard_module(self, module: torch.nn.Module, units: Iterable[torch.nn.Module] = (),
                     param_dtype=None, reduce_dtype=torch.float32) -> torch.nn.Module:
        """``fully_shard`` each of ``units`` (the submodules that gather
        their parameters one at a time), then ``module``, over (data, fsdp),
        each with ``MixedPrecisionPolicy(param_dtype, reduce_dtype)``: the
        parameters stay sharded in their dtype, the forward gathers them in
        ``param_dtype``, the gradients are reduced in ``reduce_dtype``."""
        from torch.distributed.fsdp import MixedPrecisionPolicy, fully_shard

        sub = self.mesh[FSDP_AXIS] if self.n_data == 1 else self.mesh[DATA_AXIS, FSDP_AXIS]
        policy = MixedPrecisionPolicy(param_dtype=param_dtype, reduce_dtype=reduce_dtype)
        for unit in units:
            fully_shard(unit, mesh=sub, mp_policy=policy)
        fully_shard(module, mesh=sub, mp_policy=policy)
        return module

    def replicate_module(self, module: torch.nn.Module) -> torch.nn.Module:
        """``module`` replicated over the batch group: its parameters and
        buffers broadcast from the group's first rank once, here (DDP's
        start). The buffers are not synchronised again (each rank keeps its
        own, as DDP's ``broadcast_buffers=False``); ``mean_gradients``
        averages the gradients after each backward. Returns ``module``."""
        src = dist.get_process_group_ranks(self.batch_group)[0]
        tensors = [*module.parameters(), *module.buffers()]
        with torch.no_grad():
            for dtype in dict.fromkeys(t.dtype for t in tensors):  # the same order on every rank
                same = [t for t in tensors if t.dtype == dtype]
                flat = torch.cat([t.reshape(-1) for t in same])
                dist.broadcast(flat, src=src, group=self.batch_group)
                for t, part in zip(same, flat.split([t.numel() for t in same])):
                    t.copy_(part.view_as(t))
        return module

    def mean_gradients(self, params: Iterable[torch.nn.Parameter]) -> None:
        """The gradients of ``params`` averaged over data×fsdp, in place:
        flattened into one f32 buffer, all-reduced over the batch group,
        divided by ``batch_shards`` and written back. Device ops and one
        collective, so a captured step holds it."""
        grads = [p.grad for p in params if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=self.batch_group)
        flat.div_(self.batch_shards)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def make_mesh(config: Optional[MeshConfig] = None, device=None,
              ranks: Optional[Sequence[int]] = None) -> MeshContext:
    """The mesh over ``ranks`` (default: every process), ``config`` resolved
    to their count (``MeshConfig.resolved``). Under a process group every
    process calls it (the groups are made collectively); a process outside
    ``ranks`` gets a context with ``member`` False. ``device``: as
    ``process_device``."""
    dev = process_device(device)
    if not _up():
        if ranks is not None and len(ranks) != 1:
            raise ValueError(f"a mesh over {len(ranks)} ranks needs a process group")
        return MeshContext(config=(config or MeshConfig()).resolved(1), device=dev)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = list(range(dist.get_world_size())) if ranks is None else list(ranks)
    cfg = (config or MeshConfig()).resolved(len(ranks))
    shape = (cfg.data, cfg.fsdp, cfg.tensor)
    mesh = DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape), mesh_dim_names=AXES)
    group = dist.new_group(ranks)
    batch_group = None
    for t in range(cfg.tensor):  # the ranks of one tensor coordinate share a batch
        members = ranks[t::cfg.tensor]
        g = dist.new_group(members)
        if process_index() in members:
            batch_group = g
    return MeshContext(config=cfg, device=dev, mesh=mesh, ranks=tuple(ranks), group=group,
                       batch_group=batch_group)
