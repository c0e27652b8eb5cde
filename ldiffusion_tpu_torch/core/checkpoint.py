"""The JAX trainers' checkpoint pickles: read without JAX, and written in
the same layout (``save_pytree``).

``ldiffusion_tpu/core/checkpoint.py:save_pytree`` pickles a dict of numpy
leaves, but the segmentor's checkpoint also holds its optax ``opt_state``
(``segmentor/trainer.py:707-715``), whose namedtuples name classes of optax,
jax or flax. A plain ``pickle.load`` would import them. Here every class from
those packages (and from ``ldiffusion_tpu``) unpickles as an inert stand-in,
so the loaded tree holds only numpy arrays, Python values and stand-ins;
callers read ``params`` and ``plan``, and the segmentor trainer walks the
stand-ins of the optax ``opt_state`` (their ``args``, the namedtuples'
fields in order) to resume from it.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Tuple

import torch

from ldiffusion_tpu_torch.core.dist import is_main_process

_FOREIGN = ("jax", "jaxlib", "flax", "optax", "chex", "ldiffusion_tpu")
_standins: Dict[Tuple[str, str], type] = {}


class Inert:
    """A stand-in for an object of a JAX-side class: keeps its constructor
    arguments and state, does nothing."""

    def __new__(cls, *args, **kwargs):
        obj = object.__new__(cls)
        obj.args = args
        obj.state = None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state

    def __repr__(self):
        return f"Inert[{self.origin}]"


def _standin(module: str, name: str) -> type:
    key = (module, name)
    if key not in _standins:
        _standins[key] = type(name, (Inert,), {"origin": f"{module}.{name}"})
    return _standins[key]


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".", 1)[0]
        if root in _FOREIGN:
            if module.startswith("flax.core.frozen_dict") and name == "FrozenDict":
                return dict
            return _standin(module, name)
        return super().find_class(module, name)


def load_pytree(path: str) -> Any:
    """Load a pickle written by the JAX package's ``save_pytree``. Unpickle
    only files this project wrote: unpickling can run code."""
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def _to_host(x):
    if isinstance(x, torch.Tensor):
        if hasattr(x, "full_tensor"):  # a DTensor shard (FSDP2): every rank gathers
            x = x.full_tensor()
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def save_pytree(path: str, tree: Any) -> None:
    """Pickle a tree of dicts, lists, numpy arrays and Python scalars (tensors
    become numpy arrays), as ``ldiffusion_tpu/core/checkpoint.py:19-41``
    writes it: the JAX package's ``load_pytree`` reads it with a plain
    ``pickle.load``. Under a process group every rank calls it: sharded
    tensors (DTensors) are gathered on every rank (``full_tensor``), then
    rank 0 alone writes. Written to a temporary file and renamed, so a crash
    leaves no torn checkpoint."""
    host = _to_host(tree)
    if not is_main_process():
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(host, f, protocol=4)
    os.replace(tmp, path)


def reshard_like(like: torch.Tensor, value) -> torch.Tensor:
    """``value`` (a full array read by ``load_pytree``) laid out as ``like``:
    on its device and dtype, and, for a DTensor, with its mesh and
    placements (this rank keeps its shard)."""
    full = torch.as_tensor(value).to(device=like.device, dtype=like.dtype)
    if hasattr(like, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(full, like.device_mesh, like.placements)
    return full
