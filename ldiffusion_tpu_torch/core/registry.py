"""Plugin lookup by name (counterpart of ``ldiffusion_tpu/core/registry.py:24-50``;
reference ``find_class_by_name.py``): classes register explicitly
(``@register(kind)``), with a walk over named modules as the fallback for
classes defined elsewhere. Unknown names raise ``KeyError``. Also the
reference's ``collate_outputs`` and ``dummy_context``."""
from __future__ import annotations

import contextlib
import importlib
import pkgutil
from typing import Any, Callable, Dict, List, Optional

import numpy as np

_REGISTRIES: Dict[str, Dict[str, Any]] = {}


def register(kind: str, name: Optional[str] = None) -> Callable:
    """Decorator: ``@register("preprocessor")`` adds the class to a named registry."""

    def deco(obj):
        _REGISTRIES.setdefault(kind, {})[name or obj.__name__] = obj
        return obj

    return deco


def find_class(kind: str, name: str, search_modules: Optional[List[str]] = None):
    """The registry first, then each of ``search_modules`` and its submodules."""
    reg = _REGISTRIES.get(kind, {})
    if name in reg:
        return reg[name]
    for mod_name in search_modules or []:
        mod = importlib.import_module(mod_name)
        if hasattr(mod, name):
            return getattr(mod, name)
        for info in pkgutil.iter_modules(getattr(mod, "__path__", None) or []):
            sub = importlib.import_module(f"{mod_name}.{info.name}")
            if hasattr(sub, name):
                return getattr(sub, name)
    raise KeyError(f"no {kind} named {name!r} (registered: {sorted(reg)})")


def collate_outputs(outputs: List[Dict[str, Any]]) -> Dict[str, Any]:
    """A list of dicts → one dict: scalars (and 0-d arrays) become an array
    of them, arrays stack along a new first axis (reference
    ``collate_outputs``)."""
    if not outputs:
        return {}
    collated: Dict[str, Any] = {}
    for key in outputs[0]:
        vals = [o[key] for o in outputs]
        first = vals[0]
        if np.isscalar(first) or (hasattr(first, "ndim") and first.ndim == 0):
            collated[key] = np.array(vals)
        else:
            collated[key] = np.stack([np.asarray(v) for v in vals])
    return collated


@contextlib.contextmanager
def dummy_context():
    """A context that does nothing (the reference's stand-in for autocast
    off the GPU)."""
    yield
