"""Plugin lookup by name (counterpart of ``ldiffusion_tpu/core/registry.py:24-50``;
reference ``find_class_by_name.py``): classes register explicitly
(``@register(kind)``), with a walk over named modules as the fallback for
classes defined elsewhere. Unknown names raise ``KeyError``."""
from __future__ import annotations

import importlib
import pkgutil
from typing import Any, Callable, Dict, List, Optional

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
