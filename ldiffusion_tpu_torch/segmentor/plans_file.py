"""Multi-configuration plans file with inheritance (the port's copy of
``ldiffusion_tpu/segmentor/plans_file.py:29-80``; reference
``plans_handler.py:32-307``): one JSON file holds named configurations
("3d_fullres", "3d_lowres", "3d_cascade_fullres", custom ones); a
configuration may name ``inherits_from`` and override some keys
(``:197-220``). A resolved configuration becomes a ``SegPlan`` or a
``SegPlan3D`` by the rank of its patch."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Union

from ldiffusion_tpu_torch.segmentor.planner import SegPlan
from ldiffusion_tpu_torch.segmentor.planner3d import SegPlan3D

AnyPlan = Union[SegPlan, SegPlan3D]


def save_plans_file(path: str, configurations: Dict[str, AnyPlan],
                    dataset_name: str = "", extra: Optional[Dict] = None) -> None:
    """Write the configurations, resolved, under ``"configurations"``."""
    out = {"dataset_name": dataset_name,
           "plans_name": os.path.splitext(os.path.basename(path))[0],
           "configurations": {name: dataclasses.asdict(plan)
                              for name, plan in configurations.items()},
           **(extra or {})}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=2)


def inherits_from(plans: Dict, name: str, _seen=()) -> Dict:
    """Configuration ``name`` of a plans dict with its ``inherits_from``
    chain resolved (the child's keys win); a cycle or an unknown name raises."""
    configurations = plans.get("configurations", {})
    if name in _seen:
        raise ValueError(f"circular inherits_from chain at '{name}'")
    if name not in configurations:
        raise KeyError(f"no configuration '{name}' (have {list(configurations)})")
    cfg = dict(configurations[name])
    parent = cfg.pop("inherits_from", None)
    if parent is None:
        return cfg
    base = inherits_from(plans, parent, _seen + (name,))
    base.update(cfg)
    return base


class PlansFile:
    """A plans file (path or dict) with resolved configurations."""

    def __init__(self, path_or_dict):
        if isinstance(path_or_dict, str):
            with open(path_or_dict) as f:
                self.plans = json.load(f)
        else:
            self.plans = dict(path_or_dict)
        self.configurations = self.plans.get("configurations", {})

    def configuration_names(self):
        return list(self.configurations.keys())

    def get_configuration(self, name: str) -> AnyPlan:
        d = inherits_from(self.plans, name)
        is_3d = len(d["patch_size"]) == 3
        for k in ("patch_size", "features_per_stage", "strides", "median_shape",
                  "n_blocks_per_stage", "spacing", "kernel_sizes"):
            if d.get(k) is not None:
                nested = is_3d and k in ("strides", "kernel_sizes")
                d[k] = tuple(tuple(v) if nested and isinstance(v, list) else v for v in d[k])
        cls = SegPlan3D if is_3d else SegPlan
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})
