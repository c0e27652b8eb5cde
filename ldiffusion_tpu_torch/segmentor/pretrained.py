"""Shape-matched pretrained-weight transfer (counterpart of
``ldiffusion_tpu/segmentor/pretrained.py``; reference
``load_pretrained_weights.py``): every parameter whose flax path and shape
match is copied from a source tree into the target tree; the rest (e.g. the
segmentation heads of another class count) is kept and reported. Both
packages' checkpoints hold their parameters in the flax layout, so either is a
source."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..models.convert import flatten_tree


def transfer_pretrained_weights(target_params: dict, source_params: dict,
                                verbose: bool = True) -> Tuple[dict, List[str], List[str]]:
    """Returns (new target tree, transferred paths, skipped paths)."""
    src = flatten_tree(source_params)
    transferred, skipped = [], []

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k) for k, v in node.items()}
        if prefix in src and tuple(np.shape(src[prefix])) == tuple(np.shape(node)):
            transferred.append(prefix)
            return np.asarray(src[prefix])
        skipped.append(prefix)
        return node

    new_target = walk(target_params)
    if verbose:
        print(f"transferred {len(transferred)} tensors, skipped {len(skipped)}")
        for p in skipped[:10]:
            print(f"  skipped: {p}")
    return new_target, transferred, skipped
