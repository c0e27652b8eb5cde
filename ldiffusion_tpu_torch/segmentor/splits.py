"""k-fold cross-validation splits (counterpart of
``ldiffusion_tpu/segmentor/splits.py``; reference ``nnUNetTrainer.do_split``,
``nnUNetTrainer.py:513-579``): a seeded, shuffled 5-fold split over the
sorted case ids, created once and kept as ``splits_final.json`` (an existing
file is used as it is); ``fold="all"`` trains and validates on everything; a
fold beyond the file's falls back to a seeded 80:20 split. The shuffle is
``np.random.RandomState(12345)``, so the file is byte-equal to the JAX
package's (and sklearn's ``KFold``) for the same keys."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

SPLIT_SEED = 12345  # reference KFold(random_state=12345)


def generate_crossval_splits(keys: Sequence[str], n_splits: int = 5,
                             seed: int = SPLIT_SEED) -> List[Dict[str, List[str]]]:
    keys_sorted = np.sort(np.asarray(list(keys)))
    n = len(keys_sorted)
    if n == 1:
        return [{"train": [str(keys_sorted[0])], "val": [str(keys_sorted[0])]}]
    n_splits = min(n_splits, n)
    perm = np.random.RandomState(seed).permutation(n)
    sizes = np.full(n_splits, n // n_splits, np.int64)
    sizes[: n % n_splits] += 1   # sklearn: the first n % k folds get one more
    splits: List[Dict[str, List[str]]] = []
    start = 0
    for s in sizes:
        val_mask = np.zeros(n, bool)
        val_mask[perm[start:start + s]] = True
        start += s
        splits.append({"train": [str(k) for k in keys_sorted[~val_mask]],
                       "val": [str(k) for k in keys_sorted[val_mask]]})
    return splits


def load_or_create_splits(splits_file: str, keys: Sequence[str], n_splits: int = 5,
                          seed: int = SPLIT_SEED) -> List[Dict[str, List[str]]]:
    if os.path.isfile(splits_file):
        with open(splits_file) as f:
            return json.load(f)
    splits = generate_crossval_splits(keys, n_splits, seed)
    os.makedirs(os.path.dirname(splits_file) or ".", exist_ok=True)
    with open(splits_file, "w") as f:
        json.dump(splits, f, indent=2)
    return splits


def do_split(keys: Sequence[str], fold: Union[int, str], splits_file: str,
             n_splits: int = 5, log=print) -> Tuple[List[str], List[str]]:
    """(train keys, val keys) of one fold."""
    keys = [str(k) for k in keys]
    if fold == "all":
        return list(keys), list(keys)
    fold = int(fold)
    splits = load_or_create_splits(splits_file, keys, n_splits)
    if fold < len(splits):
        tr, va = list(splits[fold]["train"]), list(splits[fold]["val"])
    else:
        log(f"INFO: requested fold {fold} but splits contain only "
            f"{len(splits)} folds — creating a random (seeded) 80:20 split")
        rnd = np.random.RandomState(seed=SPLIT_SEED + fold)
        ks = np.sort(np.asarray(keys))
        idx_tr = rnd.choice(len(ks), int(len(ks) * 0.8), replace=False)
        tr = [str(ks[i]) for i in sorted(idx_tr)]
        va = [str(k) for k in ks if str(k) not in set(tr)]
    if set(tr) & set(va):
        log("WARNING: some validation cases are also in the training set")
    return tr, va
