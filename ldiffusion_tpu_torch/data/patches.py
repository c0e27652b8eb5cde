"""Foreground-oversampled random patch sampling, 2D and 3D (counterpart of
``ldiffusion_tpu/data/patches.py:28-153``; reference ``base_data_loader.py``,
``data_loader_2d.py`` and ``data_loader_3d.py``; the rank is the patch's):
endless batches of random patches; the last
``round(batch * oversample)`` of each batch are centred on a sampled location
of a randomly chosen present foreground class; crops leaving the case are
padded with 0 (data) and -1 (labels). ``probabilistic_oversampling`` (the
nnUNetTrainer_probabilisticOversampling family) draws each sample's
foreground flag from the sampler's generator at ``oversample_fg`` instead, in
the same place of the stream as the JAX package's draw. The numpy generator
is seeded as the JAX package's, so both samplers give the same batches.

The batch is assembled by the native crop (``ldiffusion_tpu_torch.native``);
``use_native=False`` takes the numpy crop, the oracle.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Iterator, Sequence, Tuple

import numpy as np

from ldiffusion_tpu_torch.native import count, crop_with_pad_batch_native, crop_with_pad_numpy

if TYPE_CHECKING:
    from ldiffusion_tpu_torch.segmentor.preprocess import PreprocessedDataset


class PatchSampler:
    def __init__(self, dataset: "PreprocessedDataset", patch_size: Sequence[int],
                 batch_size: int, oversample_fg: float = 0.33, seed: int = 0,
                 use_native: bool = True, probabilistic_oversampling: bool = False):
        self.ds = dataset
        self.keys = dataset.keys()
        self.patch = tuple(patch_size)
        self.batch = batch_size
        self.oversample = oversample_fg
        self.use_native = use_native
        self.probabilistic = probabilistic_oversampling
        self.rng = np.random.default_rng(seed)

    @staticmethod
    def effective_oversample_percent(batch_size: int, oversample_fg: float) -> float:
        """The positional rule's foreground share over a batch (reference
        ``nnUNetTrainer_probabilisticOversampling.__init__``): bs 2, 0.33 → 0.5."""
        return float(np.mean([not i < round(batch_size * (1.0 - oversample_fg))
                              for i in range(batch_size)]))

    def _must_be_fg(self, idx_in_batch: int) -> bool:
        if self.probabilistic:
            return bool(self.rng.random() < self.oversample)
        # reference base_data_loader.py:45-53
        return idx_in_batch >= round(self.batch * (1.0 - self.oversample))

    def sample_coords(self, force_fg: bool):
        """A case and a patch lower bound (reference ``base_data_loader.py:64-139``)."""
        case = self.ds[self.keys[self.rng.integers(len(self.keys))]]
        shape = case.seg.shape
        patch = self.patch
        nd = len(patch)
        if len(shape) != nd:
            raise ValueError(f"case rank {len(shape)} != patch rank {nd}")
        need = [max(0, patch[ax] - shape[ax]) for ax in range(nd)]
        lb_min = [-(need[ax] // 2) for ax in range(nd)]
        lb_max = [shape[ax] + need[ax] // 2 + need[ax] % 2 - patch[ax] for ax in range(nd)]
        locs = case.properties["class_locations"]
        if force_fg and locs:
            cls = list(locs.keys())[self.rng.integers(len(locs))]
            cl = locs[cls]
            center = cl[self.rng.integers(cl.shape[0])]
            lb = tuple(int(np.clip(center[ax] - patch[ax] // 2, lb_min[ax],
                                   max(lb_min[ax], lb_max[ax]))) for ax in range(nd))
        else:
            lb = tuple(int(self.rng.integers(lb_min[ax], max(lb_min[ax], lb_max[ax]) + 1))
                       for ax in range(nd))
        return case, lb

    def sample_one(self, force_fg: bool):
        """One (data (*patch, C), seg (*patch)) crop of a drawn case, through
        the numpy crop, as the JAX package's ``sample_one``."""
        case, lb = self.sample_coords(force_fg)
        return crop_with_pad_numpy(case.data, case.seg, lb, self.patch)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(data (B, *patch, C) float32, seg (B, *patch) int32) batches."""
        while True:
            picks = [self.sample_coords(self._must_be_fg(i)) for i in range(self.batch)]
            if self.use_native:
                lbs = np.asarray([lb for _, lb in picks], np.int64)
                data, seg = crop_with_pad_batch_native(
                    [(np.ascontiguousarray(c.data, np.float32),
                      np.ascontiguousarray(c.seg, np.int16)) for c, _ in picks],
                    lbs, self.patch)
                yield data, seg.astype(np.int32)
                continue
            items = [crop_with_pad_numpy(c.data, c.seg, lb, self.patch) for c, lb in picks]
            count("crop_with_pad_batch" if len(self.patch) == 2 else "crop_with_pad_batch_3d",
                  "numpy")
            yield (np.stack([d for d, _ in items]),
                   np.stack([s for _, s in items]).astype(np.int32))


def downsample_seg_for_ds(seg: np.ndarray, strides) -> list:
    """Deep-supervision targets by striding: seg at 1, 1/2, 1/4 ... (nearest)."""
    outs = [seg]
    cur = seg
    for s in strides[1:]:
        if s > 1:
            cur = cur[:, ::s, ::s]
            outs.append(cur)
    return outs
