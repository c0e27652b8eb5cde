"""The RGB-D (remote-sensing) dataset (counterpart of
``ldiffusion_tpu/data/rgbd.py``; reference ``dataset.py:91-157``): rgb / dtm
/ mask TIF triplets under ``<root>/<split>/{rgb,dtm,masks}``, masks resized
to 256² nearest and mapped through ``ID_TO_CLASS`` (``dataset.py:34-46``),
and a Canny edge map of the DTM as three channels.

cv2 is not a dependency: ``canny_edges`` is the JAX package's scipy
detector (Sobel gradients, non-maximum suppression over four directions,
double-threshold hysteresis)."""
from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import numpy as np
from PIL import Image
from scipy import ndimage

from ldiffusion_tpu_torch.data.labels import label_lut

# the neighbours compared by the non-maximum suppression of each quantised
# gradient direction (0°, 45°, 90°, 135°)
_NMS_OFFSETS = {0: ((0, 1), (0, -1)), 1: ((1, 1), (-1, -1)),
                2: ((1, 0), (-1, 0)), 3: ((1, -1), (-1, 1))}


def map_mask(mask_np: np.ndarray) -> np.ndarray:
    """reference ``dataset.py:42-46``."""
    return label_lut("rgbd")[mask_np.astype(np.uint8)].astype(np.int64)


def canny_edges(gray_u8: np.ndarray, low: float = 100, high: float = 200) -> np.ndarray:
    """A cv2.Canny-like edge map (uint8, 0 or 255) of a uint8 image."""
    g = gray_u8.astype(np.float32)
    gx = ndimage.sobel(g, axis=1)
    gy = ndimage.sobel(g, axis=0)
    mag = np.hypot(gx, gy) / 4.0  # cv2's Sobel magnitude is ~4× scipy's
    q = (np.round(np.arctan2(gy, gx) / (np.pi / 4)) % 4).astype(np.int8)
    nms = np.zeros_like(mag)
    pad = np.pad(mag, 1)
    h, w = mag.shape
    for d, ((dy1, dx1), (dy2, dx2)) in _NMS_OFFSETS.items():
        n1 = pad[1 + dy1:1 + dy1 + h, 1 + dx1:1 + dx1 + w]
        n2 = pad[1 + dy2:1 + dy2 + h, 1 + dx2:1 + dx2 + w]
        keep = (q == d) & (mag >= n1) & (mag >= n2)
        nms[keep] = mag[keep]
    strong = nms >= high
    labeled, n = ndimage.label(nms >= low)  # hysteresis: weak components touching a strong pixel
    if n:
        ids = np.unique(labeled[strong])
        out = np.isin(labeled, ids[ids != 0])
    else:
        out = strong
    return (out * 255).astype(np.uint8)


class RgbDtmMaskDataset:
    def __init__(self, root_dir: str, split: str = "train", mask_size: int = 256,
                 image_size: Optional[int] = 256):
        self.rgb_files = sorted(glob.glob(os.path.join(root_dir, split, "rgb", "*.tif")))
        self.dtm_files = sorted(glob.glob(os.path.join(root_dir, split, "dtm", "*.tif")))
        self.mask_files = sorted(glob.glob(os.path.join(root_dir, split, "masks", "*.tif")))
        if not len(self.rgb_files) == len(self.dtm_files) == len(self.mask_files):
            raise ValueError(f"file counts differ: {len(self.rgb_files)}, "
                             f"{len(self.dtm_files)}, {len(self.mask_files)}")
        self.mask_size = mask_size
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.rgb_files)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        size = self.image_size
        rgb = Image.open(self.rgb_files[idx]).convert("RGB")
        dtm = Image.open(self.dtm_files[idx]).convert("L")
        if size:
            rgb = rgb.resize((size, size), Image.BILINEAR)
            dtm = dtm.resize((size, size), Image.BILINEAR)
        mask = Image.open(self.mask_files[idx]).convert("L").resize(
            (self.mask_size, self.mask_size), Image.NEAREST)
        rgb_np = np.asarray(rgb, np.float32) / 255.0             # (H, W, 3)
        dtm_np = np.asarray(dtm, np.float32)[..., None] / 255.0  # (H, W, 1)
        canny = canny_edges((dtm_np[..., 0] * 255).astype(np.uint8))
        canny_np = ((canny.astype(np.float32) / 255.0) - 0.5) / 0.5  # Normalize(0.5, 0.5)
        return {"rgb": rgb_np, "dtm": dtm_np, "mask": map_mask(np.asarray(mask)),
                "canny": np.repeat(canny_np[..., None], 3, axis=-1)}
