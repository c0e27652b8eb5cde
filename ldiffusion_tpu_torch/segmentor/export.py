"""Prediction export (counterpart of ``ldiffusion_tpu/segmentor/export.py``;
reference ``export_prediction.py:15-121``): logits → the regime's
probabilities, the ``--save_probabilities`` / ``--npz`` file, an image's or
a volume's logits back to its original geometry (``logits_to_segmentation``,
``export_volume_prediction``) and the PNG (``save_segmentation_png``). The
2D CLI predicts whole images, so its path does not call the 2D
crop-and-resample export."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from PIL import Image


def _logits_to_seg(logits: np.ndarray, label_manager=None) -> np.ndarray:
    """The label manager's conversion (regions painted in order, plain
    labels through their values), else the argmax; uint8."""
    if label_manager is not None:
        return label_manager.convert_logits_to_segmentation(logits).astype(np.uint8)
    return np.argmax(logits, axis=-1).astype(np.uint8)


def logits_to_segmentation(logits: np.ndarray, properties: Optional[Dict] = None,
                           label_manager=None) -> np.ndarray:
    """(H, W, C) logits on the cropped grid → the (H_orig, W_orig) uint8 mask:
    resampled linearly to the crop's shape when they differ, converted, and
    pasted into the original shape at the crop's bbox (``properties`` from
    preprocessing; without them, the converted logits as they are)."""
    from ldiffusion_tpu_torch.segmentor.resample import resample_logits

    if properties:
        bbox = properties["bbox"]
        crop_shape = (bbox[0][1] - bbox[0][0], bbox[1][1] - bbox[1][0])
        if tuple(logits.shape[:2]) != tuple(crop_shape):
            logits = resample_logits(logits, crop_shape)
    seg = _logits_to_seg(logits, label_manager)
    if not properties:
        return seg
    out = np.zeros(tuple(properties["original_shape"]), np.uint8)
    out[bbox[0][0]:bbox[0][1], bbox[1][0]:bbox[1][1]] = seg
    return out


def save_segmentation_png(seg: np.ndarray, path: str):
    Image.fromarray(seg.astype(np.uint8)).save(path)


def inference_nonlin(logits: np.ndarray, label_manager=None) -> np.ndarray:
    """(H, W, C) logits → probabilities: the label manager's nonlinearity in
    float64 (sigmoid for regions), else softmax in the logits' dtype, as the
    JAX package computes them."""
    if label_manager is not None:
        return label_manager.apply_inference_nonlin(logits)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def save_probabilities_npz(logits: np.ndarray, path: str, label_manager=None):
    """``probabilities``: (H, W, C) float16 under the regime's nonlinearity,
    compressed, the JAX package's layout."""
    np.savez_compressed(path, probabilities=inference_nonlin(logits, label_manager)
                        .astype(np.float16))


def export_volume_prediction(logits: np.ndarray, properties: Dict, path: str,
                             reader_writer=None, label_manager=None) -> np.ndarray:
    """(Z, H, W, C) logits on the plan's grid → the (Z, H, W) uint8 mask at
    the input's geometry: the logits resampled linearly (separate-z aware)
    to the cropped shape at the plan's spacing and pasted into the original
    shape at the crop's bbox (``preprocess_case_3d``'s ``properties``),
    converted by the label manager (regions painted in
    order, plain labels through their values), else by argmax; written
    through ``reader_writer`` when one is given."""
    from ldiffusion_tpu_torch.segmentor.resample import resample_data_3d

    spacing = properties.get("target_spacing", properties.get("spacing", (1, 1, 1)))
    bbox = properties["bbox"]
    cropped = tuple(b[1] - b[0] for b in bbox)
    if tuple(logits.shape[:3]) != cropped:
        logits = resample_data_3d(logits, cropped, spacing, order=1)
    seg = label_manager.convert_logits_to_segmentation(logits) if label_manager is not None \
        else np.argmax(logits, axis=-1)
    full = np.zeros(tuple(properties["original_shape"]), np.uint8)
    full[tuple(slice(b[0], b[1]) for b in bbox)] = seg
    if reader_writer is not None:
        reader_writer.write_seg(full, path, properties)
    return full
