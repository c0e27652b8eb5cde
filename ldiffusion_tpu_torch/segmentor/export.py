"""Prediction export (counterpart of ``ldiffusion_tpu/segmentor/export.py:50-90``;
reference ``export_prediction.py:15-121``): logits → the regime's
probabilities, the ``--save_probabilities`` / ``--npz`` file, and a volume's
logits back to its original geometry (``export_volume_prediction``). The 2D
CLI predicts whole images, so the JAX module's 2D crop-and-resample export
has no caller here."""
from __future__ import annotations

from typing import Dict

import numpy as np


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
