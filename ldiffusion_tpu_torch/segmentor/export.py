"""Prediction export, 2D (counterpart of ``ldiffusion_tpu/segmentor/export.py:50-64``;
reference ``export_prediction.py:109-121``): logits → the regime's
probabilities, and the ``--save_probabilities`` / ``--npz`` file. The CLI
predicts whole images, so the crop-and-resample export of the JAX module has
no caller here (the resampler: ROADMAP queue 1, *The 3D / cascade
pathway*)."""
from __future__ import annotations

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
