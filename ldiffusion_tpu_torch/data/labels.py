"""PUMA label maps: grayscale PNG values → class ids and back (the port's
copy of ``convert_labels`` and ``labels_to_pixels`` in
``ldiffusion_tpu/data/labels.py``). Tissue: 7 classes; cell: 11; "rgbd",
the remote-sensing masks of ``data/rgbd.py``: 4. A 256-entry lookup table;
unmapped values → 0."""
from __future__ import annotations

import numpy as np

# reference dataset.py:10-18
PIXEL_TO_LABEL_TISSUE = {0: 0, 100: 1, 150: 2, 50: 3, 200: 4, 250: 5, 255: 6}
# reference dataset.py:20-32
PIXEL_TO_LABEL_CELL = {0: 0, 25: 1, 50: 2, 75: 3, 100: 4, 125: 5, 150: 6,
                       175: 7, 200: 8, 225: 9, 250: 10}
# reference dataset.py:34-40 (the remote-sensing RGB-D path)
ID_TO_CLASS_RGBD = {0: 0, 60: 1, 120: 2, 180: 3, 255: 0}

NUM_CLASSES = {"tissue": 7, "cell": 11}


def label_lut(level: str) -> np.ndarray:
    mapping = {"tissue": PIXEL_TO_LABEL_TISSUE, "cell": PIXEL_TO_LABEL_CELL,
               "rgbd": ID_TO_CLASS_RGBD}.get(level)
    if mapping is None:
        raise ValueError("Unsupported level. Use 'tissue' or 'cell'.")
    lut = np.zeros(256, np.uint8)
    for k, v in mapping.items():
        lut[k] = v
    return lut


def convert_labels(gray: np.ndarray, level: str) -> np.ndarray:
    """Grayscale uint8 mask → class-id mask."""
    return label_lut(level)[gray.astype(np.uint8)]


def labels_to_pixels(labels: np.ndarray, level: str) -> np.ndarray:
    """Class ids → the reference's grayscale pixel values, for writing
    prediction PNGs ("tissue"; any other level takes the cell map)."""
    mapping = PIXEL_TO_LABEL_TISSUE if level == "tissue" else PIXEL_TO_LABEL_CELL
    lut = np.zeros(256, np.uint8)
    for pixel, label in mapping.items():
        lut[label] = pixel
    return lut[labels.astype(np.uint8)]
