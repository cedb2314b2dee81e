"""NuSeT input normalizations and the host mask cleanup (twin of
``ecseg_tpu/ops/normalization.py``; reference
src/nuset_utils/normalization.py:7-37)."""

from __future__ import annotations

import numpy as np

from .cc import label as cc_label
from .morphology import remove_small_holes, remove_small_objects


def whole_image_norm(image: np.ndarray) -> np.ndarray:
    """(x - mean) / std (reference normalization.py:7-8)."""
    image = np.asarray(image, np.float64)
    return (image - np.mean(image)) / np.std(image)


def foreground_norm(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(x - median(fg != 0)) / (std(fg != 0) + 1e-5) (reference
    normalization.py:10-23); as there, zero *values* of the masked image are
    dropped, not only masked-out pixels."""
    image = np.asarray(image, np.float64)
    nonzero = (image * mask).reshape(-1)
    nonzero = nonzero[nonzero != 0]
    return (image - np.median(nonzero)) / (np.std(nonzero) + 1e-5)


def clean_image(image: np.ndarray) -> np.ndarray:
    """Remove regions and holes smaller than mean_area / 5 (reference
    normalization.py:25-37).  Returns uint8 {0, 1}."""
    image = np.asarray(image).astype(bool)
    num_cells = int(np.max(cc_label(image, connectivity=1)))
    mean_area = float(np.sum(image)) / num_cells if num_cells else 0.0
    image = remove_small_objects(image, min_size=mean_area / 5, connectivity=2)
    image = remove_small_holes(image, area_threshold=mean_area / 5, connectivity=2)
    return image.astype(np.uint8)
