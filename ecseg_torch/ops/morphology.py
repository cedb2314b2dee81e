"""Binary/grey morphology with skimage-compatible semantics on scipy (host
side; twin of ``ecseg_tpu/ops/morphology.py``, the subset the metaseg host
oracle uses)."""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi


def diamond(radius: int) -> np.ndarray:
    """L1 ball footprint (skimage.morphology.diamond)."""
    L = np.arange(0, radius * 2 + 1)
    i, j = np.meshgrid(L, L, indexing="ij")
    return (np.abs(i - radius) + np.abs(j - radius) <= radius).astype(np.uint8)


def binary_dilation(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    return ndi.binary_dilation(np.asarray(image, bool), structure=footprint)


def binary_erosion(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    # skimage's binary_erosion pads with True at borders (border_value=1)
    return ndi.binary_erosion(
        np.asarray(image, bool), structure=footprint, border_value=1
    )


def opening(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Grey opening (skimage.morphology.opening); used on a label image at
    reference src/image_tools.py:31."""
    return ndi.grey_dilation(
        ndi.grey_erosion(image, footprint=footprint), footprint=footprint
    )


def binary_fill_holes(image: np.ndarray) -> np.ndarray:
    return ndi.binary_fill_holes(np.asarray(image, bool))
