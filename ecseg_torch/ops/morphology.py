"""Binary/grey morphology with skimage-compatible semantics on scipy (host
side; twin of ``ecseg_tpu/ops/morphology.py``, the subset the metaseg,
meta_overlay and stat_fish host chains use)."""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi


def diamond(radius: int) -> np.ndarray:
    """L1 ball footprint (skimage.morphology.diamond)."""
    L = np.arange(0, radius * 2 + 1)
    i, j = np.meshgrid(L, L, indexing="ij")
    return (np.abs(i - radius) + np.abs(j - radius) <= radius).astype(np.uint8)


def disk(radius: int) -> np.ndarray:
    """L2 ball footprint (skimage.morphology.disk)."""
    L = np.arange(-radius, radius + 1)
    i, j = np.meshgrid(L, L, indexing="ij")
    return ((i**2 + j**2) <= radius**2).astype(np.uint8)


def dilation(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Grey dilation (skimage.morphology.dilation); the NuSeT watershed's
    marker dilation (reference src/model_layers/marker_watershed.py:82)."""
    return ndi.grey_dilation(image, footprint=footprint)


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


def remove_small_objects(mask: np.ndarray, min_size: float, connectivity: int = 1) -> np.ndarray:
    """Remove connected components with strictly fewer than ``min_size``
    pixels (skimage.morphology.remove_small_objects semantics)."""
    mask = np.asarray(mask, bool)
    if min_size <= 1:
        return mask.copy()
    labels, n = ndi.label(mask, structure=ndi.generate_binary_structure(2, connectivity))
    if n == 0:
        return mask.copy()
    sizes = np.bincount(labels.ravel())
    keep = sizes >= min_size
    keep[0] = False
    return keep[labels]


def remove_small_holes(mask: np.ndarray, area_threshold: float, connectivity: int = 2) -> np.ndarray:
    """Fill holes of at most ``area_threshold`` pixels (skimage semantics:
    complement, remove objects smaller than ``area_threshold + 1``,
    complement back; background touching the border counts as a hole
    too)."""
    mask = np.asarray(mask, bool)
    return ~remove_small_objects(~mask, area_threshold + 1, connectivity)


def binary_opening(image: np.ndarray, footprint: np.ndarray) -> np.ndarray:
    """Erosion then dilation by ``footprint`` (skimage's binary_opening)."""
    return binary_dilation(binary_erosion(image, footprint), footprint)
