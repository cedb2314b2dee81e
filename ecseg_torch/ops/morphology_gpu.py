"""Binary morphology on device tensors (twin of
``ecseg_tpu/ops/morphology_tpu.py:53-96,114-128``): dilation and erosion as
ORs/ANDs of shifted copies, 4-connected hole filling on kernel B3, and the
removal of small components on kernel B2."""

from __future__ import annotations

import numpy as np
import torch

from .cc_kernels import flood_from_border, label


def _shift(x: torch.Tensor, dy: int, dx: int, fill: bool) -> torch.Tensor:
    """``out[r, c] = x[r - dy, c - dx]``, ``fill`` where that is outside."""
    h, w = x.shape
    out = torch.full_like(x, fill)
    out[max(dy, 0) : h + min(dy, 0), max(dx, 0) : w + min(dx, 0)] = x[
        max(-dy, 0) : h + min(-dy, 0), max(-dx, 0) : w + min(-dx, 0)
    ]
    return out


def _offsets(footprint: np.ndarray):
    fp = np.asarray(footprint).astype(bool)
    cy, cx = (np.array(fp.shape) - 1) // 2
    return [(int(y - cy), int(x - cx)) for y, x in np.argwhere(fp)]


def binary_dilation(mask: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """OR over the footprint's offsets (scipy binary_dilation for symmetric
    footprints, zeros outside)."""
    out = torch.zeros_like(mask)
    for dy, dx in _offsets(footprint):
        out |= _shift(mask, dy, dx, False)
    return out


def binary_erosion(mask: torch.Tensor, footprint: np.ndarray) -> torch.Tensor:
    """AND over the footprint's offsets; outside counts as True, as
    skimage's binary_erosion (border_value=1)."""
    out = torch.ones_like(mask)
    for dy, dx in _offsets(footprint):
        out &= _shift(mask, -dy, -dx, True)
    return out


def binary_fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.binary_fill_holes (4-connected background): fill every
    background pixel not 4-connected to the border."""
    bg = ~mask
    return mask | (bg & ~flood_from_border(bg))


def remove_small_objects(mask: torch.Tensor, min_size, connectivity: int = 1) -> torch.Tensor:
    """skimage.morphology.remove_small_objects: the components (B2 labels
    at ``connectivity``) with fewer than ``min_size`` pixels removed; each
    component's size by one count of the labels and a gather back to the
    pixels."""
    mask = mask.bool()
    h, w = mask.shape
    n = h * w
    lab = label(mask, connectivity).reshape(-1)
    flat = torch.where(lab < 0, n, lab).long()
    sizes = torch.bincount(flat, minlength=n + 1)
    return mask & (sizes[flat] >= min_size).view(h, w)
