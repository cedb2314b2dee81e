"""Binary morphology on device tensors (twin of
``ecseg_tpu/ops/morphology_tpu.py:53-170``): dilation and erosion as
ORs/ANDs of shifted copies, 4-connected hole filling on kernel B3, and on
kernel B2 the removal of small components and holes and the NuSeT mask
cleanup (``clean_image``)."""

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


def component_sizes(mask: torch.Tensor, connectivity: int):
    """(per-pixel size of its component, 0 on background; the number of
    components): one B2 labeling at ``connectivity``, one count of the
    labels and a gather back to the pixels.  int64."""
    mask = mask.bool()
    h, w = mask.shape
    n = h * w
    lab = label(mask, connectivity).reshape(-1)
    flat = torch.where(lab < 0, n, lab).long()
    sizes = torch.bincount(flat, minlength=n + 1)
    sizes[n] = 0
    return sizes[flat].view(h, w), torch.count_nonzero(sizes)


def remove_small_objects(mask: torch.Tensor, min_size, connectivity: int = 1) -> torch.Tensor:
    """skimage.morphology.remove_small_objects: the components (B2 labels
    at ``connectivity``) with fewer than ``min_size`` pixels removed."""
    return mask.bool() & (component_sizes(mask, connectivity)[0] >= min_size)


def remove_small_holes(mask: torch.Tensor, area_threshold, connectivity: int = 2) -> torch.Tensor:
    """skimage.morphology.remove_small_holes: background components (B2
    labels of the complement) with fewer than ``area_threshold + 1`` pixels
    filled, those touching the border included."""
    mask = mask.bool()
    return ~remove_small_objects(~mask, area_threshold + 1, connectivity)


def clean_image(mask: torch.Tensor) -> torch.Tensor:
    """The NuSeT mask cleanup (twin of ``morphology_tpu.clean_image_tpu``,
    reference src/nuset_utils/normalization.py:25-37): with mean_area =
    foreground pixels / 4-connected components, remove the 8-connected
    objects smaller than mean_area / 5, then fill the 8-connected holes
    smaller than mean_area / 5 + 1.  Three B2 launches.  The host chain
    divides in float64; here both tests are exact int64 products
    (``size >= total / (5 num)`` is ``size * 5 num >= total``), which
    decide as the host does, ties included, for any mask under 2^31
    pixels.  bool."""
    mask = mask.bool()
    _, num = component_sizes(mask, 1)
    total = mask.sum(dtype=torch.int64)
    d = 5 * num
    size, _ = component_sizes(mask, 2)
    kept = mask & (size * d >= total)
    bg_size, _ = component_sizes(~kept, 2)
    holes = ~kept & ((bg_size - 1) * d < total)
    return kept | holes
