"""NuSeT input normalizations and the host mask cleanup (twin of
``ecseg_tpu/ops/normalization.py``; reference
src/nuset_utils/normalization.py:7-37).  Both normalizations also run on a
float64 tensor on its device (``*_device``), as NuSeT's prep on the card
runs them; they differ from numpy only in the order of the float64 sums."""

from __future__ import annotations

import numpy as np
import torch

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


def whole_image_norm_device(image: torch.Tensor) -> torch.Tensor:
    """:func:`whole_image_norm` of a tensor, in float64 on its device."""
    image = image.double()
    return (image - image.mean()) / image.std(correction=0)


def median_device(values: torch.Tensor) -> torch.Tensor:
    """``np.median`` of a 1-D float64 tensor: the middle value, or the mean
    of the two middle values for an even count (``torch.median`` takes the
    lower one); NaN when empty, as numpy gives."""
    n = values.numel()
    if n == 0:
        return torch.tensor(float("nan"), dtype=values.dtype, device=values.device)
    ordered = torch.sort(values).values
    if n % 2:
        return ordered[n // 2]
    return (ordered[n // 2 - 1] + ordered[n // 2]) / 2


def foreground_norm_device(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`foreground_norm` of a tensor under a (H, W) mask (bool or
    {0, 1}), in float64 on its device: the zero values of the masked image
    dropped, numpy's median, the population std."""
    image = image.double()
    masked = (image * mask.double()).reshape(-1)
    nonzero = masked[masked != 0]
    std = nonzero.std(correction=0) if nonzero.numel() else torch.tensor(float("nan"), dtype=torch.float64, device=image.device)
    return (image - median_device(nonzero)) / (std + 1e-5)


def clean_image(image: np.ndarray) -> np.ndarray:
    """Remove regions and holes smaller than mean_area / 5 (reference
    normalization.py:25-37).  Returns uint8 {0, 1}."""
    image = np.asarray(image).astype(bool)
    num_cells = int(np.max(cc_label(image, connectivity=1)))
    mean_area = float(np.sum(image)) / num_cells if num_cells else 0.0
    image = remove_small_objects(image, min_size=mean_area / 5, connectivity=2)
    image = remove_small_holes(image, area_threshold=mean_area / 5, connectivity=2)
    return image.astype(np.uint8)
