"""Connected-component labeling and region properties of binary masks (host
side; twin of ``ecseg_tpu/ops/cc.py``, the subset the metaseg host oracle
and stat_fish use).

skimage's ``label`` default connectivity for 2-D images is full (8-connected);
``connectivity=1`` is 4-connected.  Both map onto ``scipy.ndimage.label``,
which numbers components in first-raster-encounter order, as skimage does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
from scipy import ndimage as ndi


def label(mask: np.ndarray, connectivity: Optional[int] = None, return_num: bool = False):
    """skimage.measure.label of a binary mask."""
    mask = np.asarray(mask)
    if connectivity is None:
        connectivity = mask.ndim
    structure = ndi.generate_binary_structure(mask.ndim, connectivity)
    labels, num = ndi.label(mask != 0, structure=structure)
    if return_num:
        return labels, num
    return labels


def scipy_label(image: np.ndarray, connectivity: int = 1):
    """``scipy.ndimage.label`` (4-connected by default), as the reference's
    blob count calls it (reference src/stat_fish.py:135)."""
    return ndi.label(image, structure=ndi.generate_binary_structure(2, connectivity))


@dataclasses.dataclass
class Region:
    """The part of skimage.measure.regionprops the metaseg chain and
    stat_fish read: area, bbox, centroid, an in-place write, and the
    dict-style ``"BoundingBox"`` / ``"Area"`` of the reference's NuSeT code
    (reference src/model_layers/anchor_size.py:25,
    marker_watershed.py:70-73)."""

    label: int
    slice: Tuple[slice, slice]
    area: int
    _labels: np.ndarray = dataclasses.field(repr=False)

    @property
    def _mask(self) -> np.ndarray:
        return self._labels[self.slice] == self.label

    @property
    def bbox(self) -> Tuple[int, int, int, int]:
        sy, sx = self.slice
        return (sy.start, sx.start, sy.stop, sx.stop)

    def __getitem__(self, key: str):
        if key == "BoundingBox":
            return self.bbox
        if key == "Area":
            return self.area
        raise KeyError(key)

    @property
    def centroid(self) -> Tuple[np.float64, np.float64]:
        # exact integer coordinate sums and ONE division each, so the float64
        # equals skimage's mean of coordinates bit for bit; the slice offset
        # is folded into the integer sum (fl(ysum/n) + start double-rounds)
        m = self._mask
        sy, sx = self.slice
        n = int(m.sum(dtype=np.int64))
        row_counts = m.sum(axis=1, dtype=np.int64)
        col_counts = m.sum(axis=0, dtype=np.int64)
        ysum = int((row_counts * np.arange(m.shape[0], dtype=np.int64)).sum())
        xsum = int((col_counts * np.arange(m.shape[1], dtype=np.int64)).sum())
        return (
            np.float64((ysum + n * sy.start) / n),
            np.float64((xsum + n * sx.start) / n),
        )

    def write(self, img: np.ndarray, value) -> None:
        """``img[tuple(self.coords.T)] = value``."""
        img[self.slice][self._mask] = value


def regionprops(labels: np.ndarray) -> List[Region]:
    """Region list ordered by ascending label (skimage ordering)."""
    labels = np.asarray(labels)
    objects = ndi.find_objects(labels)
    counts = np.bincount(labels.ravel())
    return [
        Region(label=i, slice=sl, area=int(counts[i]), _labels=labels)
        for i, sl in enumerate(objects, start=1)
        if sl is not None
    ]


def count_cc(mask: np.ndarray):
    """(number of components, total foreground pixels), the reference's exact
    return shape (reference src/image_tools.py:114-119): the sizes are summed
    over ``np.unique(labels)[1:]``, which drops the smallest PRESENT label,
    and ``np.sum([])`` is the float ``0.0``."""
    labels, num = label(mask, return_num=True)
    counts = np.bincount(labels.ravel())
    present = np.flatnonzero(counts)
    sizes = counts[present[1:]]
    if sizes.size == 0:
        return num, 0.0
    return num, int(sizes.sum())
