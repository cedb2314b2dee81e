"""Vectorized per-nucleus statistics for stat_fish (a copy of
``ecseg_tpu/ops/region_stats.py``).

The reference computes per-nucleus FISH stats with a python loop over
regionprops, a fresh scipy labeling per (nucleus, channel), and a python
loop over blobs inside count_blobs (reference src/stat_fish.py:134-142,
249-275).  These helpers compute identical numbers from ONE global labeled
pass per channel plus bincounts:

  * :func:`per_cell_blob_stats` -- per-cell 4-connected blob counts and
    surviving-pixel counts with the min_cc_size removal rule, plus the exact
    set of removed pixels (the reference *mutates* the thresholded map by
    deleting sub-threshold blobs, and that mutated map is saved as the lsq
    tif -- so the removal mask is part of the contract);
  * :func:`per_cell_intensity` -- mean-of-nonzero / max per cell
    (reference src/image_tools.py:121-124 applied per nucleus);
  * :func:`cell_geometry` -- areas and integer centroid strings.

Exactness note: a fish component can touch two different nuclei; the
reference's per-nucleus labeling splits it at the nucleus boundary, and the
restriction to one nucleus can even disconnect it.  Components spanning a
single cell (the overwhelmingly common case) are handled by the global
pass; multi-cell components are detected and relabeled locally, so the
results are exact for every input.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

from .cc import scipy_label


def per_cell_blob_stats(
    mask: np.ndarray, cells: np.ndarray, min_size: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """4-connected blob statistics of ``mask`` split per cell.

    Args:
      mask: (H, W) boolean fish mask (already intensity/center gated).
      cells: (H, W) integer nucleus labels, 0 = background, labels 1..N.
      min_size: blobs with fewer pixels are removed (reference
        stat_fish.py:134-142).

    Returns ``(blob_count, survive_px, removed)`` where ``blob_count[k]`` /
    ``survive_px[k]`` are the surviving blob count / pixel count for cell k
    (index 0 unused), and ``removed`` is the (H, W) boolean mask of pixels
    belonging to deleted (sub-threshold) blobs.
    """
    ncells = int(cells.max())
    blob_count = np.zeros(ncells + 1, np.int64)
    survive_px = np.zeros(ncells + 1, np.int64)
    removed = np.zeros(mask.shape, bool)
    fg = mask & (cells > 0)
    if not fg.any():
        return blob_count, survive_px, removed

    comp, ncomp = scipy_label(fg)
    flat_comp = comp.ravel()
    flat_cell = cells.ravel()
    sel = np.nonzero(flat_comp)[0]
    comp_ids = flat_comp[sel]
    cell_ids = flat_cell[sel]

    # single-cell ("pure") components: min cell == max cell over the comp
    mincell = np.full(ncomp + 1, np.iinfo(np.int64).max, np.int64)
    maxcell = np.zeros(ncomp + 1, np.int64)
    np.minimum.at(mincell, comp_ids, cell_ids)
    np.maximum.at(maxcell, comp_ids, cell_ids)
    pure = mincell == maxcell
    pure[0] = False

    sizes = np.bincount(comp_ids, minlength=ncomp + 1)
    pure_survives = pure & (sizes >= min_size)
    pure_removed = pure & (sizes < min_size)

    pure_comp_ids = np.nonzero(pure_survives)[0]
    np.add.at(blob_count, maxcell[pure_comp_ids], 1)
    np.add.at(
        survive_px, maxcell[pure_comp_ids], sizes[pure_comp_ids].astype(np.int64)
    )
    removed.ravel()[sel[pure_removed[comp_ids]]] = True

    impure = np.nonzero(~pure[1:])[0] + 1
    if len(impure):
        # rare: a component touching several nuclei -- relabel it per cell
        # inside its bounding box, exactly like the reference's per-nucleus
        # labeling would
        objects = ndimage.find_objects(comp)
        for cid in impure:
            sl = objects[cid - 1]
            sub_comp = comp[sl] == cid
            sub_cells = cells[sl]
            for k in np.unique(sub_cells[sub_comp]):
                local = sub_comp & (sub_cells == k)
                lab, n = scipy_label(local)
                lsizes = np.bincount(lab.ravel(), minlength=n + 1)[1:]
                blob_count[k] += int((lsizes >= min_size).sum())
                survive_px[k] += int(lsizes[lsizes >= min_size].sum())
                small = np.isin(lab, np.nonzero(lsizes < min_size)[0] + 1)
                removed[sl] |= small
    return blob_count, survive_px, removed


def per_cell_intensity(
    raw: np.ndarray, cells: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-cell (mean of nonzero pixels, max) of a raw intensity channel --
    the vectorized twin of intensity_metrics per nucleus
    (reference src/image_tools.py:121-124, stat_fish.py:267-270).

    Returns (avg, max) arrays of length ncells+1; cells with no nonzero
    pixel get avg 0 (the reference maps the NaN mean to 0) and max 0.
    """
    ncells = int(cells.max())
    flat_cell = cells.ravel()
    v = raw.ravel().astype(np.float64)
    sums = np.bincount(flat_cell, weights=v, minlength=ncells + 1)
    nnz = np.bincount(flat_cell, weights=(v > 0), minlength=ncells + 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        avg = np.where(nnz > 0, sums / nnz, 0.0)
    mx = np.zeros(ncells + 1, v.dtype)
    np.maximum.at(mx, flat_cell, v)
    return avg, mx


def cell_geometry(cells: np.ndarray) -> Tuple[np.ndarray, np.ndarray, list]:
    """(labels, areas, centroid strings 'y_x') for every label present in
    ``cells``, ascending -- the same visit order and values regionprops
    yields (reference stat_fish.py:260-266).  Labels need not be
    consecutive (the min-cut splitter can leave gaps).

    Centroid sums run over the LABELED pixels only (flatnonzero compress):
    nuclei cover a few percent of a 2048^2 field, and full-image f64 iota
    bincounts cost ~1 s on this 1-core host (measured) vs ~0.1 s
    compressed -- host CPU is the stat_fish critical path.  f64 bincount
    sums of integer coordinates are exact (< 2^53), so values and the
    centroid truncation are unchanged."""
    ncells = int(cells.max())
    flat = cells.ravel()
    areas_all = np.bincount(flat, minlength=ncells + 1)
    labels = np.nonzero(areas_all[1:])[0] + 1
    sel = np.flatnonzero(flat)
    lab_sel = flat[sel]
    w = cells.shape[1]
    sy = np.bincount(lab_sel, weights=sel // w, minlength=ncells + 1)
    sx = np.bincount(lab_sel, weights=sel % w, minlength=ncells + 1)
    cents = [
        f"{int(sy[k] / areas_all[k])}_{int(sx[k] / areas_all[k])}" for k in labels
    ]
    return labels, areas_all[labels], cents
