"""Marker-controlled watershed on the host (twin of
``ecseg_tpu/ops/watershed.py:29-206``).

:func:`watershed` is the Vincent-Soille priority flood with
skimage.segmentation.watershed's order (reference
src/model_layers/marker_watershed.py:84): a min-heap keyed by (image value,
insertion age), 4-connected by default; with ``watershed_line`` a pixel next
to another label is a line pixel, zeroed in the output.  It runs in C++
(``csrc/cc_maxflow.cpp``, built at first use; a failed build raises, and
nothing falls back), or in its Python twin :func:`watershed_py` when
``ECSEG_NO_NATIVE`` is set (``ecseg_tpu/native/__init__.py:65``).

:func:`nuset_marker_watershed` is the body of the reference's NuSeT
watershed py_func (marker_watershed.py:9-96), quirks included: the no-op
``markers[...] == 0`` statement, the 20-pixel edge band, fallback markers at
the centres of unmarked regions, markers written in ascending score order.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import os
from typing import Optional

import numpy as np
from scipy import ndimage as ndi

from . import morphology as morph
from .cc import label as cc_label, regionprops


@functools.lru_cache(maxsize=1)
def _native():
    """``watershed`` of csrc/cc_maxflow.cpp."""
    from .._build import host_library

    fn = host_library("cc_maxflow.cpp").watershed
    fn.restype = None
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ]
    return fn


def _inputs(image, markers, mask):
    image = np.ascontiguousarray(image, np.float64)
    mask = np.ones(image.shape, bool) if mask is None else np.asarray(mask).astype(bool)
    markers = np.where(mask, np.asarray(markers).astype(np.int64), 0)
    return image, markers, mask


def watershed(
    image: np.ndarray,
    markers: np.ndarray,
    mask: Optional[np.ndarray] = None,
    connectivity: int = 1,
    watershed_line: bool = False,
) -> np.ndarray:
    """Flood ``markers`` over ``image`` (ascending values) within ``mask``;
    int64 labels.  :func:`watershed_py` when ``ECSEG_NO_NATIVE`` is set to
    any non-empty value."""
    if os.environ.get("ECSEG_NO_NATIVE"):
        return watershed_py(image, markers, mask, connectivity, watershed_line)
    image, markers, mask = _inputs(image, markers, mask)
    h, w = image.shape
    markers = np.ascontiguousarray(markers)
    mask8 = np.ascontiguousarray(mask, np.uint8)
    out = np.empty((h, w), np.int64)
    _native()(
        image.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        markers.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mask8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, connectivity, int(watershed_line),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def watershed_py(
    image: np.ndarray,
    markers: np.ndarray,
    mask: Optional[np.ndarray] = None,
    connectivity: int = 1,
    watershed_line: bool = False,
) -> np.ndarray:
    """The Python priority flood :func:`watershed` runs in C++ (the tests'
    twin; the JAX package's fallback, ``watershed.py:56-101``)."""
    image, markers, mask = _inputs(image, markers, mask)
    H, W = image.shape
    output = markers.copy()
    lines = np.zeros((H, W), bool)
    if connectivity == 1:
        offsets = [(-1, 0), (0, -1), (0, 1), (1, 0)]
    else:
        offsets = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
    heap = []
    age = 0
    ys, xs = np.nonzero(markers)
    for y, x in zip(ys.tolist(), xs.tolist()):
        heapq.heappush(heap, (image[y, x], age, y, x, y, x))
        age += 1
    while heap:
        _, _, y, x, sy, sx = heapq.heappop(heap)
        if watershed_line:
            # a pixel may be queued several times; the first pop wins
            if output[y, x] != 0 and (y, x) != (sy, sx):
                continue
            output[y, x] = output[sy, sx]
        for dy, dx in offsets:
            ny, nx = y + dy, x + dx
            if not (0 <= ny < H and 0 <= nx < W) or not mask[ny, nx]:
                continue
            if watershed_line and output[ny, nx] != 0 and output[ny, nx] != output[y, x]:
                lines[y, x] = True
            if output[ny, nx] != 0:
                continue
            age += 1
            if not watershed_line:
                output[ny, nx] = output[y, x]
            heapq.heappush(heap, (image[ny, nx], age, ny, nx, y, x))
    if watershed_line:
        output[lines] = 0
    return output


def nuset_place_markers(scores: np.ndarray, proposals: np.ndarray, pred_mask: np.ndarray, min_score: float = 0.99):
    """Marker placement of reference marker_watershed.py:9-80: a point
    marker at the centre of each proposal above ``min_score`` outside the
    20-pixel edge band, in ascending score order, then one at the bbox
    centre of each mask region of 10 pixels or more that holds none.
    Returns the (H, W) float32 marker map, or None when no proposal clears
    ``min_score`` (the reference's all-ones contour branch).  Shared by the
    host and device watersheds."""
    pred_mask = np.asarray(pred_mask)
    im_height, im_width = pred_mask.shape
    scores = np.asarray(scores)
    proposals = np.asarray(proposals)
    if not (scores.size > 0 and np.max(scores) > min_score):
        return None
    markers = np.zeros((im_height, im_width), np.float32)
    edge_len = 20
    edge_mask = np.zeros((im_height, im_width))
    edge_mask[edge_len : im_height - edge_len, edge_len : im_width - edge_len] = 1
    edge_mask = 1 - edge_mask

    top = scores > min_score
    proposals_f = proposals[top][scores[top].argsort()]
    p = 1
    for bbox in proposals_f:
        # proposals are (x1, y1, x2, y2); the reference's x_pos is the row
        x_pos = int(round((bbox[3] + bbox[1]) / 2))
        y_pos = int(round((bbox[2] + bbox[0]) / 2))
        if edge_mask[x_pos, y_pos] < 1:
            markers[x_pos, y_pos] = p
            p += 1

    for region in regionprops(cc_label(pred_mask != 0)):
        if region["Area"] < 10:
            continue
        minx, miny, maxx, maxy = region["BoundingBox"]
        minx = int(np.clip(minx, 0, im_height - 1))
        miny = int(np.clip(miny, 0, im_width - 1))
        maxx = int(np.clip(maxx, 0, im_height - 1))
        maxy = int(np.clip(maxy, 0, im_width - 1))
        if np.sum(markers[minx:maxx, miny:maxy]) == 0:
            markers[int(round((minx + maxx) / 2)), int(round((miny + maxy) / 2))] = p
            p += 1
    return markers


def nuset_marker_watershed(scores: np.ndarray, proposals: np.ndarray, pred_mask: np.ndarray, min_score: float = 0.99) -> np.ndarray:
    """Reference marker_watershed.py:9-96: place the markers, dilate them by
    disk(3), flood -EDT of the hole-filled mask within the mask with
    watershed lines, and AND the split contour with the mask.  int32."""
    pred_mask = np.asarray(pred_mask)
    markers = nuset_place_markers(scores, proposals, pred_mask, min_score)
    if markers is None:
        contour = np.ones(pred_mask.shape, np.int64)
    else:
        markers_rw = morph.dilation(markers, morph.disk(3))
        distance = ndi.distance_transform_edt(ndi.binary_fill_holes(pred_mask))
        contour = watershed(-distance, markers_rw, mask=pred_mask != 0, watershed_line=True)
        contour[contour != 0] = 1
    return (pred_mask * contour).astype(np.int32)


def anchor_size_from_mask(mask: np.ndarray) -> float:
    """Median over the mask's 8-connected regions of the larger bbox side:
    the RPN's anchor base size (reference src/model_layers/anchor_size.py:10-38)."""
    scales = []
    for region in regionprops(cc_label(np.asarray(mask) != 0)):
        minx, miny, maxx, maxy = region["BoundingBox"]
        scales.append(np.maximum(maxy - miny, maxx - minx))
    return float(np.median(np.asarray(scales))) if scales else float("nan")
