"""Anchors, box decode and clip, and greedy NMS (twin of
``ecseg_tpu/ops/boxes.py:32-194``; reference src/nuset_utils/anchors.py,
generate_anchors.py, bbox_transform_tf.py and the
``tf.image.non_max_suppression`` call at src/model_layers/rpn_proposal.py).

The anchors are host numpy, as in the JAX package.  ``decode``,
``clip_boxes`` and ``change_order`` are float32 torch ops in the JAX
functions' order of operations.  ``nms`` selects what ``nms_jax`` (an
800-step scan over an argmax) selects, in the same order: its boxes arrive
sorted by descending score, so the argmax of the live scores is always the
first live box, and the scan is a greedy walk in index order.  The walk runs
on the host over the IoU-suppression matrix, computed on the boxes' device
with the scan's float32 operations in the scan's order and fetched 1-bit
packed (6000^2 bits, 4.5 MB) with the candidates' flags as one more row,
in one copy through ``packing.fetch`` (so ``packing.FETCHED`` counts it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from .packing import fetch

PRE_NMS_TOP_N = 6000  # reference src/model_layers/rpn_proposal.py:19
POST_NMS_TOP_N = 800  # reference src/model_layers/rpn_proposal.py:25


def generate_anchors_reference(base_size, aspect_ratios, scales) -> np.ndarray:
    """(num_ratios * num_scales, 4) reference anchors, (x1, y1, x2, y2)."""
    scales = np.asarray(scales, np.float64)
    ratios = np.asarray(aspect_ratios, np.float64)
    scales_grid, ratios_grid = np.meshgrid(scales, ratios)
    base_scales = scales_grid.reshape(-1)
    sqrt_r = np.sqrt(ratios_grid.reshape(-1))
    heights = base_scales * sqrt_r * base_size
    widths = base_scales / sqrt_r * base_size
    return np.stack([-(widths - 1) / 2, -(heights - 1) / 2, (widths - 1) / 2, (heights - 1) / 2], axis=-1)


def generate_anchors(anchors_reference: np.ndarray, stride: int, feat_shape: Tuple[int, int]) -> np.ndarray:
    """All anchors over the stride grid: (feat_h * feat_w * A, 4) float32,
    cells row-major, anchors innermost."""
    feat_h, feat_w = int(feat_shape[0]), int(feat_shape[1])
    sx, sy = np.meshgrid(np.arange(feat_w) * stride, np.arange(feat_h) * stride)
    shifts = np.stack([sx.ravel(), sy.ravel()] * 2, axis=1).astype(np.float64)
    all_anchors = anchors_reference[None, :, :] + shifts[:, None, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)


def _width_upright(b: torch.Tensor):
    x1, y1, x2, y2 = b.unbind(1)
    w = x2 - x1 + 1.0
    h = y2 - y1 + 1.0
    return w, h, x1 + 0.5 * w, y1 + 0.5 * h


def decode(roi: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """reference bbox_transform_tf.py:41-66 with variances [1, 1] (the -1
    on x2/y2 included)."""
    w, h, urx, ury = _width_upright(roi.float())
    dx, dy, dw, dh = deltas.float().unbind(1)
    pur_x = dx * w + urx
    pur_y = dy * h + ury
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack([pur_x - 0.5 * pw, pur_y - 0.5 * ph, pur_x + 0.5 * pw - 1.0, pur_y + 0.5 * ph - 1.0], dim=1)


def clip_boxes(boxes: torch.Tensor, im_shape) -> torch.Tensor:
    """Clamp to [0, dim - 1]; ``im_shape`` is (height, width)."""
    h, w = float(im_shape[0]), float(im_shape[1])
    x1, y1, x2, y2 = boxes.unbind(1)
    return torch.stack([x1.clamp(0.0, w - 1.0), y1.clamp(0.0, h - 1.0), x2.clamp(0.0, w - 1.0), y2.clamp(0.0, h - 1.0)], dim=1)


def change_order(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) <-> (y1, x1, y2, x2)."""
    return boxes[:, [1, 0, 3, 2]]


def _pack_rows(m: torch.Tensor) -> torch.Tensor:
    """(n, k) bool -> (n, ceil(k / 8)) uint8, bit j of byte b = column
    8b + j (``np.unpackbits(bitorder="little")`` reverses it)."""
    n, k = m.shape
    pad = -k % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    weights = torch.tensor([1, 2, 4, 8, 16, 32, 64, 128], dtype=torch.uint8, device=m.device)
    return (m.view(n, -1, 8).to(torch.uint8) * weights).sum(dim=2, dtype=torch.uint8)


def suppression_matrix(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(n, n) bool: IoU(i, j) > threshold, boxes (y1, x1, y2, x2) float32,
    each IoU by ``nms_jax``'s float32 operations in its order."""
    b = boxes.float()
    areas = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    yy1 = torch.maximum(b[:, None, 0], b[None, :, 0])
    xx1 = torch.maximum(b[:, None, 1], b[None, :, 1])
    yy2 = torch.minimum(b[:, None, 2], b[None, :, 2])
    xx2 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = (yy2 - yy1).clamp(min=0) * (xx2 - xx1).clamp(min=0)
    del yy1, xx1, yy2, xx2
    union = areas[:, None] + areas[None, :] - inter
    iou = torch.where(union > 0, inter / union.clamp(min=1e-12), 0.0)
    return iou > torch.tensor(iou_threshold, dtype=torch.float32)


def fetch_suppression(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> Tuple[np.ndarray, np.ndarray]:
    """The suppression matrix of ``boxes`` (y1, x1, y2, x2) and the
    candidates ``valid`` marks, on the host in one copy through
    ``packing.fetch``: (the (n, ceil(n / 8)) packed rows, bool (n,)).  The
    valid flags ride as one more packed row."""
    n = boxes.shape[0]
    rows = torch.cat([suppression_matrix(boxes, iou_threshold), valid.reshape(1, n).to(torch.bool)])
    packed = fetch(_pack_rows(rows))
    return packed[:n], np.unpackbits(packed[n], count=n, bitorder="little").astype(bool)


@functools.lru_cache(maxsize=1)
def _native_walk():
    """``nms_greedy_walk`` of csrc/nms_walk.cpp."""
    from .._build import host_library

    fn = host_library("nms_walk.cpp").nms_greedy_walk
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    return fn


def greedy_walk(packed: np.ndarray, valid: np.ndarray, max_output: int) -> np.ndarray:
    """The greedy NMS over boxes in descending score order, on the host:
    take the first live candidate, remove those its packed row suppresses,
    repeat, at most ``max_output`` times.  The taken indices, int64, in
    order.  In C++ (``csrc/nms_walk.cpp``, without the interpreter's lock,
    so that it does not hold up another thread); :func:`greedy_walk_py` is
    its twin."""
    n = valid.shape[0]
    packed = np.ascontiguousarray(packed, np.uint8)
    if packed.shape != (n, -(-n // 8)):
        raise ValueError(f"greedy_walk: packed rows {packed.shape} for {n} candidates")
    flags = np.ascontiguousarray(valid, np.uint8)
    out = np.empty(max(max_output, 0), np.int64)
    k = _native_walk()(packed.ctypes.data, flags.ctypes.data, n, packed.shape[1], out.shape[0], out.ctypes.data)
    return out[:k].copy()


def greedy_walk_py(packed: np.ndarray, valid: np.ndarray, max_output: int) -> np.ndarray:
    """:func:`greedy_walk` in numpy, one taken candidate a step."""
    n = valid.shape[0]
    removed = ~valid
    selected = []
    i = 0
    while len(selected) < max_output:
        live = np.flatnonzero(~removed[i:])
        if live.size == 0:
            break
        i += int(live[0])
        selected.append(i)
        removed |= np.unpackbits(packed[i], count=n, bitorder="little").astype(bool)
        removed[i] = True
    return np.asarray(selected, np.int64)


def nms_sorted(boxes: torch.Tensor, valid: torch.Tensor, max_output: int, iou_threshold: float) -> np.ndarray:
    """Greedy NMS over boxes (y1, x1, y2, x2) already sorted by descending
    score; ``valid`` (bool, a score above -inf) marks the candidates.
    Returns the selected indices, int64, in selection order: what
    ``nms_jax`` returns where its ``valid`` is True."""
    if boxes.shape[0] == 0:
        return np.zeros(0, np.int64)
    return greedy_walk(*fetch_suppression(boxes, valid, iou_threshold), max_output)


def encode(bboxes, gt_boxes, variances=None) -> torch.Tensor:
    """Anchor-relative box encoding (reference bbox_transform_tf.py:18-38),
    the inverse of :func:`decode` up to its -1: (N, 4) float32 dx, dy, dw,
    dh.  No pipeline calls it (the reference trains with it)."""
    bboxes = torch.as_tensor(bboxes, dtype=torch.float32)
    gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32)
    if variances is None:
        variances = [1.0, 1.0]
    bw, bh, bx, by = _width_upright(bboxes)
    gw, gh, gx, gy = _width_upright(gt_boxes)
    dx = (gx - bx) / (bw * variances[0])
    dy = (gy - by) / (bh * variances[0])
    dw = torch.log(gw / bw) / variances[1]
    dh = torch.log(gh / bh) / variances[1]
    return torch.stack([dx, dy, dw, dh], dim=1)


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, max_output: int, iou_threshold: float) -> np.ndarray:
    """``tf.image.non_max_suppression`` on the host, one box at a time;
    boxes (y1, x1, y2, x2).  The selected indices (into the input order),
    int64."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    order = np.argsort(-scores, kind="stable")
    areas = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    selected = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        selected.append(i)
        if len(selected) >= max_output:
            break
        yy1 = np.maximum(boxes[i, 0], boxes[:, 0])
        xx1 = np.maximum(boxes[i, 1], boxes[:, 1])
        yy2 = np.minimum(boxes[i, 2], boxes[:, 2])
        xx2 = np.minimum(boxes[i, 3], boxes[:, 3])
        inter = np.maximum(yy2 - yy1, 0) * np.maximum(xx2 - xx1, 0)
        union = areas[i] + areas - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)
        suppressed |= iou > iou_threshold
    return np.asarray(selected, np.int64)
