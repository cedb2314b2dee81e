"""Min-cut splitting of touching nuclei on the host (twin of
``ecseg_tpu/ops/maxflow.py:46-287``; reference
src/max_flow_binary_mask.py:35-233).

A binary nuclei mask is labeled 4-connected; regions larger than
``cell_size_threshold_coeff`` x the median area are split recursively by a
max-flow/min-cut between detected center pairs on a unit-capacity
4-neighbour pixel graph with L1-ball super source and sink attachments.
The reference's quirks are kept: Edmonds-Karp with a FIFO BFS in the
adjacency lists' insertion order (which fixes the partition among several
min cuts); a pixel within both centers' balls gets only the source edge;
the whole interior distance map thresholded for centers; off-mask centroids
moved to a random pixel of their component; groups under 100 pixels merged
back; the visualization's blake2b colours.

The reference seeds NumPy's global generator (``np.random.seed(seed)``) and
draws with ``np.random.randint``; here a ``np.random.RandomState(seed)`` is
passed down, which draws the same numbers.  The partition runs in C++
(``csrc/cc_maxflow.cpp``, built at first use; a failed build raises), with
its Python twin :func:`partition_py` kept for the tests.  The L1 distance
is scipy's ``distance_transform_cdt(metric="taxicab")`` with
``cv2.distanceTransform(DIST_L1, 3)``'s value on a crop with no zero.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from collections import deque
from typing import List, Tuple

import numpy as np
from scipy import ndimage as ndi

from .cc import label as cc_label, regionprops


@functools.lru_cache(maxsize=1)
def _native():
    """``maxflow_partition`` of csrc/cc_maxflow.cpp."""
    from .._build import host_library

    fn = host_library("cc_maxflow.cpp").maxflow_partition
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.POINTER(ctypes.c_int32)] + [ctypes.c_int64] * 7 + [ctypes.POINTER(ctypes.c_int32)]
    return fn


def l1_distance(mask: np.ndarray) -> np.ndarray:
    """``cv2.distanceTransform(mask.astype(uint8), cv2.DIST_L1, 3)``: each
    nonzero pixel's L1 distance to the nearest zero pixel of the array
    (pixels outside it are not zeros), float32; a mask with no zero gets
    FLT_MAX everywhere, as OpenCV gives."""
    m = np.asarray(mask) != 0
    if m.all():
        return np.full(m.shape, np.finfo(np.float32).max, np.float32)
    return ndi.distance_transform_cdt(m, metric="taxicab").astype(np.float32)


def get_centers(
    segmented_cells: np.ndarray, rng: np.random.RandomState, min_rad: float = 10, percentile: float = 0
) -> List[Tuple[int, int]]:
    """Center pixels of a region's crop (reference :142-200): local maxima
    of the L1 distance in four directions, radius above ``min_rad``; the
    whole interior thresholded at that radius is labeled 8-connected and
    each component's rounded centroid is a center (an off-mask centroid
    moves to a random pixel of its component, drawn from ``rng``)."""
    dt = l1_distance(segmented_cells).astype(np.float64)

    grad = [np.asarray(segmented_cells)[1:-1, 1:-1]]
    # vertical local max: conv0[i,j] = dt[i,j] - dt[i+1,j]
    c0 = dt[:-1, :] - dt[1:, :]
    grad.append((c0[1:, 1:-1] >= 0) * (c0[:-1, 1:-1] <= 0))
    # horizontal
    c1 = dt[:, :-1] - dt[:, 1:]
    grad.append((c1[1:-1, 1:] >= 0) * (c1[1:-1, :-1] <= 0))
    # main diagonal: dt[i,j] - dt[i+1,j+1]
    cd = dt[:-1, :-1] - dt[1:, 1:]
    grad.append((cd[1:, 1:] >= 0) * (cd[:-1, :-1] <= 0))
    # anti-diagonal: dt[i,j+1] - dt[i+1,j]
    ca = dt[:-1, 1:] - dt[1:, :-1]
    grad.append((ca[1:, :-1] >= 0) * (ca[:-1, 1:] <= 0))
    grad.append(dt[1:-1, 1:-1] > min_rad)

    cand = np.prod(np.array(grad), axis=0)
    if not (cand > 0).any():
        return []
    pctl = np.percentile(dt[1:-1, 1:-1][cand > 0], percentile)
    min_rad = max(pctl, min_rad)
    centers = 255 * (dt[1:-1, 1:-1] >= min_rad)
    return _binary_img_to_centers(segmented_cells, np.pad(centers, 1), rng)


def _binary_img_to_centers(mask, center_conv, rng) -> List[Tuple[int, int]]:
    center_ls = []
    labeled = cc_label(center_conv != 0, connectivity=2)
    for region in regionprops(labeled):
        centroid = np.round(region.centroid).astype(int)
        if not mask[centroid[0], centroid[1]]:
            ys, xs = np.nonzero(labeled == region.label)
            alts = list(zip(ys.tolist(), xs.tolist()))
            centroid = alts[rng.randint(len(alts))]
            assert mask[centroid[0], centroid[1]]
        center_ls.append(centroid)
    return [tuple(np.round(c).astype(int)) for c in center_ls]


# ---------------------------------------------------------------------------
# Max-flow on the pixel graph
# ---------------------------------------------------------------------------


class _Graph:
    """Residual graph over flat node ids with paired forward/reverse edges,
    adjacency kept in insertion order (parity-critical)."""

    def __init__(self):
        self.adj = {}  # node -> list of edge ids
        self.to: List[int] = []
        self.cap: List[int] = []
        self.flow: List[int] = []

    def add_pair(self, u: int, v: int, capacity: int = 1):
        eid = len(self.to)
        self.to.extend([v, u])
        self.cap.extend([capacity, 0])
        self.flow.extend([0, 0])
        self.adj.setdefault(u, []).append(eid)
        self.adj.setdefault(v, []).append(eid + 1)

    def bfs(self, start: int, target: int, return_reachable: bool = False):
        prev = {start: None}
        queue = deque([start])
        to, cap, flow, adj = self.to, self.cap, self.flow, self.adj
        while queue:
            curr = queue.pop()
            for eid in adj.get(curr, ()):
                end = to[eid]
                if end not in prev and flow[eid] < cap[eid]:
                    prev[end] = eid
                    queue.appendleft(end)
        if return_reachable:
            return set(prev.keys())
        if target not in prev:
            return []
        path = [prev[target]]
        while path and to[path[-1] ^ 1] != start:
            path.append(prev[to[path[-1] ^ 1]])
        return list(reversed(path))

    def max_flow(self, start: int, target: int) -> int:
        current = 0
        path = self.bfs(start, target)
        while path:
            df = min(self.cap[e] - self.flow[e] for e in path)
            for e in path:
                self.flow[e] += df
                self.flow[e ^ 1] -= df
            current += df
            path = self.bfs(start, target)
        return current


def _build_graph(img, start, target, dist) -> _Graph:
    """Raster-order graph build matching reference get_graph (:59-72).
    Node ids: pixel (i, j) -> i * W + j."""
    H, W = img.shape
    g = _Graph()
    nid = lambda i, j: i * W + j
    s_id, t_id = nid(*start), nid(*target)
    sy, sx = start
    ty, tx = target
    for i in range(H):
        row = img[i]
        for j in range(W):
            if row[j] and (i, j) != start and (i, j) != target:
                if abs(sy - i) + abs(sx - j) <= dist:
                    g.add_pair(s_id, nid(i, j), 1)
                elif abs(ty - i) + abs(tx - j) <= dist:
                    g.add_pair(nid(i, j), t_id, 1)
                for di, dj in ((1, 0), (0, 1), (-1, 0), (0, -1)):
                    ni, nj = i + di, j + dj
                    if 0 <= ni < H and 0 <= nj < W and img[ni, nj]:
                        g.add_pair(nid(i, j), nid(ni, nj), 1)
    return g


def _partition_min_cut(img, g: _Graph, start, target):
    W = img.shape[1]
    g.max_flow(img.shape[1] * start[0] + start[1], W * target[0] + target[1])
    group_1 = np.zeros_like(img)
    reach = g.bfs(W * start[0] + start[1], W * target[0] + target[1], True)
    for node in reach:
        group_1[node // W, node % W] = 1
    group_2 = img - group_1
    return group_1, group_2


def _partition(mask, center_1, center_2, dist):
    """The C++ partition (``csrc/cc_maxflow.cpp``): (group 1, group 2)."""
    img = np.ascontiguousarray(mask, dtype=np.int32)
    h, w = img.shape
    group_1 = np.empty((h, w), np.int32)
    _native()(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), h, w,
        int(center_1[0]), int(center_1[1]), int(center_2[0]), int(center_2[1]), int(dist),
        group_1.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    group_1 = group_1.astype(mask.dtype)
    return group_1, mask - group_1


def partition_py(mask, center_1, center_2, dist):
    """The Python twin of :func:`_partition` (the tests')."""
    g = _build_graph(mask, tuple(center_1), tuple(center_2), dist)
    return _partition_min_cut(mask, g, tuple(center_1), tuple(center_2))


def segment_min_cut(mask, centers, dist, min_size: int = 100):
    """Recursive binary split (reference :119-140)."""
    if not centers:
        return []
    if len(centers) == 1:
        return [mask]
    center_1, center_2 = centers[:2]
    group_1, group_2 = _partition(mask, center_1, center_2, dist)
    if group_1.sum() < min_size:
        group_1 = np.zeros_like(mask)
        group_2 = mask
        centers.remove(center_1)
    elif group_2.sum() < min_size:
        group_2 = np.zeros_like(mask)
        group_1 = mask
        centers.remove(center_2)

    color_1_group = [x for x in centers if group_1[x[0], x[1]]]
    color_2_group = [x for x in centers if group_2[x[0], x[1]]]
    return segment_min_cut(group_1, color_1_group, dist) + segment_min_cut(
        group_2, color_2_group, dist
    )


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------


def binary_seg_to_instance_min_cut(
    segmented_cells: np.ndarray,
    flow_limit: int,
    cell_size_threshold_coeff: float,
    seed: int = 1,
):
    """(instance label map, RGB visualization); reference :202-233."""
    rng = np.random.RandomState(seed)
    labeled, num_cells = cc_label(
        segmented_cells != 0, connectivity=1, return_num=True
    )
    # one full-image regionprops pass serves both the median-area gate and
    # the split loop (each pass is a full-image bincount + find_objects on
    # this 1-core host)
    regions = regionprops(labeled)
    areas = [r.area for r in regions]
    expected = np.median(areas) if areas else np.nan
    distance = (-1 + int(np.sqrt(1 + (2 * flow_limit)))) // 2
    assert distance > 0

    updated = labeled.copy()
    for region in regions:
        mask = (labeled[region.slice] == region.label).astype(int)
        if region.area > cell_size_threshold_coeff * expected:
            center_ls = get_centers(mask, rng)
            if len(center_ls) > 1:
                cells = segment_min_cut(mask, center_ls, dist=distance)
                updated[region.slice] -= mask * region.label
                for i, cell in enumerate(cells, start=1):
                    if i == 1:
                        updated[region.slice] += cell * region.label
                    else:
                        num_cells += 1
                        updated[region.slice] += cell * num_cells

    visualization = _visualize(updated, segmented_cells, seed)
    assert num_cells == updated.max()
    return updated, visualization


def _visualize(updated, segmented_cells, seed):
    def vis_hash(x, salt):
        if not x:
            return 0
        return int(
            hashlib.blake2b(
                str(x).encode(), digest_size=1, salt=f"{seed}_{salt}".encode()
            ).hexdigest(),
            16,
        )

    uniq = np.unique(updated)
    lut_r = np.zeros(int(uniq.max()) + 1, np.int64)
    lut_g = np.zeros(int(uniq.max()) + 1, np.int64)
    for v in uniq:
        lut_r[v] = vis_hash(int(v), "r")
        lut_g[v] = vis_hash(int(v), "g")
    # blue is itself a pure function of the label, so the whole image is
    # three uint8 LUT lookups (vs the former int64 per-pixel arithmetic)
    lut_b = np.clip(384 - lut_r - lut_g, 0, 255)
    r = lut_r.astype(np.uint8)[updated]
    g = lut_g.astype(np.uint8)[updated]
    b = lut_b.astype(np.uint8)[updated] * np.asarray(segmented_cells, bool)
    return np.dstack([r, g, b])
