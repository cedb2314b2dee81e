"""Overlap tiling, the stitch plan, and the exact uint8 quantize + argmax
(twin of ``ecseg_tpu/ops/tiling.py``).

The patch positions and the copy plan reproduce the reference's
axondeepseg-derived logic (reference src/image_tools.py:148-252) including
its asymmetric rim copies and the ``:242`` axis mix-up, because the stitched
borders feed the argmax that defines the public ``labels/*.npy``.  The plan's
rectangles overlap and the last copy wins; the device stitch (kernel B1,
``ops/cc_kernels.stitch_labels``) therefore replays the plan once per
geometry into a per-pixel source map.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

OVERLAP = 25
SCW = 256  # context window (model input) size


def patch_positions(
    height: int, width: int, overlap_value: int = OVERLAP, scw: int = SCW
) -> List[Tuple[int, int]]:
    """Prediction-window positions for an image of the given size
    (reference src/image_tools.py:156-178)."""
    ch = height - 2 * overlap_value  # cropped height
    cw = width - 2 * overlap_value
    spw = scw - 2 * overlap_value

    qh, rh = divmod(ch, spw)
    qw, rw = divmod(cw, spw)

    L_h = [spw * e for e in range(qh)]
    L_w = [spw * e for e in range(qw)]
    if rh != 0:
        L_h.append(ch - spw)
    if rw != 0:
        L_w.append(cw - spw)

    xx, yy = np.meshgrid(L_h, L_w)
    P = [np.ravel(xx), np.ravel(yy)]
    return [(int(P[0][i]), int(P[1][i])) for i in range(len(P[0]))]


def im2patches_overlap(img: np.ndarray, overlap_value: int = OVERLAP, scw: int = SCW):
    """Slice ``img`` (H, W[, C]) into scw x scw patches at the overlap
    positions (reference src/image_tools.py:148-186).  Returns
    ``(img, patches (N, scw, scw[, C]), positions)``."""
    pos = patch_positions(img.shape[0], img.shape[1], overlap_value, scw)
    patches = np.stack([img[y : y + scw, x : x + scw] for (y, x) in pos])
    return img, patches, pos


def _stitch_plan(positions, overlap_value, scw, h_l, w_l):
    """The exact (patch, src, dst, size) copy list of the reference's
    stitcher (reference src/image_tools.py:188-252), in its order."""
    ov = overlap_value
    spw = scw - 2 * ov
    copies = []  # (patch_idx, src_y0, src_x0, dst_y0, dst_x0, sh, sw)
    H = h_l + scw
    W = w_l + scw

    def add(i, src_y, src_x, dst_y, dst_x, sh, sw):
        if sh > 0 and sw > 0:
            copies.append((i, src_y, src_x, dst_y, dst_x, sh, sw))

    for i, (py, px) in enumerate(positions):
        if py == 0:
            if px == 0:
                add(i, 0, 0, 0, 0, ov, ov)
                add(i, ov, 0, ov, 0, scw - 2 * ov, ov)
                add(i, 0, ov, 0, ov, ov, scw - 2 * ov)
            else:
                if px == w_l:
                    add(i, 0, scw - ov, 0, W - ov, ov, ov)
                add(i, 0, ov, 0, px + ov, ov, scw - 2 * ov)
        if px == 0 and py != 0:
            add(i, ov, 0, py + ov, 0, scw - 2 * ov, ov)
        if py == h_l:
            if px == w_l:
                add(i, scw - ov, scw - ov, H - ov, W - ov, ov, ov)
                add(i, ov, scw - ov, h_l + ov, W - ov, H - ov - (h_l + ov), ov)
                add(i, scw - ov, ov, H - ov, w_l + ov, ov, W - ov - (w_l + ov))
            else:
                if px == 0:
                    add(i, scw - ov, 0, H - ov, 0, ov, ov)
                add(i, scw - ov, ov, H - ov, px + ov, ov, scw - 2 * ov)
        if px == w_l and px != h_l:  # replicated reference quirk (:242)
            add(i, ov, scw - ov, py + ov, W - ov, scw - 2 * ov, ov)

    for i, (py, px) in enumerate(positions):
        add(i, ov, ov, py + ov, px + ov, spw, spw)
    return copies, H, W


@functools.lru_cache(maxsize=64)
def stitch_plan(positions: Tuple[Tuple[int, int], ...]):
    """``(copies, H, W)`` for a geometry (positions as a tuple of pairs)."""
    pos = np.asarray(positions)
    return _stitch_plan(
        list(positions), OVERLAP, SCW, int(pos[:, 0].max()), int(pos[:, 1].max())
    )


def quantize_u8(probs: torch.Tensor) -> torch.Tensor:
    """skimage ``img_as_ubyte`` of float probabilities (reference
    src/utils.py:117): ``rint(255 * p)`` clipped to [0, 255].  The float64
    product of an f32 probability and 255 is exact, and ``torch.round``
    rounds half to even, as ``np.rint``."""
    return torch.round(probs.double() * 255).clamp_(0, 255).to(torch.uint8)


def patch_labels(probs: torch.Tensor) -> torch.Tensor:
    """(N, scw, scw, C) probabilities -> (N, scw, scw) uint8 class labels:
    the argmax (first maximum on ties) of the quantized bytes.  Per-patch
    argmax then stitch equals the reference's stitch then argmax because the
    stitch only copies pixels."""
    return torch.argmax(quantize_u8(probs), dim=-1).to(torch.uint8)
