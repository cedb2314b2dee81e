"""Exact squared Euclidean distance transform on device tensors (twin of
``ecseg_tpu/ops/edt_tpu.py:34-110``), plain torch ops.

scipy's convention: each nonzero pixel's squared distance to the nearest
zero pixel of the array, zeros get 0.  Two phases:

1. columns: g(y, x), the distance to the nearest zero in column x, from the
   running index of the last zero above and below (``cummax``);
2. rows: d2(y, x) = min over x' of g(y, x')^2 + (x - x')^2, as a min-plus
   pass over horizontal shifts in increasing |offset|, stopped once
   offset^2 exceeds max(d2), when no further shift can lower a pixel.  The
   stop is tested every ``CHECK_EVERY`` shifts (one device sync each): the
   shifts run past it change nothing, so the result is the JAX package's.

int32 throughout: a column with no zero carries the sentinel 2^30, and the
scheme needs H^2 + W^2 < 2^30, checked (``ValueError``) as the JAX
package does.
"""

from __future__ import annotations

import torch

SENTINEL = 1 << 30
CHECK_EVERY = 8


def _column_distance(mask: torch.Tensor) -> torch.Tensor:
    """g(y, x) as int32: rows to the nearest zero above or below, > 2^19
    where the column holds no zero."""
    rows = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)[:, None]
    far = -(1 << 21)

    def since_last_zero(m):  # rows since the last zero at or above each row
        return rows - torch.cummax(torch.where(m, far, rows), dim=0).values

    return torch.minimum(since_last_zero(mask), since_last_zero(mask.flip(0)).flip(0))


def edt_sq(mask: torch.Tensor) -> torch.Tensor:
    """Exact squared EDT (int32) of a (H, W) bool mask."""
    mask = mask.bool()
    h, w = mask.shape
    if h * h + w * w >= SENTINEL:
        raise ValueError(f"edt_sq's int32 scheme takes H^2 + W^2 < 2^30; got {h}x{w}")
    g = _column_distance(mask).clamp(max=1 << 20)  # no square overflows int32
    g2 = torch.where(g > (1 << 19), SENTINEL, g * g)
    d2 = g2.clone()
    off = 1
    while off < w:
        for _ in range(CHECK_EVERY):
            if off >= w:
                break
            o2 = off * off
            d2[:, : w - off] = torch.minimum(d2[:, : w - off], g2[:, off:] + o2)
            d2[:, off:] = torch.minimum(d2[:, off:], g2[:, : w - off] + o2)
            off += 1
        if off * off > int(d2.max()):
            break
    return torch.where(mask, d2.clamp(max=SENTINEL), 0)
