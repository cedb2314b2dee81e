"""Device->host transfer packing (twin of ``ecseg_tpu/ops/packing.py``).

The pipelines' results are tiny-alphabet images, so the card packs them
before the copy and the host unpacks them through a 256-entry table:

- 4-class label maps: 2 bits a pixel, 32x smaller than int64;
- binary masks: 1 bit a pixel, 8x smaller than bool.

The layouts are the JAX package's (little-endian within a byte, each row
padded with zero bits to a whole byte), so the packed bytes are equal.
Packing is a few elementwise torch ops on the caller's device.

:func:`fetch` is the device->host copy of such a result (and of metaseg's
raw canvas for a host redo): it counts the bytes, the copies and the copy's
seconds in :data:`FETCHED`, which ``chip_smoke.py`` reads per path.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

_LUT2 = np.stack([np.arange(256) >> (2 * k) & 3 for k in range(4)], axis=1).astype(np.uint8)  # (256, 4)
_LUT1 = np.stack([np.arange(256) >> k & 1 for k in range(8)], axis=1).astype(np.uint8)  # (256, 8)
# the same tables, a row as one word: the host gathers one word a packed
# byte (about 5x faster than gathering rows) and views the words as bytes
_LUT2_WORDS = _LUT2.view(np.uint32).ravel()
_LUT1_WORDS = _LUT1.view(np.uint64).ravel()

FETCHED = {"bytes": 0, "copies": 0, "seconds": 0.0}
_lock = threading.Lock()


def reset_fetched() -> None:
    with _lock:
        FETCHED.update(bytes=0, copies=0, seconds=0.0)


def fetch(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as a numpy array, through one pageable copy,
    counted in :data:`FETCHED`.  The copy's seconds start once the work
    queued before it on its stream is done (the copy waits for that work
    anyway), so they time the copy alone."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    out = t.cpu().numpy()
    seconds = time.perf_counter() - t0
    with _lock:
        FETCHED["bytes"] += out.nbytes
        FETCHED["copies"] += 1
        FETCHED["seconds"] += seconds
    return out


def _pad_cols(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """(H, W) uint8 -> (H, W rounded up to ``multiple``), zero-filled."""
    h, w = x.shape
    wp = -(-w // multiple) * multiple
    if wp == w:
        return x
    out = torch.zeros((h, wp), dtype=x.dtype, device=x.device)
    out[:, :w] = x
    return out


def pack_labels_2bit(labels: torch.Tensor) -> torch.Tensor:
    """(H, W) integer label map with values in {0..3} -> (H, ceil(W/4))
    uint8, 4 pixels a byte, the first in the low bits."""
    x = _pad_cols(labels.to(torch.uint8), 4)
    x = x.reshape(x.shape[0], x.shape[1] // 4, 4)
    return x[..., 0] | (x[..., 1] << 2) | (x[..., 2] << 4) | (x[..., 3] << 6)


def unpack_labels_2bit(packed: np.ndarray, w: int) -> np.ndarray:
    """Host inverse of :func:`pack_labels_2bit`: (H, w) uint8."""
    return _LUT2_WORDS[np.asarray(packed)].view(np.uint8)[:, :w]


def pack_mask_1bit(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) boolean or nonzero mask -> (H, ceil(W/8)) uint8 bitmap, the
    first pixel of each byte in bit 0."""
    x = _pad_cols((mask != 0).to(torch.uint8), 8)
    x = x.reshape(x.shape[0], x.shape[1] // 8, 8)
    packed = x[..., 0]
    for k in range(1, 8):
        packed = packed | (x[..., k] << k)
    return packed


def unpack_mask_1bit(packed: np.ndarray, w: int) -> np.ndarray:
    """Host inverse of :func:`pack_mask_1bit`: (H, w) uint8 {0, 1}."""
    return _LUT1_WORDS[np.asarray(packed)].view(np.uint8)[:, :w]


def unpack_mask_1bit_device(packed: torch.Tensor, w: int) -> torch.Tensor:
    """:func:`unpack_mask_1bit` on ``packed``'s device: (H, ceil(w/8))
    uint8 -> (H, w) uint8 {0, 1}."""
    h = packed.shape[0]
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    return ((packed[:, :, None] >> shifts) & 1).reshape(h, -1)[:, :w]


def pack_mask_1bit_host(mask: np.ndarray) -> np.ndarray:
    """Host twin of :func:`pack_mask_1bit` (the same layout), for binary
    masks on their way to the card."""
    return np.packbits(np.ascontiguousarray(mask != 0), axis=1, bitorder="little")
