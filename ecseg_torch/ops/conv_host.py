"""Small host-side correlations with TF 'SAME' alignment (a copy of
``ecseg_tpu/ops/conv_host.py``).

The reference evaluates a handful of tiny convolutions through throwaway TF1
sessions (reference src/stat_fish.py:77,100-101,
src/max_flow_binary_mask.py:167,180,188).  TF's conv2d is a *correlation*
with 'SAME' zero padding split as (lo = (k-1)//2, hi = k-1-lo) per axis; for
even kernels that differs from scipy's centering, so we implement the
padding explicitly.
"""

from __future__ import annotations

import numpy as np


def conv2d_same_tf(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """2-D correlation of ``x`` (H, W) with ``kernel`` (kh, kw), TF-'SAME'
    zero padding, stride 1."""
    x = np.asarray(x)
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    plo_h, phi_h = (kh - 1) // 2, kh - 1 - (kh - 1) // 2
    plo_w, phi_w = (kw - 1) // 2, kw - 1 - (kw - 1) // 2
    xp = np.pad(x, ((plo_h, phi_h), (plo_w, phi_w)))
    out = np.zeros(x.shape, dtype=np.result_type(x, kernel))
    H, W = x.shape
    for a in range(kh):
        for b in range(kw):
            if kernel[a, b] != 0:
                out += kernel[a, b] * xp[a : a + H, b : b + W]
    return out


def conv2d_valid_tf(x: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """2-D correlation, 'VALID' padding, stride 1 (the min-cut center
    detector's, reference max_flow_binary_mask.py:167-188)."""
    x = np.asarray(x)
    kernel = np.asarray(kernel)
    kh, kw = kernel.shape
    H, W = x.shape[0] - kh + 1, x.shape[1] - kw + 1
    out = np.zeros((H, W), dtype=np.result_type(x, kernel))
    for a in range(kh):
        for b in range(kw):
            if kernel[a, b] != 0:
                out += kernel[a, b] * x[a : a + H, b : b + W]
    return out
