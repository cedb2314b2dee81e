"""Otsu threshold of a uint8 image on the device (twin of
``ecseg_tpu/ops/threshold.otsu_threshold_tpu``).

The host path that the pipelines run is ``ops/meta_post.otsu_threshold_u8``
(cv2's Otsu, transcribed); this one computes the same threshold from a
256-bin histogram on the image's device, so a preprocess that stays on the
card need not copy the image to the host.  Plain torch: no kernel.
:func:`otsu_binarize` is the host binarize at that threshold.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .meta_post import otsu_threshold_u8

MAX_PIXELS = 1 << 23  # 255 * pixels must stay below 2^31 for the exact int32 sums


def otsu_threshold_gpu(img_u8: torch.Tensor) -> torch.Tensor:
    """The threshold t (0-d int32) such that the binary image is ``img > t``.

    As the JAX twin: the histogram and the moment cumsums are exact int32
    (float32 partial sums go inexact past 2^24 and can flip near-tied
    variances); the class means and between-class variances are float32,
    where cv2 uses double, so an exactly tied pair of thresholds may resolve
    differently from cv2; the first maximum wins.  A class of weight 0 has
    variance 0, which stands for cv2's FLT_EPSILON skip (the smallest
    nonzero integer weight is one pixel)."""
    if img_u8.numel() >= MAX_PIXELS:
        raise ValueError(f"otsu_threshold_gpu supports < 2^23 px; got {tuple(img_u8.shape)}")
    hist = torch.bincount(img_u8.reshape(-1).long(), minlength=256).int()
    total = hist.sum(dtype=torch.int32)
    bins = torch.arange(256, dtype=torch.int32, device=hist.device)
    w0 = torch.cumsum(hist, 0, dtype=torch.int32)  # background weight for threshold t (inclusive)
    w1 = total - w0
    sum0 = torch.cumsum(hist * bins, 0, dtype=torch.int32)
    sum_all = sum0[-1]
    w0f, w1f = w0.float(), w1.float()
    mu0 = torch.where(w0 > 0, sum0.float() / w0f.clamp(min=1), 0.0)
    mu1 = torch.where(w1 > 0, (sum_all - sum0).float() / w1f.clamp(min=1), 0.0)
    between = torch.where((w0 > 0) & (w1 > 0), w0f * w1f * (mu0 - mu1) ** 2, 0.0)
    return torch.argmax(between).int()


def otsu_binarize(img_u8: np.ndarray) -> Tuple[float, np.ndarray]:
    """(threshold, binary {0, 1} uint8 image) as
    ``cv2.threshold(img, 0, 1, THRESH_BINARY + THRESH_OTSU)`` returns them,
    from cv2's Otsu transcribed (``ops/meta_post.otsu_threshold_u8``)."""
    img = np.asarray(img_u8, dtype=np.uint8)
    t = otsu_threshold_u8(img)
    return float(t), (img > t).astype(np.uint8)
