"""Training data for the metaseg U-Net (twin of
``ecseg_tpu/runtime/data.py``).

Trains on folders in the on-disk format metaseg writes and reads
(``<inpath>/*.tif`` DAPI images + ``<inpath>/labels/*.npy`` 4-class maps),
so corrected label maps go straight back in as training data.  Every batch
is a (B, 256, 256, 1) uint8 / (B, 256, 256) int32 pair of random crops with
flip and rotation augmentation, drawn on the host with numpy from a seed:
the same draws in the same order as the JAX package's generator, so both
packages train on the same bytes.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from ..core import imgio
from ..ops.meta_post import meta_preprocess

PATCH = 256


def load_training_pairs(inpath: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """All (image uint8 (H, W), labels int32 (H, W)) pairs in a
    metaseg-format folder, cut to their common size; images without a
    ``labels/<name>.npy``, or with a side under ``PATCH``, are skipped."""
    pairs = []
    for path in imgio.get_imgs(inpath):
        head, tail = os.path.split(path)
        lab_path = os.path.join(head, "labels", tail[:-4] + ".npy")
        if not os.path.exists(lab_path):
            continue
        img = meta_preprocess(imgio.imread_rgb(path))
        lab = np.load(lab_path)
        h = min(img.shape[0], lab.shape[0])
        w = min(img.shape[1], lab.shape[1])
        if h < PATCH or w < PATCH:
            continue
        pairs.append((img[:h, :w], lab[:h, :w].astype(np.int32)))
    return pairs


def crop_batches(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    steps: int,
    seed: int = 0,
    augment: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``steps`` batches of random ``PATCH``^2 crops (with flips and a
    rotation by ``k`` quarter turns when ``augment``), deterministic in
    ``seed``."""
    if not pairs:
        return
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        xs = np.empty((batch_size, PATCH, PATCH, 1), np.uint8)
        ys = np.empty((batch_size, PATCH, PATCH), np.int32)
        for b in range(batch_size):
            img, lab = pairs[rng.integers(len(pairs))]
            y0 = rng.integers(img.shape[0] - PATCH + 1)
            x0 = rng.integers(img.shape[1] - PATCH + 1)
            xi = img[y0 : y0 + PATCH, x0 : x0 + PATCH]
            yi = lab[y0 : y0 + PATCH, x0 : x0 + PATCH]
            if augment:
                if rng.random() < 0.5:
                    xi, yi = xi[::-1], yi[::-1]
                if rng.random() < 0.5:
                    xi, yi = xi[:, ::-1], yi[:, ::-1]
                k = rng.integers(4)
                xi, yi = np.rot90(xi, k), np.rot90(yi, k)
            xs[b, ..., 0] = xi
            ys[b] = yi
        yield xs, ys


def pad_to_multiple(x: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad the leading axis with zeros up to a multiple of ``multiple`` (the
    device count of a data-parallel batch); returns (padded, original n)
    (``ecseg_tpu/parallel/mesh.py:80-88``)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem:
        x = np.concatenate([x, np.zeros((rem,) + x.shape[1:], dtype=x.dtype)], axis=0)
    return x, n
