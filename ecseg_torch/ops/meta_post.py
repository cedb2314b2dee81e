"""metaseg post-processing on the host: the exact-parity oracle (twin of
``ecseg_tpu/ops/meta_post.py``) and the input preprocessing.

``meta_inference`` reproduces reference src/image_tools.py:15-84 operation
for operation, quirks included, because its output IS the public
``labels/<name>.npy`` artifact:

- ``merge_comp``'s loop runs ``range(1, num_features)`` and so skips the
  last component (image_tools.py:27);
- both clauses of the metaphase-centre test reduce to ``left and bottom and
  right and top`` (image_tools.py:80);
- ``size_thresh`` takes the ecDNA region list *before* small chromosomes
  become ecDNA, so converted pixels are not size-filtered
  (image_tools.py:50-58);
- ``np.mean([])`` of an empty region list is NaN and disables the
  threshold.

The device form is ``ops/meta_post_gpu.py``; this oracle is its fallback.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage as ndi

from ..core.imgio import u16_to_u8
from . import morphology as morph
from .cc import label as cc_label, regionprops

EC_SIZE_THRESHOLD = 15  # reference src/image_tools.py:13


def _merge_comp(img: np.ndarray, class_id: int = 2) -> np.ndarray:
    """If ecDNA touches chromosome/nuclei, mark the whole 8-connected
    component as that class (reference src/image_tools.py:18-33); the
    per-component loop as one "touches class_id" lookup table, last label
    skipped."""
    mask_id = 1
    if class_id == 1:
        mask_id = 2
    temp = img == mask_id
    img[temp] = 0
    s = ndi.generate_binary_structure(2, 2)
    labeled_array, num_features = ndi.label(img, structure=s)
    touching = np.unique(labeled_array[img == class_id])
    lut = np.zeros(num_features + 1, dtype=bool)
    lut[touching] = True
    lut[0] = False
    if num_features >= 1:
        lut[num_features] = False  # reference off-by-one: last label skipped
    img[lut[labeled_array]] = class_id
    img[morph.opening(img, morph.diamond(1)) == class_id] = class_id
    img[temp] = mask_id
    return img


def _fill_holes(img: np.ndarray, class_id: int) -> np.ndarray:
    temp = morph.binary_fill_holes(img == class_id)
    img[temp] = class_id
    return img


def _size_thresh(img: np.ndarray) -> np.ndarray:
    nuc_regs = regionprops(cc_label(img == 1))
    chrom_regs = regionprops(cc_label(img == 2))
    avg_chrom_size = np.mean([c.area for c in chrom_regs]) if chrom_regs else np.nan
    for r in nuc_regs:
        if r.area < avg_chrom_size:
            r.write(img, 0)

    chrom_regs = regionprops(cc_label(img == 2))
    ec_regs = regionprops(cc_label(img == 3))
    avg_ec_size = np.mean([c.area for c in ec_regs]) if ec_regs else np.nan
    for r in chrom_regs:
        if r.area < avg_ec_size:
            r.write(img, 3)

    for r in ec_regs:  # stale list (pre-conversion), as in the reference
        if r.area < EC_SIZE_THRESHOLD:
            r.write(img, 0)
    return img


def meta_inference(img: np.ndarray) -> np.ndarray:
    """Full post-processing chain (reference src/image_tools.py:15-84).
    ``img`` is the argmaxed 4-class label map; modified in place and
    returned."""
    img = _fill_holes(_fill_holes(img, 1), 2)
    img = _size_thresh(img)
    d1 = morph.diamond(1)
    img[
        morph.binary_dilation(img == 3, d1) ^ morph.binary_erosion(img == 3, d1)
    ] = 0

    chrom_regs = regionprops(cc_label(img == 2))
    nuc_regs = regionprops(cc_label(img == 1))
    c_y = np.array([c.centroid[0] for c in chrom_regs])
    c_x = np.array([c.centroid[1] for c in chrom_regs])
    n_cent = [n.centroid for n in nuc_regs]

    min_chrom_count = 5
    v = 70
    for idx, n in enumerate(n_cent):
        left = len(np.where((c_x > n[1]) & (c_x < n[1] + v))[0]) > min_chrom_count
        right = len(np.where((c_x < n[1]) & (c_x > n[1] - v))[0]) > min_chrom_count
        bottom = len(np.where((c_y < n[0]) & (c_y > n[0] - v))[0]) > min_chrom_count
        top = len(np.where((c_y > n[0]) & (c_y < n[0] + v))[0]) > min_chrom_count
        if (left * bottom & right * top) or (bottom * right & top * left):
            nuc_regs[idx].write(img, 0)

    img = _merge_comp(_merge_comp(img, 1), 2)
    img[morph.binary_dilation(img == 3, morph.diamond(1))] = 3
    return img


def otsu_threshold_u8(img: np.ndarray) -> int:
    """The threshold ``cv2.threshold(img, 0, 1, THRESH_BINARY + THRESH_OTSU)``
    picks for a uint8 image: OpenCV's ``getThreshVal_Otsu_8u``, transcribed
    with its double-precision incremental sums, its FLT_EPSILON skips (which
    also skip normalising ``mu1``) and its strict ``>`` (first maximum wins
    on ties)."""
    hist = np.bincount(np.asarray(img, np.uint8).ravel(), minlength=256)
    scale = 1.0 / img.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    eps = float(np.finfo(np.float32).eps)
    mu1 = q1 = 0.0
    max_sigma = 0.0
    max_val = 0
    for i in range(256):
        p_i = float(hist[i]) * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma = sigma
            max_val = i
    return max_val


def meta_preprocess(img: np.ndarray) -> np.ndarray:
    """uint16 -> uint8, blue channel extraction, background-polarity fix
    (reference src/image_tools.py:86-96)."""
    img = u16_to_u8(img)
    if img.ndim > 2:
        img = img[:, :, 2]
    img = np.ascontiguousarray(img)
    th3 = img > otsu_threshold_u8(img)
    if np.sum(th3) > img.shape[0] * img.shape[1] * 0.5:
        img = ~img
    return img
