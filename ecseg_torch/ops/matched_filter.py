"""Zero-DC Gaussian matched filter ("least squares") FISH foci detection and
the stat_fish image helpers (twin of ``ecseg_tpu/ops/matched_filter.py:30-333``;
reference src/stat_fish.py:28-132).

The matched-filter correlation has two twins: the host
:func:`get_thresholded` (float64, TF-'SAME' alignment,
``ops/conv_host.py``), and :func:`get_thresholded_device_packed`, one
float32 ``conv2d`` per FISH channel on the card with the same explicit
asymmetric padding and the whole gate (coefficient above
``normal_threshold`` or the channel's maximum, intensity above
``color_sensitivity``, inside a nucleus) around it, the nuclei mask up and
the centers down 1 bit a pixel.  The JAX package pins ``Precision.HIGHEST``
on its conv because reduced precision flips ``coeffs > normal_threshold``
pixels; here cuDNN runs with TF32 off.
"""

from __future__ import annotations

import numpy as np
import scipy.stats
import torch
import torch.nn.functional as F

from ..models.layers import parity_flags
from .cc import regionprops, scipy_label
from .conv_host import conv2d_same_tf
from .packing import fetch, pack_mask_1bit, pack_mask_1bit_host, unpack_mask_1bit, unpack_mask_1bit_device


def scipy_sampled_gaussian_kernel(kernel_shape, sigma: float = 1) -> np.ndarray:
    """reference stat_fish.py:28-38."""
    if not isinstance(kernel_shape, np.ndarray):
        kernel_shape = np.array(kernel_shape)
    centers = (kernel_shape / 2) - 0.5
    axes = [
        np.arange(n) - c for n, c in zip(kernel_shape, centers)
    ]  # y-axis, x-axis
    ky, kx = axes
    grid = np.linalg.norm(
        np.dstack(np.meshgrid(kx, ky)), axis=2
    ).astype(np.float64)
    gaussian = scipy.stats.norm.pdf(grid, scale=sigma)
    return gaussian / gaussian.sum()


def get_gaussian_proj_kernel(kernel_size, sigma: float) -> np.ndarray:
    """Gaussian minus its projection onto the constant kernel, normalized
    (reference stat_fish.py:41-55).  Returns a 2-D kernel (the reference
    appends singleton conv dims; we keep it 2-D)."""
    g = scipy_sampled_gaussian_kernel(kernel_size, sigma=sigma)
    c = np.ones(kernel_size)
    c = c / np.linalg.norm(c)
    g_proj = np.dot(g.flatten(), c.flatten()) * c
    g_perp = g - g_proj
    return g_perp / np.linalg.norm(g_perp)


def get_thresholded(
    I: np.ndarray,
    segmented_cells: np.ndarray,
    gaussian_stdev: float,
    normal_threshold: float,
    color_sensitivity,
    gaussian_kernel_shape,
) -> np.ndarray:
    """Per-FISH-channel center detection (reference stat_fish.py:73-88).
    ``I`` is the BGR image; channels 1.. are the FISH channels.  Returns
    (H, W, n_channels-1) int array with values {0, 255} (segmented_cells is
    the 0/255 nuclei mask)."""
    kernel = get_gaussian_proj_kernel(gaussian_kernel_shape, gaussian_stdev)
    num_channels = I.shape[-1]
    chans = [I[..., c].astype(np.float64) for c in range(1, num_channels)]
    normal_coefficients = np.dstack(
        [conv2d_same_tf(ch, kernel) for ch in chans]
    )
    max_pixels = np.dstack(
        [(ch == ch.max()) * bool(ch.max()) for ch in chans]
    ).astype(int)
    centers = ((normal_coefficients > normal_threshold) + max_pixels).astype(bool)

    thresholded = (
        centers * (I[..., 1:] > np.asarray(color_sensitivity))
    ).astype(int)
    thresholded *= np.dstack([segmented_cells] * (num_channels - 1))
    return thresholded


def get_thresholded_device_packed(
    I: np.ndarray,
    segmented_cells: np.ndarray,
    gaussian_stdev: float,
    normal_threshold: float,
    color_sensitivity,
    gaussian_kernel_shape,
    device,
) -> np.ndarray:
    """Device twin of :func:`get_thresholded` with packed transfers (the JAX
    package's ``get_thresholded_device_packed``,
    ``ecseg_tpu/ops/matched_filter.py:161-238``): only the FISH channels go
    up, as uint8, and the nuclei mask as a host-packed bitmap; the
    per-channel centers come back packed 1 bit a pixel, (C-1, H, ceil(W/8)).
    The host unpacks them and scales by the mask's foreground value (255 in
    the pipeline: the reference multiplies by the 0/255 mask).  Returns a
    writable int32 (H, W, C-1) array the caller may change in place."""
    h, w = segmented_cells.shape
    kernel = torch.from_numpy(get_gaussian_proj_kernel(np.array(gaussian_kernel_shape), gaussian_stdev).astype(np.float32))
    kh, kw = kernel.shape
    fish = torch.from_numpy(np.ascontiguousarray(I[..., 1:])).to(device)
    cells_packed = torch.from_numpy(pack_mask_1bit_host(segmented_cells)).to(device)
    chans = fish.permute(2, 0, 1).float()  # (C-1, H, W)
    pad = ((kw - 1) // 2, kw - 1 - (kw - 1) // 2, (kh - 1) // 2, kh - 1 - (kh - 1) // 2)
    with parity_flags():
        coeffs = F.conv2d(F.pad(chans[:, None], pad), kernel.to(device)[None, None])[:, 0]
    ch_max = chans.amax(dim=(1, 2), keepdim=True)
    centers = (coeffs > torch.tensor(normal_threshold, dtype=torch.float32)) | ((chans == ch_max) & (ch_max > 0))
    sens = torch.tensor(np.asarray(color_sensitivity, np.float32), device=device).view(-1, 1, 1)
    cells = unpack_mask_1bit_device(cells_packed, w) != 0
    out = centers & (chans > sens) & cells
    packed = fetch(torch.stack([pack_mask_1bit(c) for c in out]))
    fg_value = int(segmented_cells.max()) if segmented_cells.any() else 0
    result = np.empty((h, w, len(packed)), np.int32)
    for c, bits in enumerate(packed):
        result[..., c] = unpack_mask_1bit(bits, w)
    result *= fg_value
    return result


def get_boundaries(s: np.ndarray, line_thickness: int = 1) -> np.ndarray:
    """Label-boundary visualization (reference stat_fish.py:91-107): detects
    horizontal/vertical label changes with [1]*t + [-1]*t kernels; returns
    (H, W, 3) int with (b, -b, b) channels, b in {0, 255}.

    Formulated as int32 shifted-window sums and an int16 result instead of
    the generic int64 conv: the int64 form moved ~400 MB of host memory per
    2048^2 image (0.52 s on this 1-core box, squarely on the stat_fish tail
    critical path) vs ~0.13 s here.  Values are identical: label sums of
    ``line_thickness`` labels fit int32, and every consumer either compares
    against small constants or wraps through uint8, where int16 and int64
    agree."""
    s = np.asarray(s)
    if s.dtype == np.int64 and (s.size == 0 or int(s.max()) < 2**30):
        s = s.astype(np.int32)  # halve the shifted-window traffic
    elif s.dtype != np.int64 and s.dtype != np.int32:
        s = s.astype(np.int32)  # signed accumulator (uint would wrap)
    t = line_thickness

    def change(axis):
        # conv with [1]*t + [-1]*t over TF-'SAME' zero padding == (sum of
        # the t labels left of the tap) - (sum of the t right); nonzero
        # means a label change inside the window
        k = 2 * t
        plo, phi = (k - 1) // 2, k - 1 - (k - 1) // 2
        pad = [(0, 0), (0, 0)]
        pad[axis] = (plo, phi)
        xp = np.pad(s, pad)
        H, W = s.shape
        acc = np.zeros(s.shape, xp.dtype)
        for a in range(k):
            sl = [slice(None), slice(None)]
            sl[axis] = slice(a, a + (H if axis == 0 else W))
            view = xp[tuple(sl)]
            if a < t:
                acc += view
            else:
                acc -= view
        return acc != 0  # label change across the window

    boundary = change(0) | change(1)
    b = boundary.astype(np.int16) * 255
    return np.dstack([b, -b, b])


def merge_channels(img: np.ndarray, aqua_rgb) -> np.ndarray:
    """Fold a 4th (aqua) channel into BGR (reference stat_fish.py:110-115)."""
    if img.shape[-1] == 3:
        return img
    assert img.shape[-1] == 4
    # int64 promotion (numpy 1.x semantics the reference ran under; numpy 2
    # would otherwise wrap the uint8 multiply)
    aqua = img[..., -1].astype(np.int64)
    img = img[..., :-1] + np.dstack([coeff * aqua / 255 for coeff in aqua_rgb[::-1]])
    return np.minimum(img, 255).astype(np.uint8)


def cell_splice_segmentation(i, thresh, s, region):
    """Crop the image, the threshold map and the instance mask to a
    region's bounding box (reference stat_fish.py:118-123): (image crop,
    threshold crop, the region's int {0, 1} mask, (row slice, column
    slice))."""
    y_sl, x_sl = region.slice
    img_splice = i[y_sl.start : y_sl.stop, x_sl.start : x_sl.stop, :]
    thresh_splice = thresh[y_sl.start : y_sl.stop, x_sl.start : x_sl.stop, :]
    seg_splice = (s[y_sl.start : y_sl.stop, x_sl.start : x_sl.stop] == region.label).astype(int)
    return img_splice, thresh_splice, seg_splice, (y_sl, x_sl)


def get_scale(labeled_segmented_cells, target_median_nuclei_size) -> float:
    """sqrt(target / median nucleus area) (reference stat_fish.py:127-132)."""
    areas = [r.area for r in regionprops(labeled_segmented_cells)]
    median = np.median(areas) if areas else np.nan
    return float(np.sqrt(target_median_nuclei_size / median))


def count_blobs(fish_splice: np.ndarray, cell_seg: np.ndarray, min_cc_size) -> int:
    """4-connected blob count of ``fish_splice * cell_seg``, with the blobs
    under ``min_cc_size`` pixels taken out of ``fish_splice`` in place (the
    reference mutates its input, stat_fish.py:134-142) and out of the
    count.  The pipeline counts every cell at once
    (``ops/region_stats.per_cell_blob_stats``)."""
    labeled_array, blob_count = scipy_label(fish_splice * cell_seg)
    for blob in regionprops(labeled_array):
        if blob.area < min_cc_size:
            y_sl, x_sl = blob.slice
            component = (labeled_array[y_sl.start : y_sl.stop, x_sl.start : x_sl.stop] == blob.label).astype(int)
            fish_splice[y_sl.start : y_sl.stop, x_sl.start : x_sl.stop] -= 255 * component
            blob_count -= 1
    return blob_count
