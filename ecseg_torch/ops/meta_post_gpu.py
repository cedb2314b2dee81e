"""meta_inference on the device: the metaseg post-processing chain in its
per-class form (twin of ``ecseg_tpu/ops/meta_post_tpu.py`` with
``ECSEG_MC_LABEL=0``), on kernels B2-B4.

Wherever the JAX twin calls a Pallas entry (``_flat_roots``,
``_flagged_components``, ``_fill_holes_class``, ``_merge_comp``,
``count_roots_tpu``), this module calls that entry's port, so the launch
counters report the same call structure: per image B2 x8, B3 x2, B4 x5.

Arithmetic follows the host oracle (``ops/meta_post.meta_inference``), the
authority, in int64 and float64: component areas and coordinate sums are
exact integers, a centroid is ``float64(S) / float64(N)`` (the one correctly
rounded division of ``ops/cc.Region.centroid``), the band tests compare it
with ``n + 70`` in float64, and the size means are ``float64(sum) / count``
as ``np.mean`` computes them (0/0 is NaN and disables the threshold).  The
JAX twin's limb arithmetic and near-tie flags exist because JAX on the TPU
has no 64-bit types; they are not needed here.

``ok`` is False only when a component budget overflows (``MAX_COMP``
components of a class in the size thresholds, ``MAX_CHROM`` chromosomes or
``MAX_NUC`` nuclei in the metaphase test), the same gates as the JAX twin;
the caller then redoes the image on the host oracle.  The budgets bound the
nucleus x chromosome centroid grid.

Reference quirks kept (same list as ``ops/meta_post.py``): merge_comp skips
scipy's last label, which is the component with the largest min-index root;
the ecDNA size list is the stale pre-conversion one; NaN means.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cc_kernels import flood_from_seeds, label
from .morphology import diamond
from .morphology_gpu import binary_dilation, binary_erosion, binary_fill_holes

EC_SIZE_THRESHOLD = 15  # reference src/image_tools.py:13
MIN_CHROM_COUNT = 5  # reference src/image_tools.py:72
BAND_V = 70.0  # reference src/image_tools.py:72

MAX_COMP = 4096  # per-class components in the size thresholds
MAX_CHROM = 2048  # chromosomes in the metaphase test
MAX_NUC = 512  # nuclei in the metaphase test

_D1 = diamond(1)


def _flat_roots(mask: torch.Tensor) -> torch.Tensor:
    """(H*W,) int64: each pixel's 8-connected component root (its min flat
    index), H*W on background (kernel B2)."""
    lab = label(mask, connectivity=2).reshape(-1).long()
    return torch.where(lab < 0, mask.numel(), lab)


def _root_sizes(flat: torch.Tensor, hw: int) -> torch.Tensor:
    """(hw,) int64: the component's area at its root pixel, 0 elsewhere."""
    return torch.bincount(flat, minlength=hw + 1)[:hw]


def count_roots_gpu(mask: torch.Tensor) -> torch.Tensor:
    """Number of 8-connected components of a binary mask (the first element
    of the reference's count_cc, src/image_tools.py:114-119)."""
    flat = _flat_roots(mask.bool())
    return (flat == torch.arange(flat.numel(), device=flat.device)).sum()


def _fill_holes_class(img: torch.Tensor, class_id: int) -> torch.Tensor:
    """img[binary_fill_holes(img == class_id)] = class_id (kernel B3)."""
    return torch.where(binary_fill_holes(img == class_id), class_id, img)


def _flagged_components(mask: torch.Tensor, root_flags: torch.Tensor) -> torch.Tensor:
    """Pixels of the components whose root pixel is flagged: a seeded flood
    from the flagged roots through the class mask (kernel B4)."""
    return flood_from_seeds(mask, root_flags.view(mask.shape), connectivity=2)


def _size_thresh(img: torch.Tensor, hw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-size thresholds (reference src/image_tools.py:41-59): nuclei
    smaller than the mean chromosome -> background, chromosomes smaller than
    the mean ecDNA -> ecDNA, then the STALE ecDNA list below
    EC_SIZE_THRESHOLD -> background.  The three writes touch disjoint pixel
    sets of the input classes, as in the reference's order."""
    nuc, chrom, ec = img == 1, img == 2, img == 3
    sizes_n = _root_sizes(_flat_roots(nuc), hw)
    sizes_c = _root_sizes(_flat_roots(chrom), hw)
    sizes_e = _root_sizes(_flat_roots(ec), hw)
    num_n, num_c, num_e = ((s > 0).sum() for s in (sizes_n, sizes_c, sizes_e))
    avg_chrom = chrom.sum().double() / num_c.double()  # 0/0 -> NaN
    avg_ec = ec.sum().double() / num_e.double()
    small_nuc = (sizes_n > 0) & (sizes_n.double() < avg_chrom)
    conv_chrom = (sizes_c > 0) & (sizes_c.double() < avg_ec)
    small_ec = (sizes_e > 0) & (sizes_e < EC_SIZE_THRESHOLD)
    img = torch.where(_flagged_components(nuc, small_nuc), 0, img)
    img = torch.where(_flagged_components(chrom, conv_chrom), 3, img)
    img = torch.where(_flagged_components(ec, small_ec), 0, img)
    ok = (num_n <= MAX_COMP) & (num_c <= MAX_COMP) & (num_e <= MAX_COMP)
    return img, ok


def _centroids(flat: torch.Tensor, hw: int, w: int):
    """(roots, cy, cx) of every component, roots ascending."""
    sizes = _root_sizes(flat, hw)
    roots = torch.nonzero(sizes).reshape(-1)
    pix = torch.arange(hw, device=flat.device)
    sy = torch.zeros(hw + 1, dtype=torch.int64, device=flat.device)
    sx = torch.zeros_like(sy)
    sy.scatter_add_(0, flat, pix // w)
    sx.scatter_add_(0, flat, pix % w)
    n = sizes[roots].double()
    return roots, sy[roots].double() / n, sx[roots].double() / n


def _metaphase_removal(img: torch.Tensor, hw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nuclei with more than MIN_CHROM_COUNT chromosome centroids in each of
    the four BAND_V-px bands around their centroid go to background
    (reference src/image_tools.py:71-81)."""
    h, w = img.shape
    c_flat = _flat_roots(img == 2)
    n_flat = _flat_roots(img == 1)
    ok = (_root_sizes(c_flat, hw) > 0).sum() <= MAX_CHROM
    ok &= (_root_sizes(n_flat, hw) > 0).sum() <= MAX_NUC
    if not bool(ok):  # over budget: the caller redoes the image on the host
        return img, ok
    _, cy, cx = _centroids(c_flat, hw, w)
    n_roots, ny, nx = _centroids(n_flat, hw, w)
    cy, cx = cy[None, :], cx[None, :]
    ny, nx = ny[:, None], nx[:, None]

    def band(inside) -> torch.Tensor:
        return inside.sum(dim=1) > MIN_CHROM_COUNT

    left = band((cx > nx) & (cx < nx + BAND_V))
    right = band((cx < nx) & (cx > nx - BAND_V))
    bottom = band((cy < ny) & (cy > ny - BAND_V))
    top = band((cy > ny) & (cy < ny + BAND_V))
    remove = torch.zeros(hw + 1, dtype=torch.bool, device=img.device)
    remove[n_roots[left & right & bottom & top]] = True
    return torch.where(remove[n_flat].view(h, w), 0, img), ok


def _shift_edge(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift by one with edge replication (scipy's 'reflect' border for the
    radius-1 diamond)."""
    if dy == 1:
        return torch.cat([x[:1], x[:-1]], 0)
    if dy == -1:
        return torch.cat([x[1:], x[-1:]], 0)
    if dx == 1:
        return torch.cat([x[:, :1], x[:, :-1]], 1)
    return torch.cat([x[:, 1:], x[:, -1:]], 1)


_CROSS = ((1, 0), (-1, 0), (0, 1), (0, -1))


def _gray_opening_d1(img: torch.Tensor) -> torch.Tensor:
    """Grey opening with diamond(1) (ops/morphology.opening)."""
    e = img
    for dy, dx in _CROSS:
        e = torch.minimum(e, _shift_edge(img, dy, dx))
    d = e
    for dy, dx in _CROSS:
        d = torch.maximum(d, _shift_edge(e, dy, dx))
    return d


def _merge_comp(img: torch.Tensor, class_id: int, hw: int) -> torch.Tensor:
    """Components (8-connected, with the sibling class hidden) touching
    ``class_id`` become ``class_id``, except scipy's last label, the
    component with the largest root (reference src/image_tools.py:18-33);
    then the grey-opening write and the sibling restore."""
    mask_id = 1 if class_id == 2 else 2
    temp = img == mask_id
    img = torch.where(temp, 0, img)
    fg = img != 0
    touched = flood_from_seeds(fg, img == class_id, connectivity=2)
    flat = _flat_roots(fg)
    idx = torch.arange(hw, device=img.device)
    max_root = torch.where(flat == idx, idx, -1).max()
    merged = touched & (flat != max_root).view(img.shape)
    img = torch.where(merged, class_id, img)
    img = torch.where(_gray_opening_d1(img) == class_id, class_id, img)
    return torch.where(temp, mask_id, img)


def meta_inference_gpu(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device twin of ops/meta_post.meta_inference
    (reference src/image_tools.py:15-84).

    ``img``: (H, W) integer 4-class label map.  Returns ``(out, ok)``: the
    int64 post-processed map and a bool scalar tensor; when ``ok`` is False
    (a component budget overflowed) the caller recomputes on the host
    oracle."""
    img = img.long()
    hw = img.numel()
    img = _fill_holes_class(img, 1)
    img = _fill_holes_class(img, 2)
    img, ok_sizes = _size_thresh(img, hw)

    ec = img == 3
    ring = binary_dilation(ec, _D1) ^ binary_erosion(ec, _D1)
    img = torch.where(ring, 0, img)

    img, ok = _metaphase_removal(img, hw)
    ok = ok & ok_sizes

    img = _merge_comp(img, 1, hw)
    img = _merge_comp(img, 2, hw)

    img = torch.where(binary_dilation(img == 3, _D1), 3, img)
    return img, ok
