"""The B2 and B3 twins on masks aimed at the tiled union-find kernels'
edges (tests/_masks.py ``TILE_MASKS``: a checkerboard, diagonals through
tile corners, a staircase, frames on the tile grid, a giant background with
holes, a single row and column, full and empty, sizes off every tile
multiple): ``label_plain`` against ``scipy.ndimage.label`` numbered by each
component's minimum flat index, and ``binary_fill_holes`` (which runs
``flood_from_border_plain`` on the CPU) against
``scipy.ndimage.binary_fill_holes``.  The kernels are held against the same
twins on the same masks on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops.morphology_gpu import binary_fill_holes

from _masks import TILE_MASKS
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)


def _canonical(m, conn):
    if m.size == 0:
        return np.zeros(m.shape, np.int32)
    lab, n = ndi.label(m, ndi.generate_binary_structure(2, conn))
    first = np.full(n + 1, m.size)
    np.minimum.at(first, lab.ravel(), np.arange(m.size))
    return np.where(lab > 0, first[lab], -1)


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_label_twin_matches_scipy_on_tile_masks(name, conn):
    m = TILE_MASKS[name]
    got = K.label(torch.from_numpy(m), conn)
    assert got.dtype == torch.int32 and tuple(got.shape) == m.shape
    np.testing.assert_array_equal(got.numpy(), _canonical(m, conn))


@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_fill_holes_matches_scipy_on_tile_masks(name):
    """Each mask and its complement, so every case is the border flood's
    input once as background and once as foreground."""
    for m in (TILE_MASKS[name], ~TILE_MASKS[name]):
        want = ndi.binary_fill_holes(m) if m.size else m
        np.testing.assert_array_equal(binary_fill_holes(torch.from_numpy(m)).numpy(), want)
