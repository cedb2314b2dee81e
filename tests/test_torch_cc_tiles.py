"""The B2-B5 twins on masks aimed at the tiled union-find kernels' edges
(tests/_masks.py ``TILE_MASKS``: a checkerboard, diagonals through tile
corners, a staircase, frames on the tile grid, a giant background with
holes, a single row and column, full and empty, sizes off every tile
multiple): ``label_plain`` against ``scipy.ndimage.label`` numbered by each
component's minimum flat index, ``binary_fill_holes`` (which runs
``flood_from_border_plain`` on the CPU) against
``scipy.ndimage.binary_fill_holes``, ``flood_from_seeds_plain`` with every
``seed_patterns`` pattern against the scipy components that hold a seed,
``label_multiclass_plain`` on ``TILE_CLASS_MAPS`` against scipy per
class, ``flood_multiclass_plain`` on ``TILE_CLASS_MAPS`` with every seed
pattern against the scipy components of each class that hold a seed, and
``label_and_flood_plain`` (labels and flood) on ``TILE_MASKS`` with every
seed pattern.  The kernels are held against the same twins on the same
masks on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops.morphology_gpu import binary_fill_holes

from _masks import TILE_CLASS_MAPS, TILE_MASKS, seed_patterns
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


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_seeded_flood_twin_matches_scipy_on_tile_masks(name, conn):
    m = TILE_MASKS[name]
    lab = _canonical(m, conn)
    for pattern, seeds in seed_patterns(m).items():
        got = K.flood_from_seeds(torch.from_numpy(m), torch.from_numpy(seeds), conn)
        want = np.isin(lab, lab[seeds & m]) & m
        np.testing.assert_array_equal(got.numpy(), want, err_msg=pattern)


@pytest.mark.parametrize("name", sorted(TILE_CLASS_MAPS))
def test_multiclass_label_twin_matches_scipy(name):
    cls = TILE_CLASS_MAPS[name]
    want = np.full(cls.shape, -1)
    for c in np.unique(cls[cls > 0]):
        want = np.where(cls == c, _canonical(cls == c, 2), want)
    got = K.label_multiclass(torch.from_numpy(cls))
    assert got.dtype == torch.int32 and tuple(got.shape) == cls.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(TILE_CLASS_MAPS))
def test_multiclass_flood_twin_matches_scipy(name):
    """Seeds on class 0 (the whole ``off_mask`` pattern) are ignored."""
    cls = TILE_CLASS_MAPS[name]
    for pattern, seeds in seed_patterns(cls > 0).items():
        want = np.zeros(cls.shape, bool)
        for c in np.unique(cls[cls > 0]):
            lab = _canonical(cls == c, 2)
            want |= np.isin(lab, lab[seeds & (cls == c)]) & (cls == c)
        got = K.flood_multiclass(torch.from_numpy(cls), torch.from_numpy(seeds))
        assert got.dtype == torch.bool and tuple(got.shape) == cls.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=pattern)


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_label_and_flood_twin_matches_scipy_on_tile_masks(name, conn):
    m = TILE_MASKS[name]
    lab = _canonical(m, conn)
    for pattern, seeds in seed_patterns(m).items():
        got_lab, got_flood = K.label_and_flood(torch.from_numpy(m), torch.from_numpy(seeds), conn)
        assert got_lab.dtype == torch.int32 and got_flood.dtype == torch.bool
        np.testing.assert_array_equal(got_lab.numpy(), lab, err_msg=pattern)
        np.testing.assert_array_equal(got_flood.numpy(), np.isin(lab, lab[seeds & m]) & m, err_msg=pattern)
