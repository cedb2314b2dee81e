"""The port's B2-B4 plain twins (ecseg_torch/ops/cc_kernels) against the JAX
Pallas entry points they stand in for -- label_pallas,
flood_from_border_pallas, flood_from_seeds_pallas (interpret mode on the
CPU) and the banded label_banded / flood_banded -- on the masks of
tests/test_cc_pallas.py and tests/test_cc_pallas_banded.py.  The CUDA
kernels themselves are held against these twins on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# cc_pallas_banded binds cc_pallas's interpret-mode flag when it is first
# imported.  Importing it here, at collection, binds the real flag in a
# worker that collects this file before a test monkeypatches cc_pallas; this
# masks, and does not fix, an order dependence in the JAX suite (ROADMAP C)
from ecseg_tpu.ops import cc_pallas_banded
from ecseg_tpu.ops.cc_pallas import (
    flood_from_border_pallas,
    flood_from_seeds_pallas,
    label_pallas,
)
from ecseg_torch.ops import cc_kernels as K

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

from _masks import MASKS, seeds_like as _seeds, snake as _snake, spiral as _spiral


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_label_twin_matches_label_pallas(name, conn):
    m = MASKS[name]
    want = np.asarray(label_pallas(jnp.asarray(m), connectivity=conn))
    got = K.label(torch.from_numpy(m), connectivity=conn)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", sorted(MASKS))
def test_flood_seeds_twin_matches_pallas(name, conn):
    m = MASKS[name]
    seeds = _seeds(m)
    want = np.asarray(
        flood_from_seeds_pallas(jnp.asarray(m), jnp.asarray(seeds), connectivity=conn)
    )
    got = K.flood_from_seeds(torch.from_numpy(m), torch.from_numpy(seeds), conn)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(MASKS))
def test_flood_border_twin_matches_pallas(name):
    m = MASKS[name]
    want = np.asarray(flood_from_border_pallas(jnp.asarray(m)))
    got = K.flood_from_border(torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), want)


# --- the banded TPU kernels (the 2048^2-class contract) -----------------


@pytest.fixture
def small_bands(monkeypatch):
    """Shrink the band geometry so small maps cross several bands (as
    tests/test_cc_pallas_banded.py does)."""
    monkeypatch.setattr(cc_pallas_banded, "_BAND", 32)
    monkeypatch.setattr(cc_pallas_banded, "_HALO", 8)
    return cc_pallas_banded


def _banded_cases():
    rng = np.random.default_rng(7)
    m1 = rng.random((200, 260)) < 0.22
    for _ in range(8):
        y, x = rng.integers(0, 160), rng.integers(0, 200)
        m1[y : y + 40, x : x + 40] = True
    m2 = np.zeros((200, 260), bool)
    for i, r in enumerate(range(2, 190, 10)):
        m2[r, 4:-4] = True
        m2[r : r + 10, -5 if i % 2 == 0 else 4] = True
    m2 |= rng.random((200, 260)) < 0.1
    return [m1, m2, np.zeros((96, 130), bool), np.ones((96, 130), bool)]


BANDED = _banded_cases()


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("case", range(len(BANDED)))
def test_twins_match_banded_kernels(small_bands, case, conn):
    m = BANDED[case]
    seeds = _seeds(m, seed=case)
    want_lab = np.asarray(small_bands.label_banded(jnp.asarray(m), connectivity=conn))
    want_fl = np.asarray(
        small_bands.flood_banded(jnp.asarray(m), jnp.asarray(seeds), connectivity=conn)
    )
    np.testing.assert_array_equal(K.label(torch.from_numpy(m), conn).numpy(), want_lab)
    np.testing.assert_array_equal(
        K.flood_from_seeds(torch.from_numpy(m), torch.from_numpy(seeds), conn).numpy(),
        want_fl,
    )


def test_twins_on_long_paths_match_scipy():
    """Snakes and spirals past the fixture sizes: canonical labels equal
    scipy's components, numbered by their minimum flat index."""
    from scipy import ndimage as ndi

    for m in (_snake(300, 257, 2), _spiral(257, 300), np.random.default_rng(3).random((256, 300)) < 0.6):
        for conn in (1, 2):
            lab, n = ndi.label(m, ndi.generate_binary_structure(2, conn))
            first = np.full(n + 1, m.size)
            np.minimum.at(first, lab.ravel(), np.arange(m.size))
            want = np.where(lab > 0, first[lab], -1)
            np.testing.assert_array_equal(K.label_plain(torch.from_numpy(m), conn).numpy(), want)
