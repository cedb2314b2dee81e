"""The port's B8 twins (ecseg_torch/ops/cc_kernels count_components_plain,
count_from_patches_plain, reached through the wrappers on CPU tensors)
against the Pallas entries they stand in for, ``count_cc_pallas`` and
``count_cc_from_patches`` (interpret mode on the CPU), on the cases of
tests/test_cc_pallas.py:22-122; exact equality everywhere.  The CUDA
kernels are held against these twins on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecseg_tpu.ops.cc_pallas import count_cc_from_patches, count_cc_pallas
from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import tiling

from _masks import snake
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)


def _pair(t):
    return int(t[0]), int(t[1])


def _check_count(m, conn):
    want = _pair(count_cc_pallas(jnp.asarray(m), connectivity=conn))
    assert _pair(K.count_components(torch.from_numpy(m), conn)) == want
    return want


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("density", [0.15, 0.5, 0.85])
def test_count_twin_random(conn, density):
    m = np.random.default_rng(int(density * 100)).random((96, 160)) < density
    _check_count(m, conn)


@pytest.mark.parametrize("conn", [1, 2])
def test_count_twin_blobs_and_edges(conn):
    rng = np.random.default_rng(2)
    m = np.zeros((128, 200), bool)
    for _ in range(30):
        y, x = rng.integers(0, 120), rng.integers(0, 192)
        r = int(rng.integers(2, 7))
        m[y : y + r, x : x + r] = True
    m[0, :10] = m[-1, -10:] = True
    m[:10, 0] = m[-10:, -1] = True
    _check_count(m, conn)


def test_count_twin_degenerate_and_snake():
    assert _check_count(np.zeros((64, 128), bool), 2) == (0, 0)
    assert _check_count(np.ones((64, 128), bool), 2) == (1, 64 * 128)
    m = snake(64, 64)
    assert _check_count(m, 1) == (1, int(m.sum()))


def _labels_1024(rng):
    """tests/test_cc_pallas.py:79-96's 1024^2 label canvas: class-3 blobs and
    specks, class-1 clutter; class 2 sprinkled too, so every class has
    components."""
    h = w = 1024
    img = np.zeros((h, w), np.int32)
    for _ in range(150):
        y, x = rng.integers(0, h - 10, 2)
        r = int(rng.integers(2, 8))
        img[y : y + r, x : x + r] = 3
    img[rng.random((h, w)) < 0.002] = 3
    img[rng.random((h, w)) < 0.01] = 1
    img[rng.random((h, w)) < 0.005] = 2
    return img


def _patches(img, positions):
    return np.stack([img[y : y + 256, x : x + 256] for (y, x) in positions])


@pytest.fixture(scope="module")
def geometry_1024():
    positions = tuple(map(tuple, tiling.patch_positions(1024, 1024)))
    return positions, _patches(_labels_1024(np.random.default_rng(0)), positions)


@pytest.mark.parametrize("class_id", [0, 1, 2, 3])
def test_count_patches_twin_1024(geometry_1024, class_id):
    positions, patches = geometry_1024
    want = _pair(count_cc_from_patches(jnp.asarray(patches), positions, class_id=class_id))
    got = K.count_from_patches(torch.from_numpy(patches), positions, class_id)
    assert got[0].dtype == torch.int32 and got[0].dim() == 0
    assert _pair(got) == want
    # uint8 labels (the unfused path's) count the same
    assert _pair(K.count_from_patches(torch.from_numpy(patches.astype(np.uint8)), positions, class_id)) == want


def test_class_0_leaves_the_unwritten_rim_out(geometry_1024):
    """The Pallas kernel marks only copied pixels: at class 0 the 25-px
    right rim that the reference's copy plan never writes on square images
    is background, where ``stitch == 0`` on the zeroed canvas would count it.
    The twin equals the Pallas entry on this input at class 0
    (``test_count_patches_twin_1024[0]``)."""
    positions, patches = geometry_1024
    unwritten = (K._source_map(positions, torch.device("cpu")) < 0).numpy()
    assert unwritten.sum() == 25 * 768  # a 25-px strip of the right rim
    got = _pair(K.count_from_patches(torch.from_numpy(patches), positions, 0))
    canvas = K.stitch_plain(torch.from_numpy(patches), positions)
    naive = _pair(K.count_components(canvas == 0, 2))
    assert got[1] == naive[1] - unwritten.sum()
    written = K.stitch_plain(torch.ones_like(torch.from_numpy(patches)), positions) != 0
    assert got == _pair(K.count_components((canvas == 0) & written, 2))


@pytest.mark.parametrize("shape", [(700, 900), (256, 256), (512, 310)])
def test_count_patches_twin_irregular_geometries(shape):
    h, w = shape
    rng = np.random.default_rng(h + w)
    positions = tuple(map(tuple, tiling.patch_positions(h, w)))
    img = np.zeros((h, w), np.int32)
    for _ in range(40):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y : y + int(rng.integers(2, 7)), x : x + int(rng.integers(2, 7))] = 3
    patches = _patches(img, positions)
    want = _pair(count_cc_from_patches(jnp.asarray(patches), positions, class_id=3))
    assert _pair(K.count_from_patches(torch.from_numpy(patches), positions, 3)) == want


def test_count_patches_twin_batches_tiles(geometry_1024):
    """A (T, N, S, S) batch counts each tile as the single-tile call does."""
    positions, patches = geometry_1024
    batch = torch.from_numpy(np.stack([patches, np.roll(patches, 7, axis=2)]))
    for class_id in (1, 3):
        count, px = K.count_from_patches(batch, positions, class_id, 1)
        assert count.shape == px.shape == (2,)
        for t in range(2):
            assert (int(count[t]), int(px[t])) == _pair(K.count_from_patches(batch[t], positions, class_id, 1))
