"""Binary test masks and class maps shared by the port's tests (no JAX
import, so the card-only tests can use them on a machine without JAX)."""

import numpy as np


def snake(h, w, pitch=4):
    m = np.zeros((h, w), bool)
    for i, r in enumerate(range(0, h, pitch)):
        m[r, :] = True
        if r + pitch < h:
            m[r : r + pitch + 1, -1 if i % 2 == 0 else 0] = True
    return m


def spiral(h, w, pitch=2):
    """A one-pixel spiral path from the border inwards."""
    m = np.zeros((h, w), bool)
    top, left, bot, right = 0, 0, h - 1, w - 1
    while top <= bot and left <= right:
        m[top, left : right + 1] = True
        m[top : bot + 1, right] = True
        if bot - top >= pitch:
            m[bot, left : right + 1] = True
        if right - left >= pitch and top + pitch <= bot:
            m[top + pitch : bot + 1, left] = True
        top, left, bot, right = top + pitch, left + pitch, bot - pitch, right - pitch
        if top <= bot and left <= right:
            m[top - pitch + 1 : top + 1, left] = True
    return m


def _masks():
    """Three map shapes in all, so the interpret-mode Pallas kernels compile
    few times."""
    rng = np.random.default_rng(0)
    shape = (96, 160)
    blobs = np.zeros(shape, bool)
    for _ in range(30):
        y, x = rng.integers(0, 88), rng.integers(0, 152)
        r = int(rng.integers(2, 7))
        blobs[y : y + r, x : x + r] = True
    # components touching every border
    blobs[0, :10] = blobs[-1, -10:] = True
    blobs[:10, 0] = blobs[-10:, -1] = True
    snake_noise = snake(160, 256, 8) | (rng.random((160, 256)) < 0.15)
    return {
        "random": rng.random(shape) < 0.4,
        "blobs": blobs,
        "snake": snake(64, 64),
        "spiral": spiral(*shape),
        "snake_noise": snake_noise,
        "empty": np.zeros(shape, bool),
        "full": np.ones(shape, bool),
    }


MASKS = _masks()


def tile_masks(h, w, seed=0):
    """Masks aimed at a labeler that works in 32x32 (or 16, 64) tiles and then
    merges across tile edges: every family at (h, w).  ``holes`` is the
    border flood's real input (a class's background: one giant component
    with small holes and closed rings, some straddling tile edges)."""
    rng = np.random.default_rng(seed)
    r, c = np.indices((h, w))
    holes = rng.random((h, w)) >= 0.02
    for _ in range(max(1, h * w // 600)):
        y, x, s = int(rng.integers(0, max(h, 1))), int(rng.integers(0, max(w, 1))), int(rng.integers(3, 20))
        holes[y : y + s, x : x + s] = False
        holes[y + 1 : y + s - 1, x + 1 : x + s - 1] = True  # a closed ring
    return {
        "checkerboard": (r + c) % 2 == 0,
        "diagonal": (c - r) % 32 == 0,  # through every tile corner
        "antidiagonal": (c + r) % 32 == 31,
        "staircase": ((c - r) % 32 == 0) | ((c - r) % 32 == 1),
        "frame32": (r % 32 == 0) | (r % 32 == 31) | (c % 32 == 0) | (c % 32 == 31),
        "frame64": (r % 64 == 0) | (r % 64 == 63) | (c % 64 == 0) | (c % 64 == 63),
        "holes": holes,
        "full": np.ones((h, w), bool),
        "empty": np.zeros((h, w), bool),
    }


def _tile_masks():
    """tile_masks at 70x101 (no side a multiple of 16, 32 or 64), a single
    row and a single column, and a map with no rows."""
    rng = np.random.default_rng(11)
    return {
        **tile_masks(70, 101),
        "row": rng.random((1, 150)) < 0.7,
        "column": rng.random((150, 1)) < 0.7,
        "no_rows": np.zeros((0, 40), bool),
    }


TILE_MASKS = _tile_masks()


def seeds_like(m, seed=1):
    return np.random.default_rng(seed).random(m.shape) < 0.02


def seed_patterns(m, seed=2):
    """Seeds for a flood of ``m`` aimed at the tiled kernels: sparse, dense
    (half the map, as a whole class seeds the main path's flood), on the
    32x32 tile corners, on tile edges, and only off the mask (all ignored)."""
    rng = np.random.default_rng(seed)
    r, c = np.indices(m.shape)
    corner = np.isin(r % 32, (0, 31)) & np.isin(c % 32, (0, 31))
    edge = (r % 32 == 31) | (c % 32 == 0)
    return {
        "sparse": rng.random(m.shape) < 0.002,
        "dense": rng.random(m.shape) < 0.5,
        "corners": corner,
        "edges": edge & (rng.random(m.shape) < 0.1),
        "off_mask": ~m,
    }


def tile_class_maps(h, w, seed=0):
    """uint8 class maps aimed at the tiled kernels' same-class predicate:
    each ``tile_masks`` family as classes 1 and 2 (two classes meeting along
    every edge of the mask, so the checkerboard's classes meet only
    diagonally), classes 1 and 2 on alternate 32x32 tiles and on tiles
    shifted one pixel off the grid, classes 0-2 on tiles, and random
    classes under class-3 columns and under class-3 rows (stripes)."""
    rng = np.random.default_rng(seed)
    r, c = np.indices((h, w))
    maps = {name: np.where(m, 1, 2).astype(np.uint8) for name, m in tile_masks(h, w, seed).items()}
    col_stripes = rng.integers(0, 4, (h, w)).astype(np.uint8)
    col_stripes[:, ::2] = 3
    row_stripes = rng.integers(0, 4, (h, w)).astype(np.uint8)
    row_stripes[::2] = 3
    maps.update({
        "tiles2": (1 + (r // 32 + c // 32) % 2).astype(np.uint8),
        "tiles2_shifted": (1 + ((r + 1) // 32 + (c + 1) // 32) % 2).astype(np.uint8),
        "tiles3": ((r // 32 + c // 32) % 3).astype(np.uint8),
        "col_stripes": col_stripes,
        "row_stripes": row_stripes,
    })
    return maps


def _tile_class_maps():
    """tile_class_maps at 70x101, a single row and column, and no rows."""
    rng = np.random.default_rng(12)
    return {
        **tile_class_maps(70, 101),
        "row": rng.integers(0, 3, (1, 150)).astype(np.uint8),
        "column": rng.integers(0, 3, (150, 1)).astype(np.uint8),
        "no_rows": np.zeros((0, 40), np.uint8),
    }


TILE_CLASS_MAPS = _tile_class_maps()


def random_class_map(rng, h, w, stripes=False):
    """A 0..3 class map as tests/test_cc_multiclass.py builds it: uniform
    noise, a class-1 block touching a class-2 run, and optionally class-3
    columns (maximal fragmentation of same-class runs)."""
    cls = (rng.random((h, w)) * 4).astype(np.uint8)
    cls[5:20, 5:40] = 1
    cls[10:15, 30:60] = 2  # touching different-class runs
    if stripes:
        cls[:, ::2] = 3
    return cls


def _class_maps():
    """uint8 class maps at two shapes, (64, 96) and (120, 130)."""
    rng = np.random.default_rng(5)
    single = np.zeros((64, 96), np.uint8)
    single[10:20, 10:20] = 2
    return {
        "random": (rng.random((64, 96)) * 4).astype(np.uint8),
        "stripes": random_class_map(rng, 120, 130, stripes=True),
        "touching": random_class_map(rng, 120, 130),
        "snake_on_2": np.where(snake(64, 96, 2), 1, 2).astype(np.uint8),
        "spiral_on_2": np.where(spiral(120, 130), 1, 2).astype(np.uint8),
        "empty": np.zeros((64, 96), np.uint8),
        "single": single,
    }


CLASS_MAPS = _class_maps()
