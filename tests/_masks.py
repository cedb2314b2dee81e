"""Binary test masks shared by the port's tests (no JAX import, so the
card-only tests can use them on a machine without JAX)."""

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


def seeds_like(m, seed=1):
    return np.random.default_rng(seed).random(m.shape) < 0.02
