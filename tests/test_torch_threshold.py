"""The port's device Otsu threshold (ecseg_torch/ops/threshold.py) against
the JAX package's ``otsu_threshold_tpu`` and cv2, on seeded uint8 images:
bimodal, uniform, a constant image and a two-level one; and its pixel
guard."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecseg_tpu.ops.threshold import otsu_binarize, otsu_threshold_tpu
from ecseg_torch.ops.threshold import otsu_threshold_gpu

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)


def _image(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "bimodal":
        img = np.where(rng.random(shape) < 0.4, rng.normal(60, 10, shape), rng.normal(190, 15, shape))
        return np.clip(img, 0, 255).astype(np.uint8)
    if kind == "uniform":
        return (rng.random(shape) * 255).astype(np.uint8)
    if kind == "constant":
        return np.full(shape, 37, np.uint8)
    if kind == "two_level":
        return np.where(rng.random(shape) < 0.3, 200, 20).astype(np.uint8)
    if kind == "dark_skewed":  # most pixels in a few low bins, a thin bright tail
        return np.minimum(rng.exponential(6, shape), 255).astype(np.uint8)
    raise ValueError(kind)


CASES = [
    ("bimodal", (120, 160), 0),
    ("bimodal", (200, 300), 1),
    ("uniform", (64, 64), 2),
    ("constant", (50, 50), 3),
    ("two_level", (77, 91), 4),
    ("dark_skewed", (256, 256), 5),
]


@pytest.mark.parametrize("kind,shape,seed", CASES, ids=[c[0] + str(c[2]) for c in CASES])
def test_otsu_matches_the_jax_twin_and_cv2(kind, shape, seed):
    img = _image(kind, shape, seed)
    got = otsu_threshold_gpu(torch.from_numpy(img))
    assert got.dtype == torch.int32 and got.shape == ()
    want = int(otsu_threshold_tpu(jnp.asarray(img)))
    assert int(got) == want
    t_cv, binary_cv = otsu_binarize(img)
    assert int(got) == int(t_cv)
    np.testing.assert_array_equal((img > int(got)).astype(np.uint8), binary_cv)


def test_otsu_pixel_guard():
    with pytest.raises(ValueError, match="2\\^23"):
        otsu_threshold_gpu(torch.zeros((4096, 4096), dtype=torch.uint8))
    assert int(otsu_threshold_gpu(torch.zeros((2048, 4095), dtype=torch.uint8))) == 0
