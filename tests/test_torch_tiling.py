"""The port's tiling (ecseg_torch/ops/tiling) and B1 stitch twin against the
JAX package: patch positions, the copy plan, the exact uint8 quantize and
argmax, and the stitch against stitch_labels_pallas (interpret mode) and
stitch_labels_host -- including square geometries, where the reference's
``:242`` axis quirk drops the right rim copies."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecseg_tpu.ops import tiling as jt
from ecseg_tpu.ops.cc_pallas import stitch_labels_pallas
from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import tiling as tt

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

GEOMETRIES = [(1024, 1024), (2048, 2048), (512, 700), (256, 256), (300, 258), (462, 874), (320, 384)]


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_positions_and_plan_match(h, w):
    pos = tt.patch_positions(h, w)
    assert pos == jt.patch_positions(h, w)
    key = tuple(map(tuple, pos))
    p = np.asarray(pos)
    want = jt._stitch_plan_cached(key, jt.OVERLAP, jt.SCW, int(p[:, 0].max()), int(p[:, 1].max()))
    assert tt.stitch_plan(key) == want


def test_2048_geometry_is_100_patches_and_135_copies():
    key = tuple(map(tuple, tt.patch_positions(2048, 2048)))
    copies, H, W = tt.stitch_plan(key)
    assert (len(key), len(copies), H, W) == (100, 135, 2048, 2048)


def _ladder(rng):
    vals = [np.float32(0.0019607844296842813)]  # tiling.py:243-244
    for k in range(255):
        t = np.float32((k + 0.5) / 255.0)
        for _ in range(6):
            vals.append(t)
            t = np.nextafter(t, np.float32(0), dtype=np.float32)
        t = np.float32((k + 0.5) / 255.0)
        for _ in range(6):
            t = np.nextafter(t, np.float32(1e9), dtype=np.float32)
            vals.append(t)
    vals.extend(rng.random(4096).astype(np.float32))
    vals.extend([np.float32(0), np.float32(1), np.float32(0.5)])
    return np.asarray(vals, np.float32)


def test_quantize_matches_jax_and_host(rng):
    p = _ladder(rng)
    got = tt.quantize_u8(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, jt.img_as_ubyte_float(p))
    np.testing.assert_array_equal(got, np.asarray(jt.quantize_u8_jax(jnp.asarray(p))))


def test_patch_labels_match_jax_argmax(rng):
    """Ties in the quantized bytes take the first class, as jnp.argmax."""
    probs = rng.random((3, 16, 16, 4)).astype(np.float32)
    probs[0, :4, :4, 1] = probs[0, :4, :4, 2] = 0.99  # exact ties
    probs[1, :4, :4, 0] = np.float32(0.5)
    probs[1, :4, :4, 3] = np.nextafter(np.float32(0.5), np.float32(1))  # u8 tie
    want = np.asarray(jnp.argmax(jt.quantize_u8_jax(jnp.asarray(probs)), axis=-1))
    got = tt.patch_labels(torch.from_numpy(probs))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("h,w", [(512, 512), (462, 874), (306, 306), (320, 384), (256, 256)])
def test_stitch_twin_matches_pallas_and_host(h, w, rng):
    img = rng.integers(0, 4, size=(h, w)).astype(np.uint8)
    _, patches, pos = jt.im2patches_overlap(img[..., None])
    lp = np.ascontiguousarray(patches[..., 0])
    key = tuple(map(tuple, pos))
    want = np.asarray(stitch_labels_pallas(jnp.asarray(lp.astype(np.int32)), key))
    got = K.stitch_labels(torch.from_numpy(lp), key)
    assert got.dtype == torch.int32 and tuple(got.shape) == (h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), jt.stitch_labels_host(lp, pos))


@pytest.mark.parametrize("h,w", [(2048, 2048), (700, 900)])
def test_stitch_source_map_matches_twin(h, w, rng):
    """The B1 kernel reads the plan replayed into a per-pixel source map;
    gathering through that map on the host equals the twin's replay."""
    key = tuple(map(tuple, tt.patch_positions(h, w)))
    lp = torch.from_numpy(rng.integers(0, 4, size=(len(key), 256, 256)).astype(np.uint8))
    src = K._source_map(key, torch.device("cpu"))
    gathered = torch.where(src < 0, 0, lp.reshape(-1)[src.clamp(min=0).long()].int())
    assert torch.equal(gathered, K.stitch_plain(lp, key))
