"""The tile-count path (ecseg_torch/pipelines/tile_count.py) as a whole
against the JAX per-tile program that ``bench.py`` times, composed from the
package as ``bench.py:118-142`` composes it (``tile_fn``, vmapped over the
tiles), unfused and fused-tail, at narrow widths on bench-recipe 1024^2
tiles; the tile recipe against bench's bytes; the realistic-weight surgery
against ``bench._realistic_params``.

The Pallas kernels run in interpret mode here; the JAX fused tail pads its
channels to 128 lanes and costs about a second a patch on one core, so the
fused variant is compared on one tile (25 patches) and the unfused one on
two.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
from ecseg_tpu.models import metaseg_unet as ju
from ecseg_tpu.ops import tiling as jt
from ecseg_tpu.ops.cc_pallas import count_cc_from_patches
from ecseg_tpu.ops.fused_tail import fused_dec1_head
from ecseg_torch.models.weights import params_from_numpy, params_to_numpy
from ecseg_torch.pipelines import tile_count

from _torchutil import bench_realistic_params, single_torch_thread  # noqa: F401 (autouse fixture)

WIDTHS, BOTT = (4, 8), 16


def _bench_tiles(n, seed):
    """bench.py:207-215, copied (bench.build also builds 192 tiles)."""
    h = w = 1024
    rng = np.random.default_rng(seed)
    tiles = (rng.random((n, h, w)) * 80).astype(np.uint8)
    for b in range(n):
        for _ in range(120):
            y, x = rng.integers(0, h - 12), rng.integers(0, w - 12)
            r = rng.integers(2, 7)
            tiles[b, y : y + r, x : x + r] = 230
    return tiles


def _jax_program(params, patches, positions, fused_tail):
    """bench.py's tile_fn returning (num_ec, px), vmapped over the tiles."""

    def tile_fn(patches):
        if fused_tail:
            xcat = ju.forward_cat1(params, patches, dtype=jnp.bfloat16)
            labels = fused_dec1_head(
                xcat,
                params["dec1_1"]["kernel"], params["dec1_1"]["bias"],
                params["dec1_2"]["kernel"], params["dec1_2"]["bias"],
                params["head"]["kernel"], params["head"]["bias"],
            )
        else:
            probs = ju.forward(params, patches, dtype=jnp.bfloat16)
            labels = jnp.argmax(jt.quantize_u8_jax(probs), -1).astype(jnp.int32)
        return count_cc_from_patches(labels, positions, class_id=3)

    n, px = jax.jit(jax.vmap(tile_fn))(jnp.asarray(patches))
    return np.asarray(n), np.asarray(px)


@pytest.fixture(scope="module")
def bench_case():
    params = bench_realistic_params(WIDTHS, BOTT)
    model = params_from_numpy(jax.tree.map(np.asarray, params)).to(torch.bfloat16).eval()
    patches, positions = tile_count.tile_patches(tile_count.synthetic_tiles(2))
    return params, model, patches, positions


@pytest.mark.parametrize("fused_tail", [False, True], ids=["unfused", "fused_tail"])
def test_count_tiles_matches_the_jax_program(bench_case, fused_tail):
    params, model, patches, positions = bench_case
    if fused_tail:
        patches = patches[:1]
    want_n, want_px = _jax_program(params, patches, positions, fused_tail)
    got_n, got_px = tile_count.count_tiles(model, torch.from_numpy(patches), positions, fused_tail)
    assert got_n.dtype == torch.int32 and got_n.shape == (len(patches),)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(got_px.numpy(), want_px)
    assert (want_n > 10).all()  # bench's validity check (bench.py:234)


@pytest.mark.parametrize("n,seed", [(1, 0), (3, 0), (2, 5)])
def test_synthetic_tiles_are_bench_bytes(n, seed):
    np.testing.assert_array_equal(tile_count.synthetic_tiles(n, seed), _bench_tiles(n, seed))


def test_tile_patches_match_jax_im2patches():
    tiles = tile_count.synthetic_tiles(1, 3)
    patches, positions = tile_count.tile_patches(tiles)
    _, want, want_pos = jt.im2patches_overlap(tiles[0][..., None])
    assert patches.shape == (1, 25, 256, 256, 1)
    np.testing.assert_array_equal(patches[0], want)
    assert list(positions) == [tuple(p) for p in want_pos]


@pytest.mark.parametrize("arch", ["default", "xl"])
def test_realistic_model_has_bench_surgery(monkeypatch, arch):
    """The shapes at the arch's widths; the crafted layers' values (the same
    surgery at any width) at the narrow widths of the tests above, where
    ``bench._realistic_params`` is cheap on the CPU."""
    widths, bott, _ = tile_count.ARCHS[arch]
    want = jax.eval_shape(lambda k: bench._realistic_params(k, widths, bott), jax.random.PRNGKey(0))
    model = tile_count.realistic_model(arch, torch.Generator().manual_seed(0))
    assert model.dtype == torch.bfloat16
    got = params_to_numpy(model.float())
    assert {n: v["kernel"].shape for n, v in got.items()} == {n: tuple(v["kernel"].shape) for n, v in want.items()}
    if arch == "default":
        monkeypatch.setitem(tile_count.ARCHS, "default", (WIDTHS, BOTT, 1))
        got = params_to_numpy(tile_count.realistic_model(arch, torch.Generator().manual_seed(0)).float())
        crafted = bench_realistic_params(WIDTHS, BOTT)
        for name in ("enc1_1", "enc1_2", "dec1_1", "dec1_2", "head"):
            for k in ("kernel", "bias"):
                np.testing.assert_array_equal(got[name][k], np.asarray(crafted[name][k]).astype(np.float32))


def test_run_on_the_cpu_at_narrow_widths(monkeypatch):
    monkeypatch.setitem(tile_count.ARCHS, "default", (WIDTHS, BOTT, 1))
    counts, px = tile_count.run(device="cpu")
    assert counts.shape == px.shape == (1,)
    assert counts[0] > 10 and px[0] > counts[0]
    fused = tile_count.run(fused_tail=True, device="cpu")
    np.testing.assert_array_equal(fused[0], counts)
    np.testing.assert_array_equal(fused[1], px)


def test_run_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tile_count.run(n_tiles=1)
