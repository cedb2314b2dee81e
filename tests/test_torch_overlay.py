"""The port's meta_overlay statistics (ecseg_torch/ops/overlay_gpu.py) and
their parts on the CPU, where the B2 and B8a wrappers run their plain
twins, against the JAX package: ``overlay_stats(device="cpu")`` against
``overlay_stats_tpu`` (interpret-mode Pallas) on the seeded masks of
tests/test_overlay_tpu.py and on empty, all-foreground and
FISH-only-on-nuclei masks; the colocalization and HSR counts and the
device and host ``remove_small_objects`` against their JAX counterparts;
the port's host oracles against the JAX package's.  Exact equality
everywhere: every output is an integer."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecseg_tpu.ops import meta_post as jax_meta_post
from ecseg_tpu.ops import morphology as jax_morph
from ecseg_tpu.ops.morphology_tpu import remove_small_objects_tpu
from ecseg_tpu.ops.overlay_tpu import (
    cc_pair_host_quirk as jax_quirk,
    count_HSR_tpu,
    count_colocalization_tpu,
    overlay_stats_tpu,
)
from ecseg_torch.ops import meta_post, morphology, morphology_gpu, overlay_gpu

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

SHAPE = (96, 128)  # one shape, so the interpret-mode JAX program compiles once


def _masks(rng, shape=SHAPE):
    """tests/test_overlay_tpu.py:17-28: red, green, and the nuclei,
    chromosome and ecDNA masks of a label map with carved blobs."""
    red = rng.random(shape) < 0.15
    green = rng.random(shape) < 0.15
    seg = (rng.random(shape) * 4).astype(int)
    for lab in (1, 2, 3):
        for _ in range(12):
            y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
            r = int(rng.integers(2, 8))
            seg[y : y + r, x : x + r] = lab
    return red, green, seg == 1, seg == 2, seg == 3


def _blobby(rng, shape=SHAPE):
    """Masks with large blobs, so the HSR size filter keeps some FISH and
    the chromosomes hold it."""
    red, green, nuclei, chrom, ec = (np.zeros(shape, bool) for _ in range(5))
    for m, n, lo, hi in ((red, 20, 2, 9), (green, 20, 2, 9), (nuclei, 4, 8, 20), (chrom, 8, 6, 24), (ec, 25, 1, 4)):
        for _ in range(n):
            y, x = rng.integers(0, shape[0] - 4), rng.integers(0, shape[1] - 4)
            m[y : y + int(rng.integers(lo, hi)), x : x + int(rng.integers(lo, hi))] = True
    return red, green, nuclei, chrom & ~nuclei, ec & ~nuclei & ~chrom


def _cases():
    z, o = np.zeros(SHAPE, bool), np.ones(SHAPE, bool)
    cases = {f"seed{k}": _masks(np.random.default_rng(k)) for k in range(3)}
    cases.update({f"blobs{k}": _blobby(np.random.default_rng(10 + k)) for k in range(2)})
    cases["empty"] = (z, z, z, z, z)
    cases["all_foreground"] = (o, o, z, o, o)
    cases["fish_only_on_nuclei"] = _masks(np.random.default_rng(7))[:2] + (o, z, np.eye(*SHAPE, dtype=bool))
    return cases


CASES = _cases()


def _jax_stats(masks, t=20):
    out = jax.device_get(overlay_stats_tpu(*(jnp.asarray(m) for m in masks), t))
    return {k: tuple(int(x) for x in v) if isinstance(v, tuple) else int(v) for k, v in out.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_overlay_stats_match_the_jax_program(case):
    masks = CASES[case]
    got = overlay_gpu.overlay_stats(*masks, 20, device="cpu")
    assert got == _jax_stats(masks)
    hw = SHAPE[0] * SHAPE[1]
    for key in ("num_ecDNA", "num_FISH", "num_FISH2"):
        assert overlay_gpu.cc_pair_host_quirk(got[key], hw) == jax_quirk(got[key], hw)


def test_overlay_stats_hsr_counts_are_not_all_zero():
    """The blob cases reach the HSR statistics' nonzero branch."""
    got = [overlay_gpu.overlay_stats(*CASES[c], 20, device="cpu") for c in ("blobs0", "blobs1")]
    assert any(g["num_HSR"] > 0 for g in got) and any(g["num_HSR2"] > 0 for g in got)


def test_overlay_stats_without_a_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        overlay_gpu.overlay_stats(*CASES["empty"])


@pytest.mark.parametrize("case", ["seed0", "blobs0", "all_foreground", "empty"])
def test_colocalization_and_hsr_match_jax(case):
    red, green, nuclei, chrom, ec = CASES[case]
    fish = green & ~nuclei
    for a, b in ((ec, fish), (chrom, red), (fish, red & ~chrom)):
        want = int(count_colocalization_tpu(jnp.asarray(a), jnp.asarray(b)))
        assert int(overlay_gpu.count_colocalization(torch.from_numpy(a), torch.from_numpy(b))) == want
        assert meta_post.count_colocalization(a, b) == jax_meta_post.count_colocalization(a, b) == want
    for f in (fish, red & ~nuclei):
        want = int(count_HSR_tpu(jnp.asarray(chrom), jnp.asarray(f), 20))
        assert int(overlay_gpu.count_HSR(torch.from_numpy(chrom), torch.from_numpy(f), 20)) == want
        assert meta_post.count_HSR(chrom, f, 20) == jax_meta_post.count_HSR(chrom, f, 20) == want


def test_count_cc_pair_matches_the_host_count():
    from ecseg_tpu.ops.cc import count_cc

    for masks in CASES.values():
        for m in masks:
            pair = tuple(int(v) for v in overlay_gpu.count_cc_pair(torch.from_numpy(m)))
            assert overlay_gpu.cc_pair_host_quirk(pair, m.size) == count_cc(m)


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("min_size", [1, 20, 21])
def test_remove_small_objects_matches_jax(conn, min_size):
    """The device form (B2's twin + a size count) and the host form (scipy)
    against ``remove_small_objects_tpu`` and the JAX host form, on the
    blob cases' FISH masks and a random mask."""
    rng = np.random.default_rng(3)
    masks = [CASES["blobs0"][0], CASES["blobs1"][1], rng.random(SHAPE) < 0.4]
    for m in masks:
        want = np.asarray(remove_small_objects_tpu(jnp.asarray(m), min_size, connectivity=conn))
        got = morphology_gpu.remove_small_objects(torch.from_numpy(m), min_size, connectivity=conn)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(morphology.remove_small_objects(m, min_size, conn), want)
        np.testing.assert_array_equal(jax_morph.remove_small_objects(m, min_size, conn), want)


def test_overlapping_labels_keeps_the_first_unique_quirk():
    """``np.unique(labels)[1:]`` drops the first label whatever it is: an
    all-foreground map's one component is never counted."""
    labels = np.ones((4, 5), np.int32)
    other = np.zeros((4, 5), bool)
    other[1, 1] = True
    assert meta_post._count_overlapping_labels(labels, other) == 0
    labels[0, 0] = 0
    assert meta_post._count_overlapping_labels(labels, other) == 1
    with pytest.raises(TypeError):
        meta_post._count_overlapping_labels(labels, other.astype(np.float32))
