"""The port's device meta_inference (ecseg_torch/ops/meta_post_gpu, per-class
form, run on the CPU through the B2-B4 twins) against the JAX device twin
meta_inference_tpu and the host oracle, on the cases of
tests/test_meta_post_tpu.py; and the port's host oracle copy against the
JAX one.  The host oracle is the authority: the port's ``ok`` is False only
on a component-budget overflow and its output always equals the oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecseg_tpu.ops.cc import count_cc as jax_count_cc
from ecseg_tpu.ops.meta_post import meta_inference as jax_oracle
from ecseg_tpu.ops.meta_post_tpu import meta_inference_tpu
from ecseg_torch.ops.cc import count_cc
from ecseg_torch.ops.meta_post import meta_inference as port_oracle
from ecseg_torch.ops.meta_post_gpu import count_roots_gpu, meta_inference_gpu

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)


def _random_label_map(rng, shape=(180, 220)):
    img = np.zeros(shape, np.int64)
    for lab, n, rmax in [(1, 4, 28), (2, 14, 9), (3, 25, 4)]:
        for _ in range(n):
            y, x = rng.integers(0, shape[0] - 4), rng.integers(0, shape[1] - 4)
            r = int(rng.integers(2, rmax))
            img[y : y + r, x : x + r] = lab
    return img


def _metaphase_spread():
    img = np.zeros((256, 256), np.int64)
    img[118:138, 118:138] = 1
    rng = np.random.default_rng(3)
    for _ in range(40):
        y, x = 128 + int(rng.integers(-60, 60)), 128 + int(rng.integers(-60, 60))
        img[y : y + 4, x : x + 4] = 2
    return img


def _touching(seed):
    img = _random_label_map(np.random.default_rng(seed), shape=(150, 170))
    img[20:26, 20:30] = 2
    img[26:30, 24:28] = 3
    return img


def _degenerate():
    h, w = 96, 128
    a = np.zeros((h, w), np.int64)
    a[10:40, 10:40] = 1
    a[50:54, 50:54] = 3
    b = np.zeros((h, w), np.int64)
    b[10:30, 10:30] = 2
    b[40:80, 60:100] = 1
    return {
        "empty": np.zeros((h, w), np.int64),
        "all_nuclei": np.full((h, w), 1, np.int64),
        "all_ec": np.full((h, w), 3, np.int64),
        "nuclei_no_chrom": a,
        "chrom_no_ec": b,
    }


def _near_tie():
    img = np.zeros((96, 128), np.int64)
    img[10, 10] = img[11, 10] = img[10, 11] = 1  # nucleus, x mean 31/3
    img[40, 80] = img[41, 80] = img[40, 81] = 2  # chrom, x mean 241/3
    return img


def _dyadic_edge():
    img = np.zeros((96, 128), np.int64)
    img[10:13, 10:13] = 1
    img[40:43, 80:83] = 2
    return img


CASES = {
    **{f"random{k}": _random_label_map(np.random.default_rng(100 + k)) for k in range(3)},
    **_degenerate(),
    "metaphase_spread": _metaphase_spread(),
    **{f"touching{k}": _touching(k) for k in range(2)},
    "near_tie": _near_tie(),
    "dyadic_edge": _dyadic_edge(),
}


def _port(img):
    out, ok = meta_inference_gpu(torch.from_numpy(img))
    assert out.dtype == torch.int64
    return out.numpy(), bool(ok)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_host_oracles(name):
    img = CASES[name]
    want = jax_oracle(img.copy())
    np.testing.assert_array_equal(port_oracle(img.copy()), want)
    out, ok = _port(img)
    assert ok
    np.testing.assert_array_equal(out, want)


# two map shapes, so the JAX twin compiles twice
@pytest.mark.parametrize("name", ["random0", "random1", "all_ec", "nuclei_no_chrom", "dyadic_edge"])
def test_matches_jax_device_twin(name):
    img = CASES[name]
    jout, jok = meta_inference_tpu(jnp.asarray(img))
    out, ok = _port(img)
    assert bool(jok) and ok
    np.testing.assert_array_equal(out, np.asarray(jout).astype(np.int64))


def test_metaphase_branch_removes_the_nucleus():
    img = CASES["metaphase_spread"]
    out, _ = _port(img)
    assert (out == 1).sum() < (img == 1).sum()


def test_near_tie_needs_no_host_redo():
    """JAX's exact-integer device twin cannot tell how the oracle's float64
    rounding resolves this exact 70-px gap and asks for a host redo; the port
    computes the oracle's float64 centroids and keeps ``ok``."""
    img = CASES["near_tie"]
    _, jok = meta_inference_tpu(jnp.asarray(img))
    assert not bool(jok)
    out, ok = _port(img)
    assert ok
    np.testing.assert_array_equal(out, jax_oracle(img.copy()))


def test_budget_overflow_lowers_ok():
    img = np.zeros((96, 128), np.int64)
    img[::2, ::2] = 2  # 3072 single-pixel chromosomes > MAX_CHROM
    _, ok = _port(img)
    assert not ok
    _, jok = meta_inference_tpu(jnp.asarray(img))
    assert not bool(jok)


def test_count_roots_matches_count_cc(rng):
    for density in (0.05, 0.2, 0.5):
        m = rng.random((90, 130)) < density
        n = int(count_roots_gpu(torch.from_numpy(m)))
        assert n == count_cc(m)[0] == jax_count_cc(m)[0]
    assert int(count_roots_gpu(torch.zeros((40, 40), dtype=torch.bool))) == 0
    assert int(count_roots_gpu(torch.ones((40, 40), dtype=torch.bool))) == 1


def test_count_cc_copy_keeps_reference_tuple_quirks():
    for m in (np.zeros((8, 8), bool), np.ones((8, 8), bool), np.eye(8, dtype=bool)):
        assert count_cc(m) == jax_count_cc(m)
        assert type(count_cc(m)[1]) is type(jax_count_cc(m)[1])
