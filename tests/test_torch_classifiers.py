"""The port's interseg classifiers (ecseg_torch/models/classifiers.py)
against the JAX package's ``ecseg_i_forward`` / ``ecseg_c_forward`` at the
published widths, on the same seeded batches and the same weights (each JAX
tree through an npz and the weight bridge): the JAX init's trees
(``PRNGKey(1)``/``(2)``) and the crafted demo trees.  Tolerance:
probabilities within 1e-5 absolute; ecSeg-i's argmax and ecSeg-c's ``> 0.5``
equal.  Also: the port's demo trees equal the JAX ones bit for bit, and a
row's output does not depend on its batch (N = 1, 3 and 9)."""

import jax
import numpy as np
import pytest
import torch

from ecseg_tpu.models import classifiers as jc
from ecseg_tpu.models import demo as jdemo
from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_torch.models import demo as tdemo
from ecseg_torch.models.classifiers import EcsegC, EcsegI
from ecseg_torch.models.weights import classifier_from_numpy, load_npz, tree_from_modules

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

PROB_ATOL = 1e-5


def _patches(rng, n):
    """(n, 256, 256) uint8: uniform noise up to a level per patch (pooled
    brightness from ~0.04 to ~0.98) and sparse bright dots on black."""
    levels = [10, 60, 120, 200, 250, 30, 90, 160, 230]
    out = np.zeros((n, 256, 256), np.uint8)
    for k in range(n):
        if k % 4 == 3:
            idx = rng.integers(0, 256, (40, 2))
            out[k, idx[:, 0], idx[:, 1]] = 255
        else:
            out[k] = rng.integers(0, levels[k % len(levels)] + 1, (256, 256))
    return out


def _c_inputs(rng, n):
    """(n, 256, 256, 3) float32 in 1/255 steps, as ``preprocess_ecseg_c``
    gives them: a per-patch level in channel 0."""
    x = np.stack([_patches(rng, n), _patches(rng, n)[::-1], rng.integers(0, 256, (n, 256, 256))], axis=-1)
    return (x.astype(np.float32) / 255).astype(np.float32)


def _via_npz(tmp_path, tree, name):
    path = str(tmp_path / f"{name}.npz")
    save_npz_pytree(path, tree)
    return classifier_from_numpy(load_npz(path)).eval()


def _trees(kind):
    if kind == "init":
        return jc.init_ecseg_i_params(jax.random.PRNGKey(1)), jc.init_ecseg_c_params(jax.random.PRNGKey(2))
    return jdemo.demo_ecseg_i_params(), jdemo.demo_ecseg_c_params()


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(11)
    return _patches(rng, 9), _c_inputs(rng, 9)


@pytest.mark.parametrize("kind", ["init", "demo"])
def test_classifiers_match_jax_forwards(tmp_path, batches, kind):
    xi, xc = batches
    ti, tcc = _trees(kind)
    mi, mc = _via_npz(tmp_path, ti, "interseg"), _via_npz(tmp_path, tcc, "ecseg_c")
    assert isinstance(mi, EcsegI) and isinstance(mc, EcsegC)
    with torch.no_grad():
        pi, pc = mi(torch.from_numpy(xi)).numpy(), mc(torch.from_numpy(xc)).numpy()
    want_i, want_c = np.asarray(jc.ecseg_i_forward(ti, xi)), np.asarray(jc.ecseg_c_forward(tcc, xc))
    assert pi.shape == (9, 3) and pc.shape == (9, 1) and pi.dtype == pc.dtype == np.float32
    np.testing.assert_allclose(pi, want_i, rtol=0, atol=PROB_ATOL)
    np.testing.assert_allclose(pc, want_c, rtol=0, atol=PROB_ATOL)
    assert np.array_equal(pi.argmax(-1), want_i.argmax(-1))
    assert np.array_equal(pc > 0.5, want_c > 0.5)
    if kind == "demo":  # the crafted heads reach every label
        assert set(pi.argmax(-1)) == {0, 1, 2} and set((pc[:, 0] > 0.5).tolist()) == {True, False}


def test_demo_trees_equal_jax_bit_for_bit():
    for ours, theirs in ((tdemo.demo_ecseg_i_tree(), jdemo.demo_ecseg_i_params()), (tdemo.demo_ecseg_c_tree(), jdemo.demo_ecseg_c_params())):
        assert sorted(ours) == sorted(theirs)
        for layer in ours:
            assert sorted(ours[layer]) == sorted(theirs[layer])
            for key, a in ours[layer].items():
                b = np.asarray(theirs[layer][key])
                assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), (layer, key)


def test_rows_do_not_depend_on_the_batch(batches):
    """Batches of 1 and 3 give the rows of the batch of 9: labels equal,
    probabilities within the tolerance (interseg sends each image's crops
    as one batch, unpadded)."""
    xi, xc = batches
    mi, mc = classifier_from_numpy(tdemo.demo_ecseg_i_tree()).eval(), EcsegC(torch.Generator().manual_seed(2)).eval()
    with torch.no_grad():
        for model, x in ((mi, xi), (mc, xc)):
            full = model(torch.from_numpy(x)).numpy()
            for n in (1, 3):
                rows = [model(torch.from_numpy(x[k : k + n])).numpy() for k in range(0, 9, n)]
                part = np.concatenate(rows)
                np.testing.assert_allclose(part, full, rtol=0, atol=PROB_ATOL)
                assert np.array_equal(part.argmax(-1), full.argmax(-1)) and np.array_equal(part > 0.5, full > 0.5)


def test_bridge_round_trips_the_modules():
    m = EcsegI(torch.Generator().manual_seed(4))
    back = classifier_from_numpy(tree_from_modules(m))
    for a, b in zip(m.state_dict().values(), back.state_dict().values()):
        assert torch.equal(a, b)
    assert tree_from_modules(m)["head"]["kernel"].shape == (256, 3)
