"""The port's B5, B6 and B9 plain twins (ecseg_torch/ops/cc_kernels) against
the JAX Pallas entry points they stand in for -- label_multiclass_pallas,
flood_multiclass_pallas and label_and_flood_pallas (interpret mode on the
CPU) -- on the class maps of tests/test_cc_multiclass.py (random, stripes,
touching classes, empty, single class) and a class-1 snake and spiral on
class 2.  The CUDA kernels themselves are held against these twins on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

# imported at collection for the reason tests/test_torch_cc.py gives
from ecseg_tpu.ops import cc_pallas_banded  # noqa: F401
from ecseg_tpu.ops.cc_pallas import (
    flood_multiclass_pallas,
    label_and_flood_pallas,
    label_multiclass_pallas,
)
from ecseg_torch.ops import cc_kernels as K

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

from _masks import CLASS_MAPS, seeds_like


def _jax_cls(cls):
    return jnp.asarray(cls.astype(np.int32))


@pytest.mark.parametrize("name", sorted(CLASS_MAPS))
def test_label_multiclass_twin_matches_pallas(name):
    cls = CLASS_MAPS[name]
    want = np.asarray(label_multiclass_pallas(_jax_cls(cls)))
    got = K.label_multiclass(torch.from_numpy(cls))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CLASS_MAPS))
def test_flood_multiclass_twin_matches_pallas(name):
    cls = CLASS_MAPS[name]
    seeds = seeds_like(cls)  # some seeds fall on class 0
    want = np.asarray(flood_multiclass_pallas(_jax_cls(cls), jnp.asarray(seeds)))
    got = K.flood_multiclass(torch.from_numpy(cls), torch.from_numpy(seeds))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", sorted(CLASS_MAPS))
def test_label_and_flood_twin_matches_pallas(name, conn):
    m = CLASS_MAPS[name] % 2 == 1  # classes 1 and 3
    seeds = seeds_like(m, seed=2)
    want_lab, want_fl = label_and_flood_pallas(jnp.asarray(m), jnp.asarray(seeds), connectivity=conn)
    lab, fl = K.label_and_flood(torch.from_numpy(m), torch.from_numpy(seeds), conn)
    assert lab.dtype == torch.int32 and fl.dtype == torch.bool
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    np.testing.assert_array_equal(fl.numpy(), np.asarray(want_fl))


def test_multiclass_flood_stays_in_its_class():
    """A seed floods its own class's component only: touching pixels of
    another class stay dry, and a seed on class 0 floods nothing."""
    cls = np.zeros((6, 8), np.uint8)
    cls[1:5, 1:4] = 1
    cls[1:5, 4:7] = 2  # touches the class-1 block along a column
    seeds = np.zeros(cls.shape, bool)
    seeds[2, 2] = True  # on class 1
    seeds[0, 0] = True  # on class 0
    got = K.flood_multiclass(torch.from_numpy(cls), torch.from_numpy(seeds)).numpy()
    np.testing.assert_array_equal(got, cls == 1)
    lab = K.label_multiclass(torch.from_numpy(cls)).numpy()
    np.testing.assert_array_equal(lab, np.select([cls == 1, cls == 2], [1 * 8 + 1, 1 * 8 + 4], -1))

