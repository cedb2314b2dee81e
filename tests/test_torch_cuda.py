"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests import neither JAX nor ecseg_tpu, so they run on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py

Without a CUDA device each test skips (a CUDA kernel has no CPU mode); the
twins themselves are held against the JAX package on the CPU by
tests/test_torch_cc.py and tests/test_torch_tiling.py.  The kernels'
equality at 2048^2 and 2048x3072 is checked by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import tiling

from _masks import MASKS, seeds_like


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MASKS))
def test_cc_kernels_match_twins(cuda, name):
    m = torch.from_numpy(MASKS[name]).to(cuda)
    seeds = torch.from_numpy(seeds_like(MASKS[name])).to(cuda)
    for conn in (1, 2):
        assert torch.equal(K.label(m, conn), K.label_plain(m, conn))
        assert torch.equal(
            K.flood_from_seeds(m, seeds, conn), K.flood_from_seeds_plain(m, seeds, conn)
        )
    assert torch.equal(K.flood_from_border(m), K.flood_from_border_plain(m))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(2048, 2048), (462, 874), (306, 306), (2048, 3072)])
def test_stitch_kernel_matches_twin(cuda, h, w):
    key = tuple(map(tuple, tiling.patch_positions(h, w)))
    lp = torch.from_numpy(
        np.random.default_rng(h + w).integers(0, 4, size=(len(key), 256, 256)).astype(np.uint8)
    ).to(cuda)
    assert torch.equal(K.stitch_labels(lp, key), K.stitch_plain(lp, key))


@pytest.mark.cuda
def test_wrappers_check_inputs_and_count_launches(cuda):
    K.reset_launches()
    m = torch.zeros((8, 8), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        K.label(m.to(torch.uint8))
    with pytest.raises(ValueError):
        K.label(m.t()[:, :4])
    assert K.LAUNCHES == {"stitch": 0, "label": 0, "flood_border": 0, "flood_seeds": 0}
    K.label(m)
    K.flood_from_border(m)
    K.flood_from_seeds(m, m)
    assert K.LAUNCHES == {"stitch": 0, "label": 1, "flood_border": 1, "flood_seeds": 1}
