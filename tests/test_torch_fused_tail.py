"""The port's B10 twin (ecseg_torch/ops/fused_tail.fused_dec1_head on CPU
tensors) against ``ecseg_tpu.ops.fused_tail.fused_dec1_head`` (interpret
mode on the CPU), as tests/test_fused_tail.py holds that kernel against the
XLA chain: with integer-valued float32 inputs and weights every sum is
exact in any order, so the labels must be equal; with random bf16 inputs
the two sum each conv in another order, a bf16 rounding of dec1_1/dec1_2 or
a quantize tie can then flip, and >= 99.99 % of the labels must agree.  The
CUDA kernel is held against the twin on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecseg_tpu.ops import fused_tail as jft
from ecseg_torch.ops import fused_tail as tft

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)


def _case(integer, c1=64, c2=32, ncls=4, n=1, seed=3):
    rng = np.random.default_rng(seed)
    if integer:
        mk = lambda *s: rng.integers(-2, 3, s).astype(np.float32)
        x = rng.integers(0, 3, (n, 256, 256, c1)).astype(np.float32)
    else:
        mk = lambda *s: (rng.standard_normal(s) * 0.2).astype(np.float32)
        x = (rng.random((n, 256, 256, c1)) * 0.5).astype(np.float32)
    return [x, mk(3, 3, c1, c2), mk(c2), mk(3, 3, c2, c2), mk(c2), mk(1, 1, c2, ncls), mk(ncls)]


def _both(args, dtype):
    jx = [jnp.asarray(args[0]).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)]
    want = np.asarray(jft.fused_dec1_head(*jx, *map(jnp.asarray, args[1:])))
    tx = [torch.from_numpy(args[0]).to(dtype)]
    got = tft.fused_dec1_head(*tx, *map(torch.from_numpy, args[1:]))
    assert got.dtype == torch.int32 and got.shape == want.shape
    return got.numpy(), want


def test_twin_equals_jax_on_integer_inputs():
    got, want = _both(_case(True), torch.float32)
    np.testing.assert_array_equal(got, want)


def test_twin_agrees_with_jax_on_random_bf16():
    got, want = _both(_case(False, seed=4), torch.bfloat16)
    assert (got == want).mean() >= 0.9999  # measured 1.0 here, 0.99998 on seeds 5 and 6


@pytest.mark.parametrize("c1,c2,ncls", [(128, 64, 4), (10, 12, 3)])
def test_twin_equals_jax_at_other_widths(c1, c2, ncls):
    """The XL widths, and widths off the kernel's 8-channel group (the
    wrapper pads them with zero weights), integer-valued."""
    got, want = _both(_case(True, c1, c2, ncls, seed=c1), torch.float32)
    np.testing.assert_array_equal(got, want)


def test_smem_per_block():
    """The kernel's tile choice: 16x16 output tiles fit a block's shared
    memory for bf16 at both widths and float32 at c1 = 64; float32 at
    c1 = 128 falls back to 8x8 tiles."""
    assert tft.smem_bytes(64, 32, 2) == (20 * 20 * 66 + 18 * 18 * 34) * 2
    assert tft.smem_bytes(128, 64, 2) <= tft.SMEM_LIMIT
    assert tft.smem_bytes(64, 32, 4) <= tft.SMEM_LIMIT
    assert tft.smem_bytes(128, 64, 4) > tft.SMEM_LIMIT >= tft.smem_bytes(128, 64, 4, tile=8)
