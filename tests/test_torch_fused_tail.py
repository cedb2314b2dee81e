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
    """The kernels' tile choice.  bf16 (tensor cores): 16x16 output tiles
    at both widths and at (10, 12), whose input, dec1_1 and dec1_2 tiles
    (pixels padded by 8 bf16) and two weight stages fit a block's shared
    memory, two blocks a SM at the default widths; float32 (CUDA cores):
    16x16 at c1 = 64, 8x8 at c1 = 128."""
    plan = tft.mma_plan(64, 32)
    tile, smem = tft.mma_tile(plan)
    assert (tile, smem) == (16, 2 * (20 * 20 * 72 + (18 * 18 + 16 * 16) * 40 + 2 * 32 * 64) + 128)
    assert 2 * (smem + 1024) <= 233472  # two blocks a SM (228 KB, 1 KB reserved per block)
    for c1, c2 in [(128, 64), (10, 12)]:
        tile, smem = tft.mma_tile(tft.mma_plan(c1, c2))
        assert tile == 16 and smem <= tft.SMEM_LIMIT
    assert tft.smem_bytes(64, 32, 4) <= tft.SMEM_LIMIT
    assert tft.smem_bytes(128, 64, 4) > tft.SMEM_LIMIT >= tft.smem_bytes(128, 64, 4, tile=8)

def _from_canonical(flat, n, k):
    """The (n, k) matrix back from ``fused_tail._canonical``'s layout."""
    return flat.reshape(k // 8, n // 8, 8, 8).permute(1, 2, 0, 3).reshape(n, k)


def _unsteps(flat, cp, c2p, kc, u, nc):
    """One conv's packed steps (``fused_tail._steps``) back to (9, cp, c2p)."""
    groups, pos = [], 0
    for _ in range(c2p // nc):
        steps = []
        for nu in [len(c) for c in torch.arange(9 * (cp // kc)).split(u)]:
            block = _from_canonical(flat[pos : pos + nc * nu * kc], nc, nu * kc)
            steps.append(block.reshape(nc, nu, kc).permute(1, 2, 0))  # (nu, kc, nc)
            pos += nc * nu * kc
        groups.append(torch.cat(steps))  # (units, kc, nc)
    return torch.cat(groups, dim=2).reshape(9, cp, c2p)


def _unpack(packed, plan, c1, c2):
    """``pack_mma_weights``'s output back to the HWIO (w1, w2)."""
    c1p, c2p, nc = plan["c1p"], plan["c2p"], plan["nc"]
    n1 = 9 * c1p * c2p
    w1 = _unsteps(packed[:n1], c1p, c2p, plan["kc1"], plan["u1"], nc)
    w2 = _unsteps(packed[n1:], c2p, c2p, plan["kc2"], plan["u2"], nc)
    return w1.reshape(3, 3, c1p, c2p)[:, :, :c1, :c2], w2.reshape(3, 3, c2p, c2p)[:, :, :c2, :c2]


PLANS = [(64, 32), (128, 64), (10, 12), (200, 100)]


@pytest.mark.parametrize("c1,c2", PLANS)
def test_packed_weights_unpack_to_hwio(c1, c2):
    """The bf16 kernel's weight steps (n-groups, (tap, k-chunk) units, up
    to ``u`` units a step, each step's (nc, K) matrix in wgmma's canonical
    layout) hold every HWIO weight once and unpack back to it."""
    rng = np.random.default_rng(c1 * c2)
    w1 = torch.from_numpy(rng.standard_normal((3, 3, c1, c2)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((3, 3, c2, c2)).astype(np.float32))
    plan = tft.mma_plan(c1, c2)
    packed = tft.pack_mma_weights(w1, w2, plan)
    assert packed.numel() == 9 * plan["c2p"] * (plan["c1p"] + plan["c2p"])
    got1, got2 = _unpack(packed, plan, c1, c2)
    assert torch.equal(got1, w1) and torch.equal(got2, w2)


def test_packed_step_is_canonical():
    """dec1_1's first step at the default widths (one tap, 64 channels, 32
    outputs): weight (k, n) of tap 0 sits in core matrix (k // 8, n // 8) at
    index (k // 8) * (nc // 8) + n // 8, row n % 8, column k % 8."""
    plan = tft.mma_plan(64, 32)
    assert (plan["nc"], plan["kc1"], plan["u1"], plan["kc2"], plan["u2"]) == (32, 64, 1, 32, 2)
    w1 = torch.arange(9 * 64 * 32, dtype=torch.float32).reshape(3, 3, 64, 32)
    packed = tft.pack_mma_weights(w1, torch.zeros(3, 3, 32, 32), plan)
    for k, n in [(0, 0), (5, 3), (9, 17), (63, 31)]:
        assert packed[((k // 8) * 4 + n // 8) * 64 + (n % 8) * 8 + k % 8] == w1[0, 0, k, n]


def _emulate_conv(src, packed, cp, kc, u, plan, side_out):
    """The kernel's step schedule in torch: for each n-group and step, the
    step's units (tap-major (tap, k-chunk)) shift the (side_out + 2)^2
    source grid by the tap and multiply its k-chunk by the step's matrix
    (unpacked from the canonical layout); float64 sums."""
    nc, c2p = plan["nc"], plan["c2p"]
    units = 9 * (cp // kc)
    out = torch.zeros(side_out, side_out, c2p, dtype=torch.float64)
    pos = 0
    for g in range(c2p // nc):
        for u0 in range(0, units, u):
            nu = min(u, units - u0)
            m = _from_canonical(packed[pos : pos + nc * nu * kc], nc, nu * kc).double()
            pos += nc * nu * kc
            for v in range(nu):
                tap, ch = divmod(u0 + v, cp // kc)
                a = src[tap // 3 : tap // 3 + side_out, tap % 3 : tap % 3 + side_out, ch * kc : (ch + 1) * kc]
                out[..., g * nc : (g + 1) * nc] += a.double() @ m[:, v * kc : (v + 1) * kc].T
    return out, pos


@pytest.mark.parametrize("c1,c2", PLANS)
def test_step_schedule_computes_the_convs(c1, c2):
    """Both convs of one 16x16 tile through the packed steps as the kernel
    walks them equal ``F.conv2d`` on the zero-padded tile (integer values,
    exact)."""
    rng = np.random.default_rng(c1 + c2)
    plan = tft.mma_plan(c1, c2)
    w1 = torch.from_numpy(rng.integers(-2, 3, (3, 3, c1, c2)).astype(np.float32))
    w2 = torch.from_numpy(rng.integers(-2, 3, (3, 3, c2, c2)).astype(np.float32))
    packed = tft.pack_mma_weights(w1, w2, plan)
    x = torch.from_numpy(rng.integers(0, 3, (20, 20, c1)).astype(np.float32))
    xp = tft._pad_to(x, 2, plan["c1p"])
    mid, n1 = _emulate_conv(xp, packed, plan["c1p"], plan["kc1"], plan["u1"], plan, 18)
    want = torch.nn.functional.conv2d(x.permute(2, 0, 1)[None].double(), w1.permute(3, 2, 0, 1).double())[0].permute(1, 2, 0)
    assert torch.equal(mid[..., :c2], want) and not mid[..., c2:].any()
    o2, n2 = _emulate_conv(mid, packed[n1:], plan["c2p"], plan["kc2"], plan["u2"], plan, 16)
    want2 = torch.nn.functional.conv2d(want.permute(2, 0, 1)[None], w2.permute(3, 2, 0, 1).double())[0].permute(1, 2, 0)
    assert torch.equal(o2[..., :c2], want2) and n1 + n2 == packed.numel()


def test_bf16_plan_takes_every_width_the_cuda_core_tiles_took():
    """No fallback to the CUDA-core kernel for bf16: wherever its 16x16 or
    8x8 tiles fit a block's shared memory in bf16 (two bf16 of pad a pixel,
    c2 padded to 8), the tensor-core kernel has a tile that fits too (16, 8
    or 4)."""
    def old_fits(c1, c2):
        c2p = -(-c2 // 8) * 8
        return min(tft.smem_bytes(c1, c2p, 2, t) for t in (16, 8)) <= tft.SMEM_LIMIT

    for c1 in range(1, 830, 3):
        for c2 in (1, 8, 12, 16, 17, 32, 64, 65, 100, 128, 129, 256, 480, 704):
            if old_fits(c1, c2):
                tile, smem = tft.mma_tile(tft.mma_plan(c1, c2))
                assert tile in (16, 8, 4) and smem <= tft.SMEM_LIMIT, (c1, c2)
    with pytest.raises(ValueError):
        tft.mma_tile(tft.mma_plan(4000, 4000))
