"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests import neither JAX nor ecseg_tpu, so they run on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py

Without a CUDA device each test skips (a CUDA kernel has no CPU mode); the
twins themselves are held against the JAX package on the CPU by
tests/test_torch_cc.py, tests/test_torch_cc_tiles.py,
tests/test_torch_cc_multiclass.py,
tests/test_torch_cc_count.py, tests/test_torch_fused_tail.py,
tests/test_torch_convt.py and tests/test_torch_tiling.py.  The kernels'
equality at 2048^2 and 2048x3072, and at the tile-count path's shapes, is
checked by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import tiling
from ecseg_torch.ops.convt import conv2d_transpose_packed, conv2d_transpose_packed_plain
from ecseg_torch.ops.fused_tail import fused_dec1_head, fused_dec1_head_plain

from _masks import CLASS_MAPS, MASKS, TILE_MASKS, seeds_like, tile_masks


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
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_tiled_cc_kernels_match_twins(cuda, name):
    """B2 (connectivity 1 and 2) and B3, whose kernels unite 32x32 tiles in
    shared memory and then across tile edges, bit-equal to their twins on
    the tile-edge masks, at 70x101 and at 100x70 (ragged tiles at the right
    and bottom), a single row and column and a map with no rows."""
    cases = [TILE_MASKS[name]]
    if name in tile_masks(1, 1):
        cases.append(tile_masks(100, 70, seed=1)[name])
    for mask in cases:
        m = torch.from_numpy(mask).to(cuda)
        for conn in (1, 2):
            assert torch.equal(K.label(m, conn), K.label_plain(m, conn)), (mask.shape, conn)
        assert torch.equal(K.flood_from_border(m), K.flood_from_border_plain(m)), mask.shape
        assert torch.equal(K.flood_from_border(~m), K.flood_from_border_plain(~m)), mask.shape


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CLASS_MAPS))
def test_multiclass_kernels_match_twins(cuda, name):
    cls = torch.from_numpy(CLASS_MAPS[name]).to(cuda)
    seeds = torch.from_numpy(seeds_like(CLASS_MAPS[name])).to(cuda)
    assert torch.equal(K.label_multiclass(cls), K.label_multiclass_plain(cls))
    assert torch.equal(K.flood_multiclass(cls, seeds), K.flood_multiclass_plain(cls, seeds))
    odd = cls % 2 == 1
    for conn in (1, 2):
        lab, fl = K.label_and_flood(odd, seeds, conn)
        want_lab, want_fl = K.label_and_flood_plain(odd, seeds, conn)
        assert torch.equal(lab, want_lab) and torch.equal(fl, want_fl)


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
    with pytest.raises(TypeError):
        K.label_multiclass(m)  # class maps enter as uint8
    with pytest.raises(ValueError):
        K.flood_multiclass(m.to(torch.uint8), m[:4])
    assert set(K.LAUNCHES.values()) == {0}
    K.label(m)
    K.flood_from_border(m)
    K.flood_from_seeds(m, m)
    K.label_multiclass(m.to(torch.uint8))
    K.flood_multiclass(m.to(torch.uint8), m)
    K.label_and_flood(m, m)
    K.count_components(m)
    assert K.LAUNCHES == {
        "stitch": 0, "label": 1, "flood_border": 1, "flood_seeds": 1,
        "label_mc": 1, "flood_mc": 1, "label_flood": 1, "count": 1,
        "count_patches": 0, "fused_tail": 0, "convt": 0,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MASKS))
def test_count_kernel_matches_twin(cuda, name):
    m = torch.from_numpy(MASKS[name]).to(cuda)
    for conn in (1, 2):
        got = K.count_components(m, conn)
        want = K.count_components_plain(m, conn)
        assert [int(v) for v in got] == [int(v) for v in want]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1024, 1024), (700, 900), (256, 256), (512, 310)])
def test_count_patches_kernel_matches_twin(cuda, h, w):
    """Two tiles in one launch, uint8 and int32 labels, every class (class
    0 includes the unwritten rim of square geometries, background)."""
    pos = tuple(map(tuple, tiling.patch_positions(h, w)))
    rng = np.random.default_rng(h * w)
    lp = rng.integers(0, 4, size=(2, len(pos), 256, 256)).astype(np.uint8)
    lp[1] = np.where(rng.random(lp[1].shape) < 0.97, 0, lp[1])  # sparse classes
    for dtype in (torch.uint8, torch.int32):
        t = torch.from_numpy(lp).to(cuda, dtype)
        for cls in range(4):
            for conn in (1, 2):
                got = K.count_from_patches(t, pos, cls, conn)
                want = K.count_from_patches_plain(t, pos, cls, conn)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (dtype, cls, conn)
                one = K.count_from_patches(t[1], pos, cls, conn)
                assert (int(one[0]), int(one[1])) == (int(want[0][1]), int(want[1][1]))


def _tail_args(rng, c1, c2, ncls, integer, dtype, device):
    if integer:
        mk = lambda *s: torch.from_numpy(rng.integers(-2, 3, s).astype(np.float32))
        x = torch.from_numpy(rng.integers(0, 3, (2, 256, 256, c1)).astype(np.float32))
    else:
        mk = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.2).astype(np.float32))
        x = torch.from_numpy((rng.random((2, 256, 256, c1)) * 0.5).astype(np.float32))
    ws = [mk(3, 3, c1, c2), mk(c2), mk(3, 3, c2, c2), mk(c2), mk(1, 1, c2, ncls), mk(ncls)]
    return [x.to(device, dtype)] + [t.to(device, dtype) for t in ws]


@pytest.mark.cuda
@pytest.mark.parametrize("c1,c2,ncls", [(64, 32, 4), (128, 64, 4), (10, 12, 3)])
def test_fused_tail_kernel_matches_twin(cuda, c1, c2, ncls):
    """Bit-equal on integer-valued float32 (the CUDA-core kernel) and bf16
    (the tensor-core kernel): every sum is exact in float32 in any order,
    so each rounding to bf16 lands where the twin's does, in every pixel
    of the patch, corners and tile seams included.  On random bf16,
    >= 99.99 % of the labels agree (the twin sums each conv in another
    order, and a bf16 rounding or a quantize tie may then flip;
    ``chip_smoke.py`` measured 0.999992 at the XL widths on an H100)."""
    rng = np.random.default_rng(c1 + c2)
    for dtype in (torch.float32, torch.bfloat16):
        args = _tail_args(rng, c1, c2, ncls, True, dtype, cuda)
        assert torch.equal(fused_dec1_head(*args), fused_dec1_head_plain(*args)), dtype
    args = _tail_args(rng, c1, c2, ncls, False, torch.bfloat16, cuda)
    agree = (fused_dec1_head(*args) == fused_dec1_head_plain(*args)).float().mean().item()
    assert agree >= 0.9999, agree


@pytest.mark.cuda
@pytest.mark.parametrize("c1,c2,ncls,tile", [(200, 100, 4, 8), (480, 480, 3, 4)])
def test_fused_tail_bf16_wide_plans(cuda, c1, c2, ncls, tile):
    """The tensor-core kernel's 8x8 and 4x4 tiles, two or more n-groups and
    weight steps spanning taps (200: 16-channel units, 8 a step), bit-equal
    on integer-valued bf16 (the float32 kernel does not fit these widths)."""
    from ecseg_torch.ops.fused_tail import mma_plan, mma_tile

    assert mma_tile(mma_plan(c1, c2))[0] == tile
    args = _tail_args(np.random.default_rng(c1), c1, c2, ncls, True, torch.bfloat16, cuda)
    assert torch.equal(fused_dec1_head(*args), fused_dec1_head_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,h,w,cin,cout",
    [(3, 16, 16, 512, 256), (2, 64, 64, 128, 64), (5, 8, 24, 8, 128), (1, 7, 9, 3, 4), (2, 11, 21, 40, 68), (1, 9, 33, 24, 8)],
)
def test_convt_kernel_matches_twin(cuda, n, h, w, cin, cout):
    """Bit-equal on integer inputs in float32 (the CUDA-core kernel) and in
    bf16 (the tensor-core kernel: integer sums are exact, so the one
    rounding matches), also where h and w are off the 8 x 16 block, cin
    off the 32-channel chunk and cout off the 64-channel block; on random
    bf16 within one bf16 rounding of the twin's result (2**-8 relative)
    plus float32 sum-order noise."""
    rng = np.random.default_rng(n * h + cin)
    x = torch.from_numpy(rng.integers(-4, 5, (n, h, w, cin)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.integers(-4, 5, (3, 3, cin, cout)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.integers(-4, 5, (cout,)).astype(np.float32)).to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        xd, kd = x.to(dtype), k.to(dtype)
        assert torch.equal(conv2d_transpose_packed(xd, kd, b), conv2d_transpose_packed_plain(xd, kd, b)), dtype
        assert torch.equal(conv2d_transpose_packed(xd, kd), conv2d_transpose_packed_plain(xd, kd)), dtype
    xb, kb = torch.randn_like(x).bfloat16(), torch.randn_like(k).bfloat16()
    got = conv2d_transpose_packed(xb, kb, b).float()
    want = conv2d_transpose_packed_plain(xb, kb, b).float()
    assert ((got - want).abs() <= 2**-7 * want.abs() + 1e-3 * want.abs().max()).all()


@pytest.mark.cuda
def test_new_wrappers_check_inputs_and_count_launches(cuda):
    K.reset_launches()
    pos = tuple(map(tuple, tiling.patch_positions(256, 256)))
    lp = torch.zeros((1, 256, 256), dtype=torch.uint8, device=cuda)
    with pytest.raises(TypeError):
        K.count_from_patches(lp.to(torch.int16), pos)
    with pytest.raises(ValueError):
        K.count_from_patches(lp[:, :128], pos)
    x = torch.zeros((1, 256, 256, 8), dtype=torch.bfloat16, device=cuda)
    w1, w2 = torch.zeros((3, 3, 8, 8), device=cuda), torch.zeros((3, 3, 8, 8), device=cuda)
    b, wh, bh = torch.zeros(8, device=cuda), torch.zeros((1, 1, 8, 4), device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):
        fused_dec1_head(x[:, :128], w1, b, w2, b, wh, bh)
    with pytest.raises(ValueError):
        fused_dec1_head(x, w1, b, w2, b, torch.zeros((1, 1, 8, 17), device=cuda), torch.zeros(17, device=cuda))
    with pytest.raises(TypeError):
        fused_dec1_head(x.half(), w1, b, w2, b, wh, bh)
    xt = torch.zeros((1, 4, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        conv2d_transpose_packed(xt, torch.zeros((3, 3, 8, 6), device=cuda))
    with pytest.raises(NotImplementedError):
        conv2d_transpose_packed(xt, torch.zeros((3, 3, 8, 8), device=cuda), relu=False)
    assert set(K.LAUNCHES.values()) == {0}
    K.count_from_patches(lp, pos)
    fused_dec1_head(x, w1, b, w2, b, wh, bh)
    conv2d_transpose_packed(xt, torch.zeros((3, 3, 8, 8), device=cuda))
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {"count_patches": 1, "fused_tail": 1, "convt": 1}
