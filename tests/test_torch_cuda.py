"""The port's CUDA kernels against their plain PyTorch twins, on the card.

These tests import neither JAX nor ecseg_tpu, so they run on a machine
that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py

Without a CUDA device each test skips (a CUDA kernel has no CPU mode); the
twins themselves are held against the JAX package on the CPU by
tests/test_torch_cc.py, tests/test_torch_cc_tiles.py,
tests/test_torch_cc_multiclass.py,
tests/test_torch_cc_count.py, tests/test_torch_fused_tail.py,
tests/test_torch_convt.py, tests/test_torch_conv3x3.py and
tests/test_torch_tiling.py.  The kernels' equality at 2048^2 and 2048x3072, and at the tile-count path's shapes, is
checked by chip_smoke.py.  meta_overlay's statistics (B2 and B8a) are held
against their own CPU run (the twins), which tests/test_torch_overlay.py
holds against the JAX package; so are stat_fish's device stages (the EDT,
the certified watershed on B3, NMS, the cleanup on B2, the matched filter)
and its whole segmentation, which tests/test_torch_watershed.py and
tests/test_torch_nuset_infer.py hold against the JAX package.  The
trainer's float32 step runs on the card against the CPU, and resumes from
a checkpoint bit-equal, as chip_smoke.py's train phase checks at the
default widths (tests/test_torch_train.py holds the trainer against the
JAX package).  metaseg's grouped dispatch runs on the card grouped, in
pairs and per image with the same bytes as the CPU run
(tests/test_torch_metaseg_grouped.py holds the CPU runs against the JAX
package's grouped run).
"""

import numpy as np
import pytest
import torch

from ecseg_torch.models import layers
from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import conv3x3, tiling
from ecseg_torch.ops.convt import conv2d_transpose_packed, conv2d_transpose_packed_plain
from ecseg_torch.ops.fused_tail import fused_dec1_head, fused_dec1_head_plain

from _masks import (
    CLASS_MAPS, MASKS, TILE_CLASS_MAPS, TILE_MASKS, seed_patterns, seeds_like, tile_class_maps, tile_masks,
)


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
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_tiled_seeded_flood_matches_twin(cuda, name):
    """B4 (connectivity 1 and 2) on the tiled forest, bit-equal to its twin
    on the tile-edge masks with every seed pattern (sparse, dense, on tile
    corners and edges, only off the mask), at 70x101 and 100x70."""
    cases = [TILE_MASKS[name]]
    if name in tile_masks(1, 1):
        cases.append(tile_masks(100, 70, seed=1)[name])
    for mask in cases:
        m = torch.from_numpy(mask).to(cuda)
        for pattern, seeds in seed_patterns(mask).items():
            s = torch.from_numpy(seeds).to(cuda)
            for conn in (1, 2):
                got, want = K.flood_from_seeds(m, s, conn), K.flood_from_seeds_plain(m, s, conn)
                assert torch.equal(got, want), (mask.shape, pattern, conn)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_CLASS_MAPS))
def test_tiled_multiclass_label_matches_twin(cuda, name):
    """B5 on the tiled forest with the equal-class predicate, bit-equal to
    its twin on class maps whose classes meet along tile edges, on tiles
    and in stripes, at 70x101 and 100x70."""
    cases = [TILE_CLASS_MAPS[name]]
    if name in tile_class_maps(1, 1):
        cases.append(tile_class_maps(100, 70, seed=1)[name])
    for cls_map in cases:
        cls = torch.from_numpy(cls_map).to(cuda)
        assert torch.equal(K.label_multiclass(cls), K.label_multiclass_plain(cls)), cls_map.shape


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_CLASS_MAPS))
def test_tiled_multiclass_flood_matches_twin(cuda, name):
    """B6 (B4's tiled forest with the equal-class predicate) bit-equal to
    its twin on the tile class maps with every seed pattern (``off_mask``:
    seeds only on class 0, all ignored), at 70x101 and 100x70."""
    cases = [TILE_CLASS_MAPS[name]]
    if name in tile_class_maps(1, 1):
        cases.append(tile_class_maps(100, 70, seed=1)[name])
    for cls_map in cases:
        cls = torch.from_numpy(cls_map).to(cuda)
        for pattern, seeds in seed_patterns(cls_map > 0).items():
            s = torch.from_numpy(seeds).to(cuda)
            got, want = K.flood_multiclass(cls, s), K.flood_multiclass_plain(cls, s)
            assert torch.equal(got, want), (cls_map.shape, pattern)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_tiled_label_and_flood_matches_twin(cuda, name):
    """B9 (B4's tiled forest, then one pass that flattens and gathers)
    bit-equal to its twin in labels and flood on the tile-edge masks with
    every seed pattern, connectivity 1 and 2, at 70x101 and 100x70."""
    cases = [TILE_MASKS[name]]
    if name in tile_masks(1, 1):
        cases.append(tile_masks(100, 70, seed=1)[name])
    for mask in cases:
        m = torch.from_numpy(mask).to(cuda)
        for pattern, seeds in seed_patterns(mask).items():
            s = torch.from_numpy(seeds).to(cuda)
            for conn in (1, 2):
                got, want = K.label_and_flood(m, s, conn), K.label_and_flood_plain(m, s, conn)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (mask.shape, pattern, conn)


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
@pytest.mark.parametrize("h,w", [(2048, 2048), (462, 874), (306, 306), (2048, 3072), (256, 256), (1024, 1024)])
def test_stitch_kernel_matches_twin(cuda, h, w):
    """Random bytes 0-255, so every byte lane of the kernel's four-byte
    loads shows; the patch stack also from an odd offset of its storage,
    so the quads' loads straddle words everywhere."""
    key = tuple(map(tuple, tiling.patch_positions(h, w)))
    rng = np.random.default_rng(h + w)
    lp = torch.from_numpy(rng.integers(0, 256, size=(len(key), 256, 256)).astype(np.uint8)).to(cuda)
    assert torch.equal(K.stitch_labels(lp, key), K.stitch_plain(lp, key))
    odd = torch.empty(lp.numel() + 1, dtype=torch.uint8, device=cuda)[1:].view(lp.shape)
    odd.copy_(lp)
    assert torch.equal(K.stitch_labels(odd, key), K.stitch_plain(lp, key))


@pytest.mark.cuda
def test_kernels_raise_on_descriptors_that_do_not_match(cuda, monkeypatch):
    """B1 and B8b read the plan's descriptors, checked against the replayed
    plan before their first launch: a mismatch raises and launches
    nothing."""
    key = tuple(map(tuple, tiling.patch_positions(306, 306)))
    derive = K.stitch_descriptors

    def off(src):
        desc = derive(src)
        desc[0] += 1  # C of column 0
        return desc

    monkeypatch.setattr(K, "stitch_descriptors", off)
    K._descriptors.cache_clear()
    K.reset_launches()
    lp = torch.zeros((len(key), 256, 256), dtype=torch.uint8, device=cuda)
    try:
        with pytest.raises(ValueError, match="306x306 stitch plan"):
            K.stitch_labels(lp, key)
        with pytest.raises(ValueError, match="306x306 stitch plan"):
            K.count_from_patches(lp, key)
    finally:
        K._descriptors.cache_clear()
    assert set(K.LAUNCHES.values()) == {0}


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
        "count_patches": 0, "fused_tail": 0, "convt": 0, "conv3x3": 0,
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
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_count_kernel_on_tile_masks(cuda, name):
    """B8a, which counts 32x32 tiles' pieces minus the links across their
    edges, bit-equal to its twin on each tile-edge mask at 70x101 and
    100x70 (ragged tiles), and on the family at 33x4097, 1x2048 and 2048x1
    (the single row and column, and the map with no rows, as they are);
    each mask also from a view at an odd address, whose rows the kernel
    reads with two aligned loads and a shift; both connectivities."""
    cases = [TILE_MASKS[name]]
    if name in tile_masks(1, 1):
        cases += [tile_masks(100, 70, seed=1)[name]] + [tile_masks(h, w)[name] for h, w in ((33, 4097), (1, 2048), (2048, 1))]
    for m in cases:
        t = torch.from_numpy(m).to(cuda)
        odd = torch.zeros(m.size + 3, dtype=torch.bool, device=cuda)[3:].view(m.shape)
        odd.copy_(t)
        for conn in (1, 2):
            want = [int(v) for v in K.count_components_plain(t, conn)]
            assert [int(v) for v in K.count_components(t, conn)] == want, (m.shape, conn)
            assert [int(v) for v in K.count_components(odd, conn)] == want, (m.shape, conn, "odd address")


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


def _count_both_dtypes(t, pos, cls, conn, what):
    """B8b on uint8 and int32 labels against the twin."""
    want = K.count_from_patches_plain(t, pos, cls, conn)
    for dtype in (torch.uint8, torch.int32):
        got = K.count_from_patches(t.to(dtype), pos, cls, conn)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (what, dtype, cls, conn)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_count_patches_kernel_on_tile_masks(cuda, name):
    """B8b, which counts 32x32 tiles' pieces minus the links across their
    edges, on each tile-edge mask written into patch stacks as class 3 over
    random classes 0-2: the mask itself placed across the canvas's tile
    edges on the 306^2 plan (unreached rim), and the same family at the
    462x874 and 1024^2 canvas sizes (the single row and column and the
    empty map placed as on the 306^2 plan); classes 3 and 0, both connectivities,
    uint8 and int32 labels."""
    rng = np.random.default_rng(len(name))
    m = TILE_MASKS[name]
    for h, w in [(306, 306), (462, 874), (1024, 1024)]:
        pos = tuple(map(tuple, tiling.patch_positions(h, w)))
        families = tile_masks(h, w)
        if (h, w) != (306, 306) and name in families:
            canvas = families[name]
        else:  # the mask itself (also the single row and column)
            canvas = np.zeros((h, w), bool)
            canvas[29 : 29 + m.shape[0], 30 : 30 + m.shape[1]] = m
        img = np.where(canvas, 3, rng.integers(0, 3, (h, w))).astype(np.uint8)
        lp = torch.from_numpy(np.stack([img[y : y + 256, x : x + 256] for (y, x) in pos])[None]).to(cuda)
        for cls in (3, 0):
            for conn in (1, 2):
                _count_both_dtypes(lp, pos, cls, conn, f"{name} {h}x{w}")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 2, 32])
def test_count_patches_kernel_tile_batches(cuda, t):
    """T canvases of the tile-count path's 1024^2 plan (25 patches each)
    in one launch, dense and sparse classes, every class and connectivity,
    uint8 and int32 labels."""
    pos = tuple(map(tuple, tiling.patch_positions(1024, 1024)))
    rng = np.random.default_rng(t)
    lp = rng.integers(0, 4, size=(t, len(pos), 256, 256)).astype(np.uint8)
    lp[t // 2 :] = np.where(rng.random(lp[t // 2 :].shape) < 0.97, 0, lp[t // 2 :])  # sparse classes
    lp = torch.from_numpy(lp).to(cuda)
    for cls in range(4):
        for conn in (1, 2):
            _count_both_dtypes(lp, pos, cls, conn, f"{t} tiles")


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


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,h,w,ca,cb,cout",
    [(2, 16, 16, 1, 0, 64), (1, 256, 256, 64, 0, 64), (2, 16, 16, 1024, 0, 128), (2, 32, 32, 128, 128, 128),
     (2, 20, 18, 8, 8, 4), (1, 9, 7, 3, 5, 8), (2, 37, 23, 24, 0, 200), (3, 17, 40, 64, 64, 64)],
)
def test_conv3x3_kernel_matches_twin_and_cudnn(cuda, n, h, w, ca, cb, cout):
    """The float32 3x3 conv: bit-equal to its twin on integer inputs (every
    sum exact; cuDNN's FFT tiling is not), also off the 8 x 16 tile, the
    64/128-channel block and the 16-channel chunk, with a split input;
    within float32 sum-order noise of cuDNN (TF32 off) on integer and
    normal inputs; the same bytes on a second call and per image."""
    _check_conv3x3_kernel(cuda, n, h, w, ca, cb, cout, relu=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,ca,cb,cout", [(2, 16, 16, 1, 0, 64), (2, 32, 32, 128, 128, 128), (1, 9, 7, 3, 5, 8), (2, 37, 23, 24, 0, 200)])
def test_conv3x3_kernel_without_relu_matches_twin_and_cudnn(cuda, n, h, w, ca, cb, cout):
    """As above with the ReLU left out (the template flag the linear
    transpose convs take): the negative sums kept."""
    _check_conv3x3_kernel(cuda, n, h, w, ca, cb, cout, relu=False)


def _check_conv3x3_kernel(cuda, n, h, w, ca, cb, cout, relu):
    from ecseg_torch.models.layers import parity_flags

    rng = np.random.default_rng(n * h + ca + cb)
    x = torch.from_numpy(rng.integers(-4, 5, (n, ca + cb, h, w)).astype(np.float32)).to(cuda)
    k = torch.from_numpy(rng.integers(-4, 5, (cout, ca + cb, 3, 3)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.integers(-40, 41, (cout,)).astype(np.float32)).to(cuda)

    def run(x, k, b):
        return conv3x3.conv3x3_relu(_cl(x[:, :ca]), k, b, _cl(x[:, ca:]) if cb else None, relu=relu)

    got = run(x, k, b)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, conv3x3.conv3x3_relu_plain(x[:, :ca].cpu(), k.cpu(), b.cpu(), x[:, ca:].cpu() if cb else None, relu).to(cuda))
    assert bool((got < 0).any()) != relu
    xr, kr = torch.randn_like(x), torch.randn_like(k) / (3 * (ca + cb) ** 0.5)
    for xs, ks in ((x, k), (xr, kr)):
        got = run(xs, ks, b)
        with parity_flags():
            want = torch.nn.functional.conv2d(xs, ks, b, padding=1)
        want = torch.relu(want) if relu else want
        assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
    assert torch.equal(run(xr, kr, b), got)
    assert torch.equal(torch.cat([run(xr[i : i + 1], kr, b) for i in range(n)]), got)


@pytest.mark.cuda
def test_conv3x3_refuses_and_counts_launches(cuda):
    K.reset_launches()
    x = torch.zeros((1, 8, 16, 16), device=cuda)
    k, b = torch.zeros((8, 8, 3, 3), device=cuda), torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="channels-last"):
        conv3x3.conv3x3_relu(torch.zeros((1, 8, 16, 16), device=cuda), k, b)  # NCHW memory
    with pytest.raises(TypeError):
        conv3x3.conv3x3_relu(_cl(x).half(), k, b)
    with pytest.raises(ValueError, match="not 3x3"):
        conv3x3.conv3x3_relu(_cl(x), torch.zeros((8, 8, 1, 1), device=cuda), b)
    with pytest.raises(ValueError, match="is on cpu"):
        conv3x3.conv3x3_relu(_cl(x), k.cpu(), b)
    assert set(K.LAUNCHES.values()) == {0}
    conv3x3.conv3x3_relu(_cl(x), k, b)
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {"conv3x3": 1}


@pytest.mark.cuda
def test_metaseg_forward_routes_its_3x3_convs_to_the_kernel(cuda):
    """A no-grad float32 forward on the card: 18 kernel launches, and 4
    more for the transpose convs at 4 patches (``layers.transpose_on_kernel``;
    none at 17), and the labels of the cuDNN forward; a forward that builds
    a graph and a bf16 forward launch none."""
    from ecseg_torch.models.metaseg_unet import MetasegUNet
    from ecseg_torch.runtime import fallbacks

    model = MetasegUNet((8, 16, 32, 64), 128, generator=torch.Generator().manual_seed(3)).to(cuda).eval()
    x = torch.from_numpy((np.random.default_rng(3).random((4, 256, 256, 1)) * 255).astype(np.uint8)).to(cuda)
    K.reset_launches()
    fallbacks.reset()
    with torch.no_grad():
        probs = model(x)
    assert layers.transpose_on_kernel(x.permute(0, 3, 1, 2))
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {"conv3x3": 22} and fallbacks.counts() == {}
    K.reset_launches()
    with torch.no_grad():
        model(x[:1].expand(layers.ZERO_SPREAD_MAX_IMAGES + 1, -1, -1, -1))
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {"conv3x3": 18}
    cpu = model.to("cpu")
    with torch.no_grad():
        want = cpu(x.cpu())
    assert float((probs.cpu() - want).abs().max()) <= 1e-5
    model.to(cuda)
    K.reset_launches()
    model(x)  # autograd records
    with torch.no_grad():
        model(x, dtype=torch.bfloat16)
    assert set(K.LAUNCHES.values()) == {0}


@pytest.mark.cuda
def test_nuset_pass_routes_its_convs_to_the_kernel(cuda, monkeypatch):
    """A no-grad float32 NuSeT U-Net pass at stat_fish's 608^2 on the card:
    22 H1 launches (18 ReLU'd 3x3 convs, 4 transpose convs) and no
    fallback.  Against the cuDNN pass (the route off, TF32 off): with
    seeded Glorot weights, whose decoder reaches the logits, the logits and
    the RPN feature within float32 and the masks within 12 pixels; with the
    demo weights (logits from level 1 alone) the same mask.  A pass that
    builds a graph launches none."""
    from ecseg_torch.models import nuset
    from ecseg_torch.models.demo import demo_nuset_tree
    from ecseg_torch.models.weights import nuset_from_numpy
    from ecseg_torch.runtime import fallbacks

    pred, _, _ = _touching_nuclei(5, 608, 608, 12)
    img = pred * 2.0 + np.random.default_rng(5).standard_normal(pred.shape) * 0.5
    x = torch.from_numpy(((img - img.mean()) / img.std()).astype(np.float32)).to(cuda)[None, None]
    route = nuset.NuSeTUNet._kernel_route
    for tag, unet in (("glorot", nuset.NuSeTUNet(torch.Generator().manual_seed(5))), ("demo", nuset_from_numpy(demo_nuset_tree())[0])):
        unet = unet.to(cuda).eval()
        monkeypatch.setattr(nuset.NuSeTUNet, "_kernel_route", route)
        K.reset_launches()
        fallbacks.reset()
        with torch.no_grad():
            logits, feat = unet(x)
        assert {k: v for k, v in K.LAUNCHES.items() if v} == {"conv3x3": 22} and fallbacks.counts() == {}
        monkeypatch.setattr(nuset.NuSeTUNet, "_kernel_route", lambda self, x, dtype: False)
        K.reset_launches()
        with torch.no_grad():
            want_logits, want_feat = unet(x)
        assert set(K.LAUNCHES.values()) == {0}
        for got, want in ((logits, want_logits), (feat, want_feat)):
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            assert err <= 1e-4 * scale, (tag, err, scale)  # float32 sums of up to 9 * 1024 terms, in two orders, through 22 convs
        mask, want_mask = nuset.pred_mask(logits), nuset.pred_mask(want_logits)
        if tag == "demo":
            assert torch.equal(mask, want_mask) and mask.any() and not mask.all()
        else:
            assert int((mask != want_mask).sum()) <= 12
    monkeypatch.undo()
    K.reset_launches()
    unet(x)  # autograd records
    assert set(K.LAUNCHES.values()) == {0}


@pytest.mark.cuda
def test_nuclei_segment_launches_44_kernel_convs_an_image(cuda, monkeypatch):
    """An image's segmentation runs two U-Net passes, 22 H1 launches each,
    with no conv left to cuDNN by a refusal; its mask equals the one with
    both passes on cuDNN."""
    from ecseg_torch.models import nuset
    from ecseg_torch.models import nuset_infer as ni
    from ecseg_torch.models.demo import demo_nuset_tree
    from ecseg_torch.models.weights import nuset_from_numpy
    from ecseg_torch.runtime import fallbacks

    tree = demo_nuset_tree()
    tree["fg"]["rpn"]["rpn_cls_score"]["bias"][1::2] = 6.0
    whole, fg, rpn = (x.to(cuda).eval() for x in nuset_from_numpy(tree))
    model = ni.NuSeTModel(whole, fg, rpn, resize_scale=1)
    pred, _, _ = _touching_nuclei(7, 320, 288, 12)
    image = (pred * 200 + np.random.default_rng(7).random(pred.shape) * 30).astype(np.uint8)
    K.reset_launches()
    fallbacks.reset()
    got = ni.nuclei_segment(image, model, 60)
    assert K.LAUNCHES["conv3x3"] == 44 and fallbacks.CONV3X3_CUDNN not in fallbacks.counts()
    monkeypatch.setattr(nuset.NuSeTUNet, "_kernel_route", lambda self, x, dtype: False)
    K.reset_launches()
    want = ni.nuclei_segment(image, model, 60)
    assert K.LAUNCHES["conv3x3"] == 0
    assert got.any() and np.array_equal(got, want)


def _overlay_masks(rng, shape):
    """Five (H, W) bool masks as tests/test_overlay_tpu.py draws them: red,
    green, and nuclei, chromosomes and ecDNA of a label map with blobs."""
    red = rng.random(shape) < 0.15
    green = rng.random(shape) < 0.15
    seg = (rng.random(shape) * 4).astype(int)
    for lab in (1, 2, 3):
        for _ in range(12):
            y, x = rng.integers(0, shape[0] - 8), rng.integers(0, shape[1] - 8)
            r = int(rng.integers(2, 30))
            seg[y : y + r, x : x + r] = lab
    return red, green, seg == 1, seg == 2, seg == 3


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["seed0", "seed1", "seed2", "empty", "full", "nuclei_only_fish"])
def test_overlay_stats_on_the_card_match_the_plain_version(cuda, monkeypatch, case):
    """``overlay_stats`` on the card (B2 and B8a, no twin called) equals its
    CPU run (the twins) on seeded masks at 200x300, on empty and
    all-foreground masks and with FISH only on nuclei; five B2 and three
    B8a launches an image."""
    from ecseg_torch.ops.overlay_gpu import overlay_stats

    shape = (200, 300)
    if case.startswith("seed"):
        masks = _overlay_masks(np.random.default_rng(int(case[-1])), shape)
    else:
        z, o = np.zeros(shape, bool), np.ones(shape, bool)
        masks = {"empty": (z, z, z, z, z), "full": (o, o, z, o, o),
                 "nuclei_only_fish": (o, o, o, z, np.eye(*shape, dtype=bool))}[case]
    want = overlay_stats(*masks, device="cpu")

    def forbidden(*a, **k):
        raise AssertionError("the card's overlay_stats called a plain twin")

    for name in ("label_plain", "count_components_plain"):
        monkeypatch.setattr(K, name, forbidden)
    K.reset_launches()
    assert overlay_stats(*masks, device=cuda) == want
    assert {k: v for k, v in K.LAUNCHES.items() if v} == {"label": 5, "count": 3}


def _touching_nuclei(seed, h, w, n):
    """A mask of n discs, many touching, and one proposal around each."""
    rng = np.random.default_rng(seed)
    yy, xx = np.ogrid[:h, :w]
    mask = np.zeros((h, w), bool)
    props = []
    for _ in range(n):
        r = int(rng.integers(6, 14))
        cy, cx = int(rng.integers(24, h - 24)), int(rng.integers(24, w - 24))
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        props.append([cx - r, cy - r, cx + r, cy + r])
    return mask.astype(np.float32), np.full(n, 0.97, np.float32), np.array(props, np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,h,w,n", [(0, 160, 144, 8), (1, 208, 256, 30), (2, 97, 131, 12)])
def test_stat_fish_device_stages_on_the_card_match_the_cpu(cuda, seed, h, w, n):
    """stat_fish's device stages (B2, B3 and plain torch ops) on the card
    equal their CPU runs, which tests/test_torch_watershed.py and
    test_torch_nuset_infer.py hold against the JAX package: the EDT, the
    certified watershed (contour and certificate), NMS, the cleanup and the
    matched filter."""
    from ecseg_torch.models import nuset_infer as ni
    from ecseg_torch.ops import boxes
    from ecseg_torch.ops import matched_filter as mf
    from ecseg_torch.ops.edt_gpu import edt_sq
    from ecseg_torch.ops.watershed import nuset_place_markers
    from ecseg_torch.ops.watershed_gpu import nuset_fast_pass

    pred, scores, props = _touching_nuclei(seed, h, w, n)
    m = torch.from_numpy(pred != 0)
    assert torch.equal(edt_sq(m.to(cuda)).cpu(), edt_sq(m))
    markers = torch.from_numpy(nuset_place_markers(scores, props, pred, 0.95).astype(np.int32))
    got, got_unc = nuset_fast_pass(m.to(cuda), markers.to(cuda))
    want, want_unc = nuset_fast_pass(m, markers)
    assert np.array_equal(got, want) and got_unc == want_unc
    tf = boxes.change_order(torch.from_numpy(props))
    valid = torch.ones(len(tf), dtype=torch.bool)
    assert np.array_equal(boxes.nms_sorted(tf.to(cuda), valid.to(cuda), 800, 0.01), boxes.nms_sorted(tf, valid, 800, 0.01))
    for scale in (0.3, 1):
        out_hw = ni.output_shape(pred.shape, scale)
        assert np.array_equal(ni.cleanup_pass(pred, out_hw, 60, cuda), ni.cleanup_pass(pred, out_hw, 60, "cpu"))
    rng = np.random.default_rng(seed)
    I = (rng.random((h, w, 3)) * 120).astype(np.uint8)
    I[..., 1][rng.random((h, w)) < 0.01] = 250
    cells = (pred > 0).astype(np.uint8) * 255
    args = (I, cells, 3.0, 15, [70, 70], [7, 7])
    assert np.array_equal(mf.get_thresholded_device_packed(*args, cuda), mf.get_thresholded(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,h,w,n", [(1, 208, 256, 30), (4, 608, 608, 120)])
def test_certified_watershed_on_the_card_equals_the_host_chain(cuda, seed, h, w, n):
    """The default watershed on the card (the lex flood as replays of a
    CUDA graph, the host flood of the pass's own inputs where the
    certificate is not clean) equals the host chain, and the graph's flood
    equals the CPU loop, state and convergence."""
    from ecseg_torch.ops.watershed import nuset_marker_watershed, nuset_place_markers
    from ecseg_torch.ops.watershed_gpu import flood_inputs, lex_flood, nuset_marker_watershed_certified

    pred, scores, props = _touching_nuclei(seed, h, w, n)
    got, n_unc = nuset_marker_watershed_certified(scores, props, pred, 0.95, cuda)
    assert np.array_equal(got, nuset_marker_watershed(scores, props, pred, 0.95))
    m = torch.from_numpy(pred != 0)
    img, marks = flood_inputs(m, torch.from_numpy(nuset_place_markers(scores, props, pred, 0.95).astype(np.int32)))
    on_card = lex_flood(img.to(cuda), marks.to(cuda), m.to(cuda))
    on_cpu = lex_flood(img, marks, m)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(on_card[:3], on_cpu[:3])) and on_card[3] == on_cpu[3]


@pytest.mark.cuda
def test_nuclei_segment_on_the_card_matches_the_cpu(cuda):
    """The whole segmentation of a 200x180 image at resize_scale 1 with the
    demo NuSeT (its RPN scores raised so markers are placed) on the card
    and on the CPU."""
    from ecseg_torch.models.demo import demo_nuset_tree
    from ecseg_torch.models import nuset_infer as ni
    from ecseg_torch.models.weights import nuset_from_numpy

    tree = demo_nuset_tree()
    tree["fg"]["rpn"]["rpn_cls_score"]["bias"][1::2] = 6.0
    models = {}
    for dev in ("cpu", cuda):
        whole, fg, rpn = (x.to(dev).eval() for x in nuset_from_numpy(tree))
        models[str(dev)] = ni.NuSeTModel(whole, fg, rpn, resize_scale=1)
    pred, _, _ = _touching_nuclei(3, 200, 180, 10)
    image = (pred * 200 + np.random.default_rng(3).random(pred.shape) * 30).astype(np.uint8)
    got = ni.nuclei_segment(image, models[str(cuda)], 60)
    want = ni.nuclei_segment(image, models["cpu"], 60)
    assert got.any() and np.array_equal(got, want)


@pytest.mark.cuda
def test_segment_folder_on_the_card_equals_nuclei_segment_image_by_image(cuda, tmp_path):
    """stat_fish's folder loop on the card (the prep on the card, the
    watershed and the cleanup of image k on the worker's stream while image
    k + 1's passes run) yields each image's ``nuclei_segment`` mask, in
    order, at the 0.3 scale."""
    from ecseg_torch.core import imgio
    from ecseg_torch.models import nuset_infer as ni
    from ecseg_torch.models.demo import demo_nuset_tree
    from ecseg_torch.models.weights import nuset_from_numpy
    from ecseg_torch.pipelines import stat_fish

    tree = demo_nuset_tree()
    tree["fg"]["rpn"]["rpn_cls_score"]["bias"][1::2] = 6.0
    whole, fg, rpn = (x.to(cuda).eval() for x in nuset_from_numpy(tree))
    model = ni.NuSeTModel(whole, fg, rpn, resize_scale=0.3)
    paths = []
    yy, xx = np.ogrid[:640, :600]
    for k in range(4):
        rng = np.random.default_rng(10 + k)
        gray = rng.random((640, 600)) * 6000
        for _ in range(8):
            cy, cx, r = rng.integers(80, 560), rng.integers(80, 520), rng.integers(40, 60)
            gray[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 44000
        path = str(tmp_path / f"im{k}.tif")
        imgio.write_tiff_lzw(path, np.repeat(gray.astype(np.uint16)[..., None], 3, axis=2))
        paths.append(path)
    got = list(stat_fish.segment_folder(model, paths, 60))
    assert [p for p, _, _ in got] == paths
    for p, I, seg in got:
        want = ni.nuclei_segment(imgio.u16_to_u8(imgio.imread_bgr8(p))[:, :, 0], model, 60)
        assert seg.shape == I.shape[:2] and np.array_equal(seg, want[: seg.shape[0], : seg.shape[1]])
    assert all(seg.any() for _, _, seg in got)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu_and_resumes_bit_equal(cuda, tmp_path):
    """One float32 forward and backward of the trainer's loss at the
    default widths on two 256^2 crops of a synthetic DAPI image (labels by
    brightness), on the card under the parity flags and
    on the CPU: the loss within 1e-5, each gradient tensor held to the
    CPU's float64 gradient by chip_smoke's bound (the 90th percentile of
    its element errors within ``TRAIN_GRAD_FACTOR`` times the CPU float32
    gradient's, plus ``TRAIN_GRAD_TOL``).
    Then four Adam steps on the card (widths (8, 16), 64^2 crops) bit-equal
    to two, a checkpoint restored into fresh objects, and two more."""
    import contextlib

    import chip_smoke as cs
    from ecseg_torch.models.layers import parity_flags
    from ecseg_torch.models.metaseg_unet import MetasegUNet
    from ecseg_torch.ops.meta_post import meta_preprocess
    from ecseg_torch.runtime import checkpoint as ckpt
    from ecseg_torch.runtime import train as tt

    rng = np.random.default_rng(0)
    img = meta_preprocess(cs.synthetic_dapi(rng, 512, 512, crowded=False))
    x = torch.from_numpy(np.stack([img[:256, :256], img[256:, 256:]])[..., None].copy())
    y = (x[..., 0] > 100).int() + 2 * (x[..., 0] > 200).int()  # labels that follow the image, as metaseg's do
    ref = MetasegUNet(generator=torch.Generator().manual_seed(0))
    _, g64 = cs._loss_and_grads(ref, x, y, torch.float64, "cpu", contextlib.nullcontext())
    loss_cpu, g_cpu = cs._loss_and_grads(ref, x, y, torch.float32, "cpu", contextlib.nullcontext())
    loss_card, g_card = cs._loss_and_grads(ref, x, y, torch.float32, cuda, parity_flags())
    assert abs(loss_card - loss_cpu) <= 1e-5 * abs(loss_cpu)
    err_cpu, err_card = cs._rel_p90_errors(g_cpu, g64), cs._rel_p90_errors(g_card, g64)
    for name, e in err_card.items():
        assert e <= cs.TRAIN_GRAD_FACTOR * (err_cpu[name] + cs.TRAIN_GRAD_TOL), (name, e, err_cpu[name])

    def fresh(seed=0):
        model = MetasegUNet((8, 16), 32, generator=torch.Generator().manual_seed(seed)).to(cuda)
        return model, tt.make_optimizer(model, 1e-3)

    batches = [(x[k : k + 1, :64, :64], y[k : k + 1, :64, :64]) for k in (0, 1, 0, 1)]
    whole, whole_opt = fresh()
    for bx, by in batches:
        tt.train_step(whole, whole_opt, bx, by)
    half, half_opt = fresh()
    for bx, by in batches[:2]:
        tt.train_step(half, half_opt, bx, by)
    path = ckpt.save_checkpoint(str(tmp_path), 2, half, half_opt)
    resumed, resumed_opt = fresh(seed=1)
    assert ckpt.restore_checkpoint(path, resumed, resumed_opt) == 2
    for bx, by in batches[2:]:
        tt.train_step(resumed, resumed_opt, bx, by)
    assert all(torch.equal(p, q) for p, q in zip(whole.parameters(), resumed.parameters()))


@pytest.mark.cuda
def test_grouped_metaseg_on_the_card_equals_per_image_and_the_cpu(cuda, tmp_path, monkeypatch):
    """``metaseg.main`` on the card on four synthetic DAPI images of two
    geometries (one crowded, redone on the host inside its group) with the
    narrow demo U-Net: grouped (the default), in pairs and per image give
    the same ``labels/*.npy``, PNGs and CSV bytes, equal to the CPU run's."""
    import shutil

    import chip_smoke as cs
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.models.weights import params_to_numpy, save_npz
    from ecseg_torch.pipelines import metaseg

    model = demo_metaseg_params(torch.Generator().manual_seed(0), widths=(8, 16), bottleneck=32)
    save_npz(str(tmp_path / "models" / "metaseg.npz"), params_to_numpy(model))
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(0)
    for k, (h, w) in enumerate([(320, 352), (320, 310), (320, 352), (320, 352)]):
        imgio.write_tiff(str(src / f"img{k}.tif"), cs.synthetic_dapi(rng, h, w, crowded=k == 2))
    outs = {}
    for run, group, device in [("per_image", "1", "cuda"), ("grouped", None, "cuda"), ("pairs", "2", "cuda"), ("cpu", None, "cpu")]:
        folder = tmp_path / run
        shutil.copytree(src, folder)
        if group is None:
            monkeypatch.delenv("ECSEG_METASEG_GROUP", raising=False)
        else:
            monkeypatch.setenv("ECSEG_METASEG_GROUP", group)
        assert metaseg.main(config=Config(raw={"metaseg": {"inpath": str(folder)}}), device=device) == 0
        outs[run] = {f: (folder / f).read_bytes() for f in ["ec_quantification.csv"] + [f"labels/img{k}.{e}" for k in range(4) for e in ("npy", "png")]}
    for run in ("grouped", "pairs", "cpu"):
        assert outs[run] == outs["per_image"], run


@pytest.mark.cuda
@pytest.mark.parametrize("device_post", ["1", "0"])
def test_logical_mesh_metaseg_equals_the_single_card_run(cuda, tmp_path, monkeypatch, device_post):
    """``metaseg.main(devices=["cuda:0"] * 2)``, a logical mesh (the card
    listed twice: each entry its own worker thread and replica), in the
    default form (each image's chain on one entry, B1-B6 launched as often
    as on one card) and under ``ECSEG_DEVICE_PIPELINE=0`` (patch batches
    split over the entries, the stitch and the oracle on the host: no
    launch but the forwards' H1, one a 3x3 conv of each entry's forward):
    labels, PNGs and CSV bytes equal to the single-card run's."""
    import shutil

    import chip_smoke as cs
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.models.weights import params_to_numpy, save_npz
    from ecseg_torch.pipelines import metaseg

    model = demo_metaseg_params(torch.Generator().manual_seed(0), widths=(8, 16), bottleneck=32)
    save_npz(str(tmp_path / "models" / "metaseg.npz"), params_to_numpy(model))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ECSEG_DEVICE_PIPELINE", device_post)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(1)
    sizes = [(320, 352), (320, 310), (320, 352), (320, 352), (320, 352)]
    for k, (h, w) in enumerate(sizes):
        imgio.write_tiff(str(src / f"img{k}.tif"), cs.synthetic_dapi(rng, h, w, crowded=k == 2))
    outs, launches = {}, {}
    for run, kw in (("card", {"device": "cuda"}), ("mesh", {"devices": ["cuda:0"] * 2})):
        folder = tmp_path / run
        shutil.copytree(src, folder)
        K.reset_launches()
        assert metaseg.main(config=Config(raw={"metaseg": {"inpath": str(folder)}}), **kw) == 0
        launches[run] = dict(K.LAUNCHES)
        outs[run] = {f: (folder / f).read_bytes() for f in ["ec_quantification.csv"] + [f"labels/img{k}.{e}" for k in range(5) for e in ("npy", "png")]}
    assert outs["mesh"] == outs["card"]
    if device_post == "1":
        assert launches["mesh"] == launches["card"] and launches["mesh"]["stitch"] == 5
    else:
        # segment_folder_sharded: batches of 256 patches, each split over the 2 entries
        n_patches = sum(len(tiling.patch_positions(h, w)) for h, w in sizes)
        convs = sum(1 for layer in model.layers.values() if layer.kernel_size == (3, 3) and layer.stride == (1, 1))
        ups = sum(1 for layer in model.layers.values() if layer.stride == (2, 2))
        per_entry = 256 // 2  # every batch padded to 256 patches: each entry's forward of 128 keeps cuDNN's transpose convs
        per_forward = convs + ups * (per_entry <= layers.ZERO_SPREAD_MAX_IMAGES)
        assert {k: v for k, v in launches["mesh"].items() if v} == {"conv3x3": 2 * -(-n_patches // 256) * per_forward}
        assert launches["card"]["stitch"] == 5


@pytest.mark.cuda
def test_split_on_b2_at_2048_agrees_with_cuda_events(cuda):
    """``runtime/devtime.split`` of B2 on a random 2048^2 mask: its device
    time within 25 % of the CUDA-event mean of the same calls, one device
    operation or more, no host sync."""
    from ecseg_torch.runtime import devtime

    mask = torch.from_numpy(np.random.default_rng(0).random((2048, 2048)) < 0.5).to(cuda)
    event = devtime.cuda_ms(lambda: K.label(mask), 50)
    s = devtime.split(lambda: K.label(mask), 50)
    assert abs(s["device_ms"] - event) <= 0.25 * event, (s, event)
    assert s["ops"] >= 1 and s["syncs"] == 0 and s["wall_ms"] > 0
