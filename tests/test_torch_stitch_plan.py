"""The stitch plan's row/column descriptors (ecseg_torch/ops/cc_kernels.py
``stitch_descriptors``), which kernels B1 and B8b read in place of the
per-pixel source map: they expand to exactly ``_source_map`` on every
geometry the tests and ``chip_smoke.py`` use and on a seeded sweep of
sizes, a descriptor that does not match raises, and a model of B1's quads
(a quad of four pixels whose column ``run`` reaches four reads four
consecutive patch bytes) equals the B1 twin.  The kernels themselves are
held against the twins on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import torch

from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import tiling

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
# the tests' and chip_smoke.py's geometries, square (an unreached rim) and
# not, the two-corner 256^2 plan, and odd sizes
GEOMETRIES = [
    (256, 256), (257, 300), (306, 306), (320, 384), (462, 462), (462, 874), (512, 310), (512, 512),
    (668, 668), (700, 900), (900, 700), (1000, 1000), (1024, 1024), (1040, 1392), (2047, 2049),
    (2048, 2048), (2048, 3072), (3072, 2048), (3000, 500),
]
SWEEP = [tuple(int(v) for v in hw) for hw in np.random.default_rng(8).integers(256, 3201, (16, 2))]


def _plan(h, w):
    pos = tuple(map(tuple, tiling.patch_positions(h, w)))
    src = K._source_map(pos, CPU).numpy()
    return pos, src, K.stitch_descriptors(src)


@pytest.mark.parametrize("h,w", GEOMETRIES + SWEEP)
def test_descriptors_expand_to_the_source_map(h, w):
    pos, src, desc = _plan(h, w)
    H, W = src.shape
    assert desc.dtype == np.int32 and desc.shape == (4 * W + 2 * H,)
    np.testing.assert_array_equal(K.expand_descriptors(desc, H, W), src)
    K.check_descriptors(desc, src, f"{h}x{w}")
    cached, canvas = K._descriptors(pos, CPU)
    assert torch.equal(cached, torch.from_numpy(desc))
    assert canvas.shape == (H, W) and canvas.dtype == torch.int32
    out = torch.empty_like(canvas)  # how the wrappers allocate the canvas
    assert out.shape == (H, W) and out.is_contiguous()


def test_unreached_pixels_by_plan_shape():
    """Square plans leave one 25-px strip of the right rim unreached (one
    bit), the 256^2 plan two 25x25 corners, non-square plans none."""
    for (h, w), unreached, nbits in [((2048, 2048), 44800, 1), ((1024, 1024), 19200, 1), ((256, 256), 1250, 2), ((2048, 3072), 0, 0)]:
        _, src, desc = _plan(h, w)
        cols = desc[: 4 * src.shape[1]].reshape(-1, 4)
        assert int((src < 0).sum()) == unreached
        assert bin(int(np.bitwise_or.reduce(cols[:, 1]))).count("1") == nbits


@pytest.mark.parametrize("field", ["C", "column bits", "run", "R", "row bits", "length"])
def test_a_descriptor_that_does_not_match_raises(field):
    _, src, desc = _plan(306, 306)
    H, W = src.shape
    bad = desc.copy()
    cols, rows = bad[: 4 * W].reshape(W, 4), bad[4 * W :].reshape(H, 2)
    if field == "C":
        cols[100, 0] += 1
    elif field == "column bits":
        cols[W - 5, 1] = 0  # a column of the unreached rim reached
    elif field == "run":
        cols[int(np.argmax(cols[:, 2] == 1)), 2] = 2  # a run across a seam
    elif field == "R":
        rows[7, 0] -= 256
    elif field == "row bits":
        rows[40, 1] ^= 1
    else:
        bad = bad[:-2]
    with pytest.raises(ValueError, match="306x306"):
        K.check_descriptors(bad, src, "306x306")


def test_the_wrappers_descriptors_raise_on_a_mismatch(monkeypatch):
    """The cached descriptors a kernel launch reads are checked against the
    replayed plan before first use: a derivation that goes wrong raises,
    naming the geometry, and nothing falls back to the source map."""
    pos = tuple(map(tuple, tiling.patch_positions(462, 874)))
    derive = K.stitch_descriptors

    def off_by_one(src):
        desc = derive(src)
        desc[4 * src.shape[1] + 2 * 17] += 1  # R of row 17
        return desc

    monkeypatch.setattr(K, "stitch_descriptors", off_by_one)
    K._descriptors.cache_clear()
    try:
        with pytest.raises(ValueError, match="462x874 stitch plan of 8 patches"):
            K._descriptors(pos, CPU)
    finally:
        K._descriptors.cache_clear()


def _stitch_quads_model(label_patches, desc, h, w):
    """csrc/stitch.cu's arithmetic in numpy: quads of four pixels; a quad
    inside one row whose column run reaches four reads the four bytes from
    R[y] + C[x] on (0 where its pixels are unreached), any other quad
    pixel by pixel."""
    flat = label_patches.reshape(-1).astype(np.int64)
    cols = desc[: 4 * w].reshape(w, 4).astype(np.int64)
    rows = desc[4 * w :].reshape(h, 2).astype(np.int64)
    n = h * w
    i = 4 * np.arange((n + 3) // 4)
    y, x = i // w, i % w
    fast = (x + 4 <= w) & (cols[np.minimum(x, w - 1), 2] >= 4)
    out = np.full(len(i) * 4, -7, np.int64)
    fi, fy, fx = i[fast], y[fast], x[fast]
    unreached = (rows[fy, 1] & cols[fx, 1]) != 0
    base = np.where(unreached, 0, rows[fy, 0] + cols[fx, 0])
    for k in range(4):
        out[fi + k] = np.where(unreached, 0, flat[base + k])
    slow = (i[~fast][:, None] + np.arange(4)).reshape(-1)
    slow = slow[slow < n]
    sy, sx = slow // w, slow % w
    s = np.where((rows[sy, 1] & cols[sx, 1]) != 0, -1, rows[sy, 0] + cols[sx, 0])
    out[slow] = np.where(s < 0, 0, flat[np.maximum(s, 0)])
    return out[:n].reshape(h, w), int(fast.sum()), len(i)


@pytest.mark.parametrize("h,w", [(256, 256), (306, 306), (462, 874), (257, 300), (1024, 1024), (2048, 3072)])
def test_stitch_quads_model_matches_twin(h, w):
    pos, src, desc = _plan(h, w)
    H, W = src.shape
    lp = np.random.default_rng(h * w).integers(0, 256, (len(pos), 256, 256)).astype(np.uint8)
    got, fast, quads = _stitch_quads_model(lp, desc, H, W)
    np.testing.assert_array_equal(got, K.stitch_plain(torch.from_numpy(lp), pos).numpy())
    assert fast > 0.9 * quads  # most quads take the four-byte load
