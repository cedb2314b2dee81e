"""The port's B8 twins (ecseg_torch/ops/cc_kernels count_components_plain,
count_from_patches_plain, reached through the wrappers on CPU tensors)
against the Pallas entries they stand in for, ``count_cc_pallas`` and
``count_cc_from_patches`` (interpret mode on the CPU), on the cases of
tests/test_cc_pallas.py:22-122; exact equality everywhere.  The CUDA
kernels are held against these twins on the card (tests/test_torch_cuda.py,
chip_smoke.py).  A sequential model of the B8a and B8b kernels' count
(tile-local pieces of 32x32 tiles minus the links their edge pass makes,
on a forest of the tiles' border slots; B8a reads the mask itself, B8b the
stitched class) is held against scipy, the B8a twin and the B8b twin on
the tile-edge masks of tests/_masks.py, B8a's also at the ragged sizes of
chip_smoke.py's tile phase."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from scipy import ndimage as ndi

from ecseg_tpu.ops.cc_pallas import count_cc_from_patches, count_cc_pallas
from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import tiling

from _masks import TILE_MASKS, snake, tile_masks
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)


def _pair(t):
    return int(t[0]), int(t[1])


def _check_count(m, conn):
    want = _pair(count_cc_pallas(jnp.asarray(m), connectivity=conn))
    assert _pair(K.count_components(torch.from_numpy(m), conn)) == want
    return want


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("density", [0.15, 0.5, 0.85])
def test_count_twin_random(conn, density):
    m = np.random.default_rng(int(density * 100)).random((96, 160)) < density
    _check_count(m, conn)


@pytest.mark.parametrize("conn", [1, 2])
def test_count_twin_blobs_and_edges(conn):
    rng = np.random.default_rng(2)
    m = np.zeros((128, 200), bool)
    for _ in range(30):
        y, x = rng.integers(0, 120), rng.integers(0, 192)
        r = int(rng.integers(2, 7))
        m[y : y + r, x : x + r] = True
    m[0, :10] = m[-1, -10:] = True
    m[:10, 0] = m[-10:, -1] = True
    _check_count(m, conn)


def test_count_twin_degenerate_and_snake():
    assert _check_count(np.zeros((64, 128), bool), 2) == (0, 0)
    assert _check_count(np.ones((64, 128), bool), 2) == (1, 64 * 128)
    m = snake(64, 64)
    assert _check_count(m, 1) == (1, int(m.sum()))


def _labels_1024(rng):
    """tests/test_cc_pallas.py:79-96's 1024^2 label canvas: class-3 blobs and
    specks, class-1 clutter; class 2 sprinkled too, so every class has
    components."""
    h = w = 1024
    img = np.zeros((h, w), np.int32)
    for _ in range(150):
        y, x = rng.integers(0, h - 10, 2)
        r = int(rng.integers(2, 8))
        img[y : y + r, x : x + r] = 3
    img[rng.random((h, w)) < 0.002] = 3
    img[rng.random((h, w)) < 0.01] = 1
    img[rng.random((h, w)) < 0.005] = 2
    return img


def _patches(img, positions):
    return np.stack([img[y : y + 256, x : x + 256] for (y, x) in positions])


@pytest.fixture(scope="module")
def geometry_1024():
    positions = tuple(map(tuple, tiling.patch_positions(1024, 1024)))
    return positions, _patches(_labels_1024(np.random.default_rng(0)), positions)


@pytest.mark.parametrize("class_id", [0, 1, 2, 3])
def test_count_patches_twin_1024(geometry_1024, class_id):
    positions, patches = geometry_1024
    want = _pair(count_cc_from_patches(jnp.asarray(patches), positions, class_id=class_id))
    got = K.count_from_patches(torch.from_numpy(patches), positions, class_id)
    assert got[0].dtype == torch.int32 and got[0].dim() == 0
    assert _pair(got) == want
    # uint8 labels (the unfused path's) count the same
    assert _pair(K.count_from_patches(torch.from_numpy(patches.astype(np.uint8)), positions, class_id)) == want


def test_class_0_leaves_the_unwritten_rim_out(geometry_1024):
    """The Pallas kernel marks only copied pixels: at class 0 the 25-px
    right rim that the reference's copy plan never writes on square images
    is background, where ``stitch == 0`` on the zeroed canvas would count it.
    The twin equals the Pallas entry on this input at class 0
    (``test_count_patches_twin_1024[0]``)."""
    positions, patches = geometry_1024
    unwritten = (K._source_map(positions, torch.device("cpu")) < 0).numpy()
    assert unwritten.sum() == 25 * 768  # a 25-px strip of the right rim
    got = _pair(K.count_from_patches(torch.from_numpy(patches), positions, 0))
    canvas = K.stitch_plain(torch.from_numpy(patches), positions)
    naive = _pair(K.count_components(canvas == 0, 2))
    assert got[1] == naive[1] - unwritten.sum()
    written = K.stitch_plain(torch.ones_like(torch.from_numpy(patches)), positions) != 0
    assert got == _pair(K.count_components((canvas == 0) & written, 2))


@pytest.mark.parametrize("shape", [(700, 900), (256, 256), (512, 310)])
def test_count_patches_twin_irregular_geometries(shape):
    h, w = shape
    rng = np.random.default_rng(h + w)
    positions = tuple(map(tuple, tiling.patch_positions(h, w)))
    img = np.zeros((h, w), np.int32)
    for _ in range(40):
        y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
        img[y : y + int(rng.integers(2, 7)), x : x + int(rng.integers(2, 7))] = 3
    patches = _patches(img, positions)
    want = _pair(count_cc_from_patches(jnp.asarray(patches), positions, class_id=3))
    assert _pair(K.count_from_patches(torch.from_numpy(patches), positions, 3)) == want


def test_count_patches_twin_batches_tiles(geometry_1024):
    """A (T, N, S, S) batch counts each tile as the single-tile call does."""
    positions, patches = geometry_1024
    batch = torch.from_numpy(np.stack([patches, np.roll(patches, 7, axis=2)]))
    for class_id in (1, 3):
        count, px = K.count_from_patches(batch, positions, class_id, 1)
        assert count.shape == px.shape == (2,)
        for t in range(2):
            assert (int(count[t]), int(px[t])) == _pair(K.count_from_patches(batch[t], positions, class_id, 1))


TILE = 32


def _slot(ly, lx):
    """csrc/cc_count.cu border_slot; a node off its tile's border fails."""
    if ly == 0:
        return lx
    if ly == TILE - 1:
        return TILE + lx
    if lx == 0:
        return 2 * TILE + ly
    assert lx == TILE - 1, (ly, lx)
    return 3 * TILE + ly


def _edge_pairs(at, h, w, y0, x0, conn):
    """The unions of uf_edge_links (csrc/cc_label.cuh) for one tile, with
    its skip rules, as (pixel, neighbour) pairs."""
    pairs = []
    for t in range(TILE):  # top row, neighbours in row y0 - 1
        c = x0 + t
        if y0 == 0 or c >= w or not at(y0, c):
            continue
        u = y0 - 1
        ju, jl, jul = at(u, c), t > 0 and at(y0, c - 1), c > 0 and at(u, c - 1)
        if conn == 1:
            if ju and not (jl and jul):
                pairs.append(((y0, c), (u, c)))
        else:
            jur = c < w - 1 and at(u, c + 1)
            if ju and not jl:
                pairs.append(((y0, c), (u, c)))
            if jul and not (t > 0 and (jl or ju)):
                pairs.append(((y0, c), (u, c - 1)))
            if jur and not (ju and t < TILE - 1):
                pairs.append(((y0, c), (u, c + 1)))
    for t in range(TILE):  # left column, neighbours in column x0 - 1
        r = y0 + t
        if x0 == 0 or r >= h or not at(r, x0):
            continue
        left = x0 - 1
        jleft, jp, jul = at(r, left), t > 0 and at(r - 1, x0), r > 0 and at(r - 1, left)
        if conn == 1:
            if jleft and not (jp and jul):
                pairs.append(((r, x0), (r, left)))
        else:
            jdl = r < h - 1 and at(r + 1, left)
            if jleft and not jp:
                pairs.append(((r, x0), (r, left)))
            if jul and not (t > 0 and (jp or jleft)):
                pairs.append(((r, x0), (r - 1, left)))
            if jdl and not (jleft and t < TILE - 1):
                pairs.append(((r, x0), (r + 1, left)))
    return pairs


def _pieces_minus_links(mask, conn, seed):
    """csrc/cc_count.cu's B8b count, sequentially: each 32x32 tile's pieces
    (scipy, at ``conn``) counted, each foreground border pixel's slot
    pointed at its piece's least slot; then the edge pass's unions in a
    shuffled order (the card lands them in any), each a link when it hangs
    one root under another.  Returns (pieces - links, foreground)."""
    h, w = mask.shape
    tiles_x = -(-w // TILE)
    struct = ndi.generate_binary_structure(2, conn)

    def node(r, c):
        return ((r // TILE) * tiles_x + c // TILE) * 4 * TILE + _slot(r % TILE, c % TILE)

    parent, pieces, pairs = {}, 0, []
    for y0 in range(0, h, TILE):
        for x0 in range(0, w, TILE):
            lab, n = ndi.label(mask[y0 : y0 + TILE, x0 : x0 + TILE], struct)
            pieces += n
            border = [(ly, lx) for ly, lx in np.argwhere(lab > 0) if ly in (0, TILE - 1) or lx in (0, TILE - 1)]
            least = {}
            for ly, lx in border:
                least[lab[ly, lx]] = min(least.get(lab[ly, lx], 4 * TILE), _slot(ly, lx))
            base = node(y0, x0)
            for ly, lx in border:
                parent[base + _slot(ly, lx)] = base + least[lab[ly, lx]]
            pairs += _edge_pairs(lambda r, c: bool(mask[r, c]), h, w, y0, x0, conn)
    np.random.default_rng(seed).shuffle(pairs)

    def find(x):
        while parent[x] != x:
            x = parent[x]
        return x

    links = 0
    for p, q in pairs:
        a, b = find(node(*p)), find(node(*q))
        if a != b:
            parent[max(a, b)] = min(a, b)
            links += 1
    return pieces - links, int(mask.sum())


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("name", sorted(TILE_MASKS))
def test_piece_link_model_matches_scipy_and_twins_on_tile_masks(name, conn):
    """The model on each tile-edge mask (three orders of its unions) equals
    scipy's count and the B8a twin's; the mask embedded in a 256^2 image
    whose one patch is stitched (the plan's two unreached corners in it)
    counts as the B8b twin counts it."""
    m = TILE_MASKS[name]
    want = (ndi.label(m, ndi.generate_binary_structure(2, conn))[1] if m.size else 0, int(m.sum()))
    assert _pair(K.count_components(torch.from_numpy(m), conn)) == want
    for seed in range(3):
        assert _pieces_minus_links(m, conn, seed) == want
    img = np.zeros((256, 256), np.uint8)
    img[13 : 13 + m.shape[0], 222 - m.shape[1] : 222] = np.where(m, 3, 1)
    pos = ((0, 0),)
    src = K._source_map(pos, torch.device("cpu")).numpy()
    stitched = (src >= 0) & (img.reshape(-1)[np.maximum(src, 0)] == 3)  # one patch: the stack is the image
    got = _pieces_minus_links(stitched, conn, 0)
    assert got == _pair(K.count_from_patches(torch.from_numpy(img[None]), pos, 3, conn))


@pytest.mark.parametrize("h,w", [(306, 306), (462, 874)])
def test_piece_link_model_matches_the_b8b_twin_on_stitched_tile_masks(h, w):
    """Every ``tile_masks`` family at the canvas size, as class 3 on random
    classes 0-2 (class 0 too: the unreached rim of the square plan is
    background at every class), through the plan's descriptors, at both
    connectivities."""
    pos = tuple(map(tuple, tiling.patch_positions(h, w)))
    src = K.expand_descriptors(K._descriptors(pos, torch.device("cpu"))[0].numpy(), h, w)
    rng = np.random.default_rng(h + w)
    for name, m in tile_masks(h, w).items():
        img = np.where(m, 3, rng.integers(0, 3, (h, w))).astype(np.uint8)
        stack = _patches(img, pos)
        patches = torch.from_numpy(stack)
        for cls in (3, 0):
            stitched = (src >= 0) & (stack.reshape(-1)[np.maximum(src, 0)] == cls)
            for conn in (1, 2):
                want = _pair(K.count_from_patches(patches, pos, cls, conn))
                assert _pieces_minus_links(stitched, conn, 1) == want, (name, cls, conn)


@pytest.mark.parametrize("conn", [1, 2])
@pytest.mark.parametrize("h,w", [(33, 4097), (1, 2048), (2048, 1)])
def test_piece_link_model_of_b8a_at_the_card_sizes(h, w, conn):
    """B8a's count on its plain mask source, as the model gives it (unions
    in two shuffled orders), equals scipy's and the B8a twin's on every
    ``tile_masks`` family at the ragged sizes chip_smoke.py holds the
    kernel at (a partial tile row, a single row, a single column)."""
    struct = ndi.generate_binary_structure(2, conn)
    for name, m in tile_masks(h, w).items():
        want = (ndi.label(m, struct)[1], int(m.sum()))
        for seed in range(2):
            assert _pieces_minus_links(m, conn, seed) == want, (name, seed)
        assert _pair(K.count_components(torch.from_numpy(m), conn)) == want, name
