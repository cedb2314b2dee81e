"""The port's watersheds against ecseg_tpu's: the host priority flood (C++
and its Python twin) against ops/watershed.watershed, the NuSeT marker
watershed, the device fast pass (labels and certificate counts) against
ops/watershed_tpu._nuset_fast_pass on the randomized touching-nuclei fields
of tests/test_watershed_auto.py and on a flood cut at its iteration cap,
the exact squared EDT against edt_tpu.edt_sq_tpu and scipy, and the min-cut
partition's C++ library against its Python twin."""

import numpy as np
import pytest
import torch
from scipy import ndimage as ndi

import jax.numpy as jnp

from ecseg_tpu.ops import edt_tpu
from ecseg_tpu.ops import maxflow as jmf
from ecseg_tpu.ops import watershed as jws
from ecseg_tpu.ops import watershed_tpu as jwt
from ecseg_torch.ops import maxflow as tmf
from ecseg_torch.ops import watershed as tws
from ecseg_torch.ops import watershed_gpu as twg
from ecseg_torch.ops.edt_gpu import edt_sq

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)
from test_watershed_auto import _blob_case, _rect_case, _sparse_case


def _flood_case(rng, h=48, w=56, n_markers=6):
    image = np.round(rng.random((h, w)) * 8)  # many equal values: the age order decides
    mask = rng.random((h, w)) < 0.85
    markers = np.zeros((h, w), np.int64)
    ys, xs = rng.integers(0, h, n_markers), rng.integers(0, w, n_markers)
    markers[ys, xs] = np.arange(1, n_markers + 1)
    return image, markers, mask


@pytest.mark.parametrize("line", [False, True])
@pytest.mark.parametrize("connectivity", [1, 2])
def test_host_flood_matches_jax(connectivity, line):
    rng = np.random.default_rng(connectivity * 10 + line)
    for _ in range(4):
        image, markers, mask = _flood_case(rng)
        want = jws.watershed(image, markers, mask=mask, connectivity=connectivity, watershed_line=line)
        got = tws.watershed(image, markers, mask=mask, connectivity=connectivity, watershed_line=line)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tws.watershed_py(image, markers, mask=mask, connectivity=connectivity, watershed_line=line), want)
    assert tws.watershed(image, markers).dtype == np.int64


@pytest.mark.parametrize("maker", [_blob_case, _rect_case], ids=["blobs", "rects"])
def test_nuset_marker_watershed_and_anchor_size_match_jax(maker):
    rng = np.random.default_rng(1)
    for _ in range(3):
        pred, scores, props = maker(rng)
        np.testing.assert_array_equal(
            tws.nuset_marker_watershed(scores, props, pred, 0.95), jws.nuset_marker_watershed(scores, props, pred, 0.95)
        )
        assert tws.anchor_size_from_mask(pred) == jws.anchor_size_from_mask(pred)
    low = np.full(len(scores), 0.5, np.float32)
    np.testing.assert_array_equal(tws.nuset_marker_watershed(low, props, pred, 0.95), pred.astype(np.int32))


def _jax_fast_pass(mask, markers):
    """The JAX pass's packed contour and certificate, on the host."""
    packed, n_unc = jwt._nuset_fast_pass(jnp.asarray(mask), jnp.asarray(markers.astype(np.int32)))
    return np.asarray(packed), int(n_unc)


@pytest.mark.parametrize(
    "maker,cases", [(_blob_case, 6), (_rect_case, 6), (_sparse_case, 4)], ids=["blobs", "rects", "sparse"]
)
def test_fast_pass_labels_and_certificate_match_jax(maker, cases):
    """The contour and the certificate count of the device pass equal the
    JAX pass's (run unpadded, at the mask's own size, as the port runs it);
    a clean certificate gives the host priority flood's result."""
    rng = np.random.default_rng(0)
    n_clean = 0
    for _ in range(cases):
        pred, scores, props = maker(rng)
        markers = tws.nuset_place_markers(scores, props, pred, 0.95)
        want, want_unc = _jax_fast_pass(pred != 0, markers)
        got, n_unc = twg.nuset_fast_pass(torch.from_numpy(pred != 0), torch.from_numpy(markers.astype(np.int32)))
        np.testing.assert_array_equal(got, want)
        assert n_unc == want_unc
        out, unc = twg.nuset_marker_watershed_auto(scores, props, pred, 0.95, "cpu")
        assert unc == n_unc
        if out is not None:
            n_clean += 1
            np.testing.assert_array_equal(out, jws.nuset_marker_watershed(scores, props, pred, 0.95))
    if maker is _sparse_case:
        assert n_clean > 0


def _edge_case(rng, h=100, w=90, n=5):
    """Blobs that may cross the bottom and right edges, where the JAX
    package's pass (padded to multiples of 128) sees background beyond the
    edge and the port's (unpadded, as the host EDT) does not."""
    yy, xx = np.ogrid[:h, :w]
    mask = np.zeros((h, w), bool)
    props = []
    for _ in range(n):
        cy, cx, r = int(rng.integers(25, h + 8)), int(rng.integers(25, w + 8)), int(rng.integers(8, 16))
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        props.append([cx - r, cy - r, min(cx + r, w - 1), min(cy + r, h - 1)])
    return mask.astype(np.float32), np.full(n, 0.97, np.float32), np.array(props, np.float32)


def test_unpadded_pass_gives_the_jax_packages_result_at_the_edges():
    """The port runs the certified pass at the mask's own size; the JAX
    package pads it (``_run_fast_pass``), which changes the EDT of blobs
    cut by the bottom or right edge and so some certificate counts.  The
    results still agree: where either side is clean it equals the host
    flood, and otherwise both recompute on the host."""
    rng = np.random.default_rng(6)
    for _ in range(12):
        pred, scores, props = _edge_case(rng)
        host = jws.nuset_marker_watershed(scores, props, pred, 0.95)
        got, _ = twg.nuset_marker_watershed_auto(scores, props, pred, 0.95, "cpu")
        want, _ = jwt.nuset_marker_watershed_auto(scores, props, pred, min_score=0.95)
        for out in (got, want):
            assert out is None or np.array_equal(out, host)


def test_fast_pass_iteration_cap_matches_jax():
    """A one-pixel corridor of about 4500 pixels flooded from one end: the
    flood is cut at the 4096-iteration cap on both sides, with the same
    contour and the 2^20 penalty."""
    h, w = 64, 140
    mask = np.zeros((h, w), bool)
    mask[::2] = True
    for r in range(1, h, 2):
        mask[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    markers = np.zeros((h, w), np.int32)
    markers[0, 0] = 1
    want, want_unc = _jax_fast_pass(mask, markers)
    got, n_unc = twg.nuset_fast_pass(torch.from_numpy(mask), torch.from_numpy(markers))
    assert want_unc >= twg.UNCONVERGED
    assert n_unc == want_unc
    np.testing.assert_array_equal(got, want)


def test_lex_flood_converges_where_jax_stops():
    rng = np.random.default_rng(3)
    pred, scores, props = _blob_case(rng)
    mask = pred != 0
    markers = tws.nuset_place_markers(scores, props, pred, 0.95).astype(np.int32)
    img = -edt_sq(torch.from_numpy(ndi.binary_fill_holes(mask)))
    cost, pcost, lab, conv = twg.lex_flood(img, torch.from_numpy(np.where(mask, markers, 0)), torch.from_numpy(mask))
    jc, jp, jl, jconv = jwt._lex_flood(jnp.asarray(img.numpy()), jnp.asarray(np.where(mask, markers, 0)), jnp.asarray(mask), 4096)
    assert conv and bool(jconv)
    for a, b in ((cost, jc), (pcost, jp), (lab, jl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _edt_masks(rng):
    out = [rng.random((37, 53)) < p for p in (0.3, 0.8, 0.97)]
    full_cols = rng.random((40, 30)) < 0.9
    full_cols[:, 5] = True  # a column with no zero
    out += [full_cols, np.zeros((9, 11), bool), np.ones((1, 7), bool)]  # all background, all foreground
    blobs = np.zeros((64, 64), bool)
    yy, xx = np.ogrid[:64, :64]
    blobs |= (yy - 30) ** 2 + (xx - 25) ** 2 < 400
    out.append(blobs)
    return out


def test_edt_sq_matches_jax_and_scipy():
    rng = np.random.default_rng(4)
    for m in _edt_masks(rng):
        got = edt_sq(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, np.asarray(edt_tpu.edt_sq_tpu(jnp.asarray(m))))
        if not m.all():
            np.testing.assert_array_equal(got, np.rint(ndi.distance_transform_edt(m) ** 2).astype(np.int32))
    with pytest.raises(ValueError, match="2\\^30"):
        edt_sq(torch.zeros((40000, 20000), dtype=torch.bool, device="meta"))


def test_maxflow_partition_library_matches_python_twin_and_jax():
    rng = np.random.default_rng(5)
    for _ in range(6):
        h, w = rng.integers(12, 30, 2)
        mask = (rng.random((h, w)) < 0.8).astype(np.int64)
        ys, xs = np.nonzero(mask)
        a, b = rng.choice(len(ys), 2, replace=False)
        c1, c2 = (int(ys[a]), int(xs[a])), (int(ys[b]), int(xs[b]))
        dist = int(rng.integers(1, 6))
        g1, g2 = tmf._partition(mask, c1, c2, dist)
        p1, p2 = tmf.partition_py(mask, c1, c2, dist)
        j1, j2 = jmf._partition(mask, c1, c2, dist)
        for got in (g1, p1):
            np.testing.assert_array_equal(got, j1)
        np.testing.assert_array_equal(g2, j2)
        np.testing.assert_array_equal(p2, j2)
        assert g1.dtype == mask.dtype
