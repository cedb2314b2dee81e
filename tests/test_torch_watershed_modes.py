"""The ungated watershed modes (``ECSEG_FAST_WATERSHED=on|check``) against
the JAX package's: ``ops/watershed_gpu.nuset_marker_watershed_fast`` (with
and without its tie count) against ``ops/watershed_tpu``'s on blobs cut by
the bottom and right edges (where the padded geometry of the JAX pass
decides the EDT, tests/test_torch_watershed.py's ``_edge_case``), on
touching nuclei and on plateau-heavy rectangles, and with no marker; and
``models/nuset_infer.watershed_pass``'s dispatch in every mode, with the
fallback counters under the JAX package's names."""

import types

import numpy as np
import pytest
import torch

from ecseg_tpu.ops import watershed as jws
from ecseg_tpu.ops import watershed_tpu as jwt
from ecseg_torch.models import nuset_infer as tni
from ecseg_torch.ops import watershed as tws
from ecseg_torch.ops import watershed_gpu as twg
from ecseg_torch.ops.packing import unpack_mask_1bit
from ecseg_torch.runtime import fallbacks

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_watershed import _edge_case
from test_watershed_auto import _blob_case, _rect_case

MIN_SCORE = 0.95
# name -> (maker, cases, seed); the first edge case of seed 5 is one whose
# contour the padding changes (1 of 48 edge cases of seeds 0-11)
CASES = {"edges": (_edge_case, 4, 5), "blobs": (_blob_case, 2, 11), "rects": (_rect_case, 2, 11)}


def _cases(name):
    maker, n, seed = CASES[name]
    rng = np.random.default_rng(seed)
    return [maker(rng) for _ in range(n)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_fast_watershed_matches_jax(name):
    ties = []
    for pred, scores, props in _cases(name):
        want, want_ties = jwt.nuset_marker_watershed_fast(scores, props, pred, min_score=MIN_SCORE, count_ties=True)
        got, got_ties = twg.nuset_marker_watershed_fast(scores, props, pred, MIN_SCORE, "cpu", count_ties=True)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert got_ties == want_ties
        np.testing.assert_array_equal(twg.nuset_marker_watershed_fast(scores, props, pred, MIN_SCORE, "cpu"), want)
        ties.append(got_ties)
    if name == "rects":
        assert max(ties) > 0  # the permuted pass flips pixels on the plateaus


def test_padded_pass_differs_from_the_unpadded_one_at_the_edges():
    """Why the fast path pads: on some edge case the contour at the mask's
    own size differs from the padded one (which the JAX package returns)."""
    differs = 0
    for pred, scores, props in _cases("edges"):
        markers = tws.nuset_place_markers(scores, props, pred, MIN_SCORE)
        unpadded, _ = twg.nuset_fast_pass(torch.from_numpy(pred != 0), torch.from_numpy(markers.astype(np.int32)))
        padded = twg.nuset_marker_watershed_fast(scores, props, pred, MIN_SCORE, "cpu")
        differs += not np.array_equal((pred * unpack_mask_1bit(unpadded, pred.shape[1])).astype(np.int32), padded)
    assert differs > 0


def test_no_marker_returns_the_mask():
    pred, scores, props = _cases("blobs")[0]
    low = np.full(len(scores), 0.5, np.float32)
    for count_ties in (False, True):
        got = twg.nuset_marker_watershed_fast(low, props, pred, MIN_SCORE, "cpu", count_ties=count_ties)
        want = jwt.nuset_marker_watershed_fast(low, props, pred, min_score=MIN_SCORE, count_ties=count_ties)
        if count_ties:
            (got, got_ties), (want, want_ties) = got, want
            assert got_ties == want_ties == 0
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pred.astype(np.int32))


def _model():
    return types.SimpleNamespace(bbox_min_score=MIN_SCORE, device=torch.device("cpu"))


@pytest.mark.parametrize("mode", ["host", "auto", "on", "check"])
def test_watershed_pass_dispatch(monkeypatch, mode):
    """Each mode's result and counters: ``host`` the host flood (no device
    pass), ``auto`` the certified pass or the counted host recompute, ``on``
    and ``check`` the JAX package's fast path, ``check`` its tie count
    recorded as ``fast_watershed_tie_px`` / ``fast_watershed_tie_images``."""
    pred, scores, props = _cases("rects")[1]
    host = jws.nuset_marker_watershed(scores, props, pred, min_score=MIN_SCORE)
    fast, ties = jwt.nuset_marker_watershed_fast(scores, props, pred, min_score=MIN_SCORE, count_ties=True)
    _, n_unc = twg.nuset_marker_watershed_auto(scores, props, pred, MIN_SCORE, "cpu")
    monkeypatch.setenv("ECSEG_FAST_WATERSHED", mode)
    if mode == "host":
        monkeypatch.setattr(twg, "nuset_fast_pass", lambda *a: pytest.fail("host mode ran the device pass"))
    fallbacks.reset()
    got = tni.watershed_pass(_model(), pred, props, scores)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, fast if mode in ("on", "check") else host)
    want = {}
    if mode == "auto" and n_unc:
        want = {"fast_watershed_uncertain_px": n_unc, "fast_watershed_host_recompute": 1}
    if mode == "check" and ties:
        want = {"fast_watershed_tie_px": ties, "fast_watershed_tie_images": 1}
    assert fallbacks.counts() == want
    assert ties > 0 and n_unc > 0  # the case reaches every counter
    fallbacks.reset()


def test_nuclei_segment_cleanup_follows_the_device_pipeline_switch(monkeypatch):
    """``device_cleanup=None`` is ``use_device_path()``: the host chain under
    ``ECSEG_DEVICE_PIPELINE=0``, the device cleanup otherwise."""
    seen = []
    monkeypatch.setattr(tni, "nuset_forward", lambda model, image, pass_two: np.ones((32, 32), np.float32))
    monkeypatch.setattr(tni, "mask_and_proposals", lambda model, image: (np.ones((32, 32), np.float32), None, None))
    monkeypatch.setattr(tni, "watershed_pass", lambda model, mask, proposals, scores: mask)
    monkeypatch.setattr(tni, "cleanup_pass", lambda *a: seen.append("device") or np.zeros((32, 32), np.uint8))
    monkeypatch.setattr(tni, "cleanup_host", lambda *a: seen.append("host") or np.zeros((32, 32), np.uint8))
    model = types.SimpleNamespace(resize_scale=1, device=torch.device("cpu"))
    image = np.zeros((32, 32), np.uint8)
    for value in ("1", "0", None):
        if value is None:
            monkeypatch.delenv("ECSEG_DEVICE_PIPELINE", raising=False)
        else:
            monkeypatch.setenv("ECSEG_DEVICE_PIPELINE", value)
        tni.nuclei_segment(image, model, 10)
    assert seen == ["device", "host", "device"]
