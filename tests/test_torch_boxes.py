"""The port's anchors, box decode/clip and NMS (ecseg_torch/ops/boxes.py)
against ecseg_tpu/ops/boxes.py, and the proposal order under tied scores
against jax.lax.top_k."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecseg_tpu.ops import boxes as jb
from ecseg_torch.ops import boxes as tb

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

# XLA:CPU contracts decode's multiply-adds into FMAs and has its own exp, so
# decoded coordinates (up to 256 here) differ by up to an ulp of the largest
# intermediate, 2^-23 * 256; clip and change_order are exact
DECODE_ATOL = 256 * 2.0**-23
RATIOS = [0.125, 0.25, 0.5, 1, 2, 4, 8]
SCALES = [0.5, 1, 2]


@pytest.mark.parametrize("base", [7.0, 16.0, 23.5, float("nan")])
def test_anchors_equal(base):
    ref_t = tb.generate_anchors_reference(base, RATIOS, SCALES)
    ref_j = jb.generate_anchors_reference(base, RATIOS, SCALES)
    np.testing.assert_array_equal(ref_t, ref_j)
    np.testing.assert_array_equal(tb.generate_anchors(ref_t, 16, (5, 7)), jb.generate_anchors(ref_j, 16, (5, 7)))


def _rois_deltas(rng, n):
    ctr = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(2, 60, (n, 2))
    rois = np.concatenate([ctr - wh / 2, ctr + wh / 2], axis=1).astype(np.float32)
    deltas = rng.normal(0, 0.3, (n, 4)).astype(np.float32)
    return rois, deltas


def test_decode_and_clip_within_an_ulp(rng):
    rois, deltas = _rois_deltas(rng, 5000)
    want = np.asarray(jb.clip_boxes(jb.decode(rois, deltas), (150, 170)))
    got = tb.clip_boxes(tb.decode(torch.from_numpy(rois), torch.from_numpy(deltas)), (150, 170)).numpy()
    np.testing.assert_allclose(got, want, atol=DECODE_ATOL, rtol=0)
    np.testing.assert_array_equal(tb.clip_boxes(torch.from_numpy(want.copy()), (150, 170)).numpy(), np.asarray(jb.clip_boxes(want, (150, 170))))
    np.testing.assert_array_equal(tb.change_order(torch.from_numpy(rois)).numpy(), np.asarray(jb.change_order(rois)))


def _nms_case(rng, n):
    """Boxes (y1, x1, y2, x2) with many equal scores, exact duplicates of
    boxes, and pairs of 10x10 boxes overlapping by about one pixel, whose
    IoU lies near the 0.01 threshold."""
    y = rng.integers(0, 120, n).astype(np.float32)
    x = rng.integers(0, 120, n).astype(np.float32)
    h = rng.integers(3, 30, n).astype(np.float32)
    w = rng.integers(3, 30, n).astype(np.float32)
    boxes = np.stack([y, x, y + h, x + w], axis=1)
    boxes[n // 4 : n // 4 + 10] = boxes[:10]  # exact duplicates
    ties = np.array([[200, 200, 210, 210], [209, 209, 219.1, 219.1], [300, 300, 310, 310],
                     [309.0, 309.5, 319.0, 319.5], [400, 400, 410, 410], [409.5, 409.5, 419.5, 419.5]], np.float32)
    boxes = np.concatenate([boxes, ties])
    scores = np.round(rng.random(len(boxes)), 2).astype(np.float32)  # many equal scores
    scores[-6:] = [0.9, 0.8, 0.9, 0.8, 0.9, 0.8]
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thresh", [0.01, 0.3])
def test_nms_matches_nms_jax_and_nms_numpy(seed, thresh):
    rng = np.random.default_rng(seed)
    boxes, scores = _nms_case(rng, 300)
    order = np.argsort(-scores, kind="stable")
    sb, ss = boxes[order], scores[order]
    idx, valid = jb.nms_jax(jnp.asarray(sb), jnp.asarray(ss), 800, thresh)
    want = np.asarray(idx)[np.asarray(valid)]
    got = tb.nms_sorted(torch.from_numpy(sb), torch.ones(len(sb), dtype=torch.bool), 800, thresh)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(order[got], jb.nms_numpy(boxes, scores, 800, thresh))
    # a smaller budget cuts the same selection
    idx, valid = jb.nms_jax(jnp.asarray(sb), jnp.asarray(ss), 5, thresh)
    np.testing.assert_array_equal(tb.nms_sorted(torch.from_numpy(sb), torch.ones(len(sb), dtype=torch.bool), 5, thresh),
                                  np.asarray(idx)[np.asarray(valid)])


def test_nms_iou_exactly_at_threshold_does_not_suppress():
    b = torch.tensor([[0, 0, 10, 10], [9, 9, 19, 19.0]])  # IoU = 1 / 199
    assert not tb.suppression_matrix(b, 1 / 199)[0, 1]
    b = torch.tensor([[0, 0, 10, 10], [0, 9, 10, 19.0]])  # inter 10, union 190
    assert tb.suppression_matrix(b, 0.05)[0, 1] == bool(np.float32(10) / np.float32(190) > np.float32(0.05))


def test_nms_skips_invalid_entries():
    rng = np.random.default_rng(5)
    boxes, scores = _nms_case(rng, 50)
    order = np.argsort(-scores, kind="stable")
    sb, ss = boxes[order], scores[order].copy()
    ss[-20:] = -np.inf
    sb[-20:] = 0.0
    idx, valid = jb.nms_jax(jnp.asarray(sb), jnp.asarray(ss), 800, 0.01)
    got = tb.nms_sorted(torch.from_numpy(sb), torch.from_numpy(ss > -np.inf), 800, 0.01)
    np.testing.assert_array_equal(got, np.asarray(idx)[np.asarray(valid)])
    assert tb.nms_sorted(torch.zeros((0, 4)), torch.zeros(0, dtype=torch.bool), 800, 0.01).size == 0


def test_stable_descending_sort_orders_ties_as_top_k():
    rng = np.random.default_rng(7)
    scores = np.round(rng.random(3000), 1).astype(np.float32)
    scores[rng.integers(0, 3000, 300)] = -np.inf
    vals, idx = jax.lax.top_k(jnp.asarray(scores), 2000)
    s, i = torch.sort(torch.from_numpy(scores), descending=True, stable=True)
    np.testing.assert_array_equal(i[:2000].numpy(), np.asarray(idx))
    np.testing.assert_array_equal(s[:2000].numpy(), np.asarray(vals))
