"""The port's NuSeT inference (ecseg_torch/models/nuset_infer.py) against
ecseg_tpu/models/nuset_infer.py on the crafted NuSeT weights: the uint8
{0, 255} ``nuclei_segment`` byte-equal to the JAX package's device branch
(the certified watershed, ``_cleanup_pass`` on its Pallas kernels in
interpret mode) and to its host chain, at 160^2 and at a geometry that is
not a multiple of 16; with an RPN whose scores clear ``min_score``, so the
watershed runs with markers; the proposal pass against ``_proposal_pass``;
and the device cleanup against the host chain at resize_scale 0.3 and 1."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecseg_tpu.models import nuset_infer as jni
from ecseg_torch.models import nuset_infer as tni
from ecseg_tpu.ops import boxes as jb
from ecseg_tpu.ops.packing import unpack_mask_1bit
from ecseg_torch.models.weights import nuset_from_numpy
from ecseg_torch.ops.morphology import remove_small_objects
from ecseg_torch.ops.normalization import clean_image, foreground_norm
from ecseg_torch.ops.resize import rescale
from ecseg_torch.ops.watershed import nuset_place_markers

from _nusetutil import crafted_nuset_model
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

DECODE_ATOL = 256 * 2.0**-23  # as tests/test_torch_boxes.py: an ulp of the largest coordinate


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _confident(rpn):
    """The RPN with a class-1 score bias of 6 on every anchor: every
    proposal scores about 0.9975, above min_score 0.95."""
    rpn = _np(rpn)
    bias = np.zeros_like(rpn["rpn_cls_score"]["bias"])
    bias[1::2] = 6.0
    rpn["rpn_cls_score"] = {"kernel": rpn["rpn_cls_score"]["kernel"], "bias": bias}
    return rpn


@functools.lru_cache(maxsize=None)
def _models(resize_scale, confident):
    """(JAX model, port model on the CPU) with the same weights."""
    jm = crafted_nuset_model(resize_scale=resize_scale)
    if confident:
        jm = dataclasses.replace(jm, rpn_fg=jax.tree.map(jnp.asarray, _confident(jm.rpn_fg)))
    whole, fg, rpn = nuset_from_numpy({"whole": _np(jm.unet_whole), "fg": {"unet": _np(jm.unet_fg), "rpn": _np(jm.rpn_fg)}})
    tm = tni.NuSeTModel(whole.eval(), fg.eval(), rpn.eval(), jm.nms_threshold, jm.bbox_min_score, resize_scale)
    return jm, tm


def _blue(h, w, seed):
    """A DAPI channel: dim background, bright nuclei, two of them touching."""
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w)) * 30).astype(np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for cy, cx, r in ((0.3, 0.3, 0.17), (0.3, 0.55, 0.15), (0.72, 0.7, 0.18), (0.75, 0.25, 0.12)):
        img[(yy - cy * h) ** 2 + (xx - cx * w) ** 2 <= (r * min(h, w)) ** 2] = 220
    return img


def _jax_segment(monkeypatch, image, model, device):
    monkeypatch.setenv("ECSEG_DEVICE_PIPELINE", "1" if device else "0")
    monkeypatch.delenv("ECSEG_FAST_WATERSHED", raising=False)
    monkeypatch.setenv("ECSEG_NUSET_BUCKET", "0")
    return jni.nuclei_segment(image, model, 60, device_cleanup=device)


CASES = [  # (image h, w, resize_scale, confident RPN)
    (160, 160, 0.3, False),
    (150, 170, 0.3, False),
    (128, 112, 1, True),
    (141, 133, 1, True),
]


@pytest.mark.parametrize("h,w,scale,confident", CASES, ids=[f"{c[0]}x{c[1]}-s{c[2]}-{'markers' if c[3] else 'plain'}" for c in CASES])
def test_nuclei_segment_matches_jax(monkeypatch, h, w, scale, confident):
    jm, tm = _models(scale, confident)
    image = _blue(h, w, seed=h)
    got = tni.nuclei_segment(image, tm, 60)
    got_host = tni.nuclei_segment(image, tm, 60, device_cleanup=False)
    want_dev = _jax_segment(monkeypatch, image, jm, True)
    want_host = _jax_segment(monkeypatch, image, jm, False)
    assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    assert got.shape == want_dev.shape
    np.testing.assert_array_equal(got, want_dev)
    np.testing.assert_array_equal(got_host, want_host)
    np.testing.assert_array_equal(got, got_host)
    assert got.any()


def test_confident_rpn_places_markers():
    """The confident RPN's proposals place markers, so the cases above run
    the device watershed with markers, not its pass-through."""
    jm, tm = _models(1, True)
    image = _blue(128, 112, seed=128)
    pre = tni.nuclei_segment_prepare(image, 1)
    masks1 = tni.nuset_forward(tm, pre[1], pass_two=False)
    mask, props, scores = tni.mask_and_proposals(tm, foreground_norm(pre[0], masks1))
    markers = nuset_place_markers(scores, props, mask, 0.95)
    assert markers is not None and markers.max() >= 2


@pytest.mark.parametrize("hw", [(64, 48), (96, 80)], ids=["64x48", "96x80"])
def test_proposal_pass_matches_jax(hw):
    jm, tm = _models(1, True)
    rng = np.random.default_rng(hw[0])
    x = rng.normal(0, 1, hw).astype(np.float32)
    with torch.no_grad():
        _, feat = tm.unet_fg(torch.from_numpy(x)[None, None])
        props, scores = tni.proposal_pass(tm, feat, 11.0, hw)
    ref = jb.generate_anchors_reference(11.0, jni.RATIOS, jni.SCALES)
    anchors = jb.generate_anchors(ref, 16, (hw[0] // 16, hw[1] // 16))
    jfeat = jnp.asarray(feat.permute(0, 2, 3, 1).numpy())
    packed = np.asarray(jni._proposal_pass_packed(jm.rpn_fg, jfeat, jnp.asarray(anchors), hw, jm.nms_threshold))
    valid = packed[:, 5] > 0.5
    assert len(props) == valid.sum() > 0
    np.testing.assert_allclose(props, packed[valid, :4], atol=DECODE_ATOL, rtol=0)
    np.testing.assert_allclose(scores, packed[valid, 4], atol=1e-6, rtol=0)


def _blob_mask(rng, h, w, n):
    yy, xx = np.ogrid[:h, :w]
    m = np.zeros((h, w), bool)
    for _ in range(n):
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(2, 9)
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    m[rng.random((h, w)) < 0.01] ^= True  # specks and pinholes for the size rules
    return m.astype(np.float32)


@pytest.mark.parametrize("scale", [0.3, 1])
def test_cleanup_pass_matches_host_chain_and_jax(scale):
    rng = np.random.default_rng(int(scale * 10))
    for k in range(3):
        mask = _blob_mask(rng, 48, 64, 12)
        if k == 2:
            mask[:] = 0  # the hi == lo quirk: an empty mask
        out_hw = tni.output_shape(mask.shape, scale)
        got = tni.cleanup_pass(mask, out_hw, 60, "cpu")
        host = clean_image(mask)
        if scale != 1:
            host = rescale(host, 1 / scale)
        lo, hi = host.min(), host.max()
        with np.errstate(invalid="ignore", divide="ignore"):
            i8 = (((host - lo) / (hi - lo)) * 255).astype(np.uint8)
        want = remove_small_objects(i8 > 0, 60).astype(np.uint8) * 255
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tni.cleanup_host(mask, scale, 60), want)
        jax_packed = np.asarray(jni._cleanup_pass(jnp.asarray(mask), out_hw, 60))
        np.testing.assert_array_equal(got, unpack_mask_1bit(jax_packed, out_hw[1]) * np.uint8(255))
