"""NuSeT's prep on a device tensor (``ops/resize.rescale_device``,
``normalization.*_device``, ``nuset_infer.prepare_device``) against the
host chain it replaces on the card, ``stat_fish.segment_folder`` against
per-image ``nuclei_segment``, NuSeT's stages and counters, and the NMS's
fetch through ``packing.fetch``.  CPU only: the device forms run on CPU
tensors, and the device route of ``nuclei_segment`` is taken by setting
``nuset_infer.prep_on_device``."""

import io
import math
import threading
import warnings

import numpy as np
import pytest
import torch

from ecseg_torch.core import imgio
from ecseg_torch.models import nuset_infer as ni
from ecseg_torch.models.demo import demo_nuset_tree
from ecseg_torch.models.weights import nuset_from_numpy
from ecseg_torch.ops import boxes, packing
from ecseg_torch.ops.normalization import (
    foreground_norm,
    foreground_norm_device,
    median_device,
    whole_image_norm,
    whole_image_norm_device,
)
from ecseg_torch.ops.resize import rescale, rescale_device
from ecseg_torch.pipelines import stat_fish
from ecseg_torch.runtime import trace

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-12


def _u8(shape, seed):
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 40).astype(np.uint8)
    img[shape[0] // 4 : shape[0] // 2, shape[1] // 3 : shape[1] // 2 + 1] = 200
    return img


@pytest.mark.parametrize("shape", [(2048, 2048), (333, 517), (161, 97), (1, 60), (60, 1), (1, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_rescale_device_equals_the_host_rescale(shape):
    img = _u8(shape, sum(shape))
    want = rescale(img, 0.3, anti_aliasing=True)
    got = rescale_device(torch.from_numpy(img), 0.3)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape,scale", [((2048, 2048), 0.3), ((333, 517), 0.3), ((161, 97), 0.5), ((130, 75), 1)],
                         ids=lambda v: str(v))
def test_prepare_device_equals_the_host_prep(shape, scale):
    img = _u8(shape, 7)
    want_img, want_norm = ni.nuclei_segment_prepare(img, scale)
    got_img, got_norm = ni.prepare_device(img, scale, "cpu")
    assert got_norm.dtype == torch.float64 and tuple(got_norm.shape) == want_norm.shape
    assert all(d % 16 == 0 for d in want_norm.shape)
    np.testing.assert_allclose(got_img.numpy(), want_img, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_norm.numpy(), want_norm, rtol=0, atol=TOL)
    np.testing.assert_allclose(whole_image_norm_device(torch.from_numpy(want_img)).numpy(), whole_image_norm(want_img),
                               rtol=0, atol=TOL)


def test_rescale_device_refuses_an_upscale_and_other_dtypes():
    with pytest.raises(ValueError, match="downscales"):
        rescale_device(torch.zeros((8, 8), dtype=torch.uint8), 2.0)
    with pytest.raises(TypeError, match="uint8"):
        rescale_device(torch.zeros((8, 8)), 0.5)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 999, 1000])
def test_foreground_norm_device_takes_numpys_median(n):
    """An even count takes the mean of the two middle values (numpy's
    median), not ``torch.median``'s lower one."""
    rng = np.random.default_rng(n)
    img = rng.random((40, 40)) * 100
    mask = np.zeros(1600, bool)
    mask[rng.choice(1600, n, replace=False)] = True
    mask = mask.reshape(40, 40)
    got = foreground_norm_device(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), foreground_norm(img, mask.astype(np.float32)), rtol=0, atol=TOL)
    values = torch.from_numpy(img[mask])
    want = np.median(img[mask])
    assert median_device(values).item() == want
    if n % 2 == 0:
        assert torch.median(values).item() != want


def test_foreground_norm_device_drops_zero_values_and_is_nan_on_an_empty_mask():
    img = np.arange(16, dtype=np.float64).reshape(4, 4)  # a zero value under the mask is dropped too
    mask = np.zeros((4, 4), np.float32)
    mask[0, :3] = 1
    got = foreground_norm_device(torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), foreground_norm(img, mask), rtol=0, atol=TOL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = foreground_norm(img, np.zeros((4, 4), np.float32))
    got = foreground_norm_device(torch.from_numpy(img), torch.zeros((4, 4), dtype=torch.bool))
    assert np.isnan(want).all() and torch.isnan(got).all()


def _model():
    tree = demo_nuset_tree(torch.Generator().manual_seed(3))
    tree["fg"]["rpn"]["rpn_cls_score"]["bias"][1::2] = 6.0  # proposals over min_score: the watershed has markers
    whole, fg, rpn = (m.eval() for m in nuset_from_numpy(tree))
    return ni.NuSeTModel(whole, fg, rpn, resize_scale=0.3)


def _folder(tmp_path, n=3, side=224):
    paths = []
    for k in range(n):
        rng = np.random.default_rng(k)
        img = (rng.random((side, side + 16 * k, 3)) * 6000).astype(np.uint16)
        yy, xx = np.ogrid[: img.shape[0], : img.shape[1]]
        for cy, cx, r in ((60, 70, 25), (60, 120, 24), (150, 100 + 8 * k, 30)):
            img[..., 2][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 44000
        path = str(tmp_path / f"img{k}.tif")
        imgio.write_tiff_lzw(path, img)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.mark.parametrize("device_prep", [False, True], ids=["host-prep", "device-prep"])
def test_segment_folder_yields_per_image_nuclei_segment_in_order(model, tmp_path, monkeypatch, device_prep):
    paths = _folder(tmp_path)
    want = []
    for p in paths:
        I = imgio.u16_to_u8(imgio.imread_bgr8(p))
        seg = ni.nuclei_segment(I[:, :, 0], model, 60)
        want.append((p, I[: seg.shape[0], : seg.shape[1]], seg))
    if device_prep:
        monkeypatch.setattr(ni, "prep_on_device", lambda m, d: True)
    got = list(stat_fish.segment_folder(model, list(reversed(paths)), 60))
    assert [p for p, _, _ in got] == list(reversed(paths))
    for (p, I, seg), (wp, wI, wseg) in zip(got, reversed(want)):
        assert p == wp and seg.dtype == np.uint8 and seg.shape == I.shape[:2]
        np.testing.assert_array_equal(I, wI)
        np.testing.assert_array_equal(seg, wseg)
    assert any(seg.any() for _, _, seg in got)
    assert list(stat_fish.segment_folder(model, [], 60)) == []


def test_segment_folder_runs_each_back_half_on_a_worker_beside_the_next_front(model, tmp_path, monkeypatch):
    """The main thread runs image k + 1's front half before it yields image
    k, whose watershed and cleanup ran on one worker thread; the stages of
    a traced call name both threads' parts."""
    log, front, back = [], ni.nuclei_segment_front, ni.nuclei_segment_back
    main = threading.get_ident()

    def logged_front(*a, **k):
        log.append(("front", sum(e[0] == "front" for e in log), threading.get_ident()))
        return front(*a, **k)

    def logged_back(*a, **k):
        log.append(("back", sum(e[0] == "back" for e in log), threading.get_ident()))
        return back(*a, **k)

    monkeypatch.setattr(ni, "nuclei_segment_front", logged_front)
    monkeypatch.setattr(ni, "nuclei_segment_back", logged_back)
    tr = trace.tracer()
    enabled = tr.enabled
    tr.enabled = True
    tr.reset()
    try:
        for k, _ in enumerate(stat_fish.segment_folder(model, _folder(tmp_path), 60)):
            log.append(("yield", k, threading.get_ident()))
        times = tr.times()
    finally:
        tr.enabled = enabled
        tr.reset()
    order = [(e[0], e[1]) for e in log]
    assert [e for e in order if e[0] == "yield"] == [("yield", k) for k in range(3)]
    for k in range(2):
        assert order.index(("front", k + 1)) < order.index(("yield", k))
        assert order.index(("back", k)) < order.index(("yield", k))
    assert {e[2] for e in log if e[0] != "back"} == {main}
    assert main not in {e[2] for e in log if e[0] == "back"}
    assert {k: len(v) for k, v in times.items() if k.startswith("stat_fish.")} == {
        "stat_fish.decode_wait": 4, "stat_fish.nuclei_segment": 3, "stat_fish.back_wait": 3,
        "stat_fish.watershed": 3, "stat_fish.cleanup": 3}


def test_the_flood_and_the_passes_share_one_lock_a_card(monkeypatch):
    """``card_alone`` is one lock per card, whatever names the card; a CPU
    pass takes none."""
    from ecseg_torch.ops.watershed_gpu import card_alone

    assert card_alone("cuda:0") is card_alone(torch.device("cuda", 0))
    assert card_alone("cuda:0") is not card_alone("cuda:1")
    taken = []
    monkeypatch.setattr(ni, "card_alone", lambda device: taken.append(device) or card_alone(device))
    mask, _, _ = ni.unet_pass(_model().unet_whole, np.zeros((32, 32), np.float32), torch.device("cpu"))
    assert mask.shape == (32, 32) and taken == []


def test_prep_on_device_only_for_a_card_on_the_device_path(model):
    assert not ni.prep_on_device(model, True)  # a CPU model keeps the host chain

    class Fake:
        device = torch.device("cuda", 0)
        resize_scale = 0.3

    assert ni.prep_on_device(Fake(), True) and not ni.prep_on_device(Fake(), False)
    Fake.resize_scale = 2.0
    assert not ni.prep_on_device(Fake(), True)


def test_one_call_opens_nusets_stages_and_counts(model, tmp_path, monkeypatch):
    monkeypatch.setattr(ni, "prep_on_device", lambda m, d: True)
    tr = trace.tracer()
    enabled = tr.enabled
    tr.enabled = True
    tr.reset()
    ni.reset_counts()
    try:
        img = imgio.u16_to_u8(imgio.imread_bgr8(_folder(tmp_path, n=1)[0]))[:, :, 0]
        ni.nuclei_segment(img, model, 60)
        times = tr.times()
        report = tr.report(out=io.StringIO())
    finally:
        tr.enabled = enabled
        tr.reset()
    assert {k: len(v) for k, v in times.items()} == {
        "nuset.prep": 1, "nuset.forward": 2, "nuset.fg_norm": 1, "nuset.proposals": 1,
        "stat_fish.watershed": 1, "stat_fish.cleanup": 1}
    counts = dict(ni.COUNTS)
    assert set(counts) == {"nms_candidates", "nms_kept", "markers"}
    assert 0 < counts["markers"] <= counts["nms_kept"] <= counts["nms_candidates"]
    assert "nuset counts: nms_candidates=" in report
    ni.reset_counts()
    assert not any(ni.COUNTS.values())


def test_the_nms_fetch_is_counted_with_its_candidate_flags():
    """One copy of the packed suppression matrix and the candidates' row:
    (n + 1) rows of ceil(n / 8) bytes; the walk equals the host NMS."""
    rng = np.random.default_rng(2)
    n = 203
    xy = rng.uniform(0, 300, (n, 2)).astype(np.float32)
    wh = rng.uniform(4, 40, (n, 2)).astype(np.float32)
    b = np.concatenate([xy, xy + wh], axis=1)[:, [1, 0, 3, 2]]  # (y1, x1, y2, x2)
    valid = np.ones(n, bool)
    valid[150:] = False
    packing.reset_fetched()
    got = boxes.nms_sorted(torch.from_numpy(b), torch.from_numpy(valid), 800, 0.01)
    assert packing.FETCHED["copies"] == 1 and packing.FETCHED["bytes"] == (n + 1) * math.ceil(n / 8)
    scores = np.where(valid, np.linspace(1, 0.5, n), -np.inf).astype(np.float32)
    np.testing.assert_array_equal(got, boxes.nms_numpy(b[:150], scores[:150], 800, 0.01))
    packed, flags = boxes.fetch_suppression(torch.from_numpy(b), torch.from_numpy(valid), 0.01)
    np.testing.assert_array_equal(flags, valid)
    assert packed.shape == (n, math.ceil(n / 8))
    packing.reset_fetched()


def test_the_proposal_pass_fetches_the_matrix_and_the_kept_boxes(model):
    """The proposal pass's two copies: the matrix with its flags, and the
    kept boxes with their scores (5 float32 each)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (96, 80)).astype(np.float32))[None, None]
    with torch.no_grad():
        _, feat = model.unet_fg(x)
        packing.reset_fetched()
        ni.reset_counts()
        props, scores = ni.proposal_pass(model, feat, 11.0, (96, 80))
    n = min(boxes.PRE_NMS_TOP_N, 6 * 5 * 21)
    assert packing.FETCHED["copies"] == 2
    assert packing.FETCHED["bytes"] == (n + 1) * math.ceil(n / 8) + 20 * len(props)
    assert ni.COUNTS["nms_candidates"] == n and ni.COUNTS["nms_kept"] == len(props) > 0
    assert props.dtype == scores.dtype == np.float32 and props.flags.c_contiguous
    packing.reset_fetched()
    ni.reset_counts()


def _split_nuclei(seed, h, w, n):
    """A mask of n discs, many touching, and two proposals in each: the
    fronts of two markers meet inside every disc, where the EDT ties."""
    rng = np.random.default_rng(seed)
    yy, xx = np.ogrid[:h, :w]
    mask = np.zeros((h, w), bool)
    props = []
    for _ in range(n):
        r = int(rng.integers(8, 15))
        cy, cx = int(rng.integers(24, h - 24)), int(rng.integers(24, w - 24))
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        props += [[cx - r, cy - r, cx, cy + r], [cx, cy - r, cx + r, cy + r]]
    scores = np.linspace(0.99, 0.96, len(props)).astype(np.float32)
    return mask.astype(np.float32), scores, np.array(props, np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_the_certified_watershed_equals_the_host_chain(seed):
    """Certified or not: where the certificate is not clean, the host flood
    of the device pass's inputs (-EDT^2, the dilated markers) gives the host
    chain's result, which floods -EDT."""
    from ecseg_torch.ops.watershed import nuset_marker_watershed
    from ecseg_torch.ops.watershed_gpu import nuset_marker_watershed_auto, nuset_marker_watershed_certified

    mask, scores, props = _split_nuclei(seed, 112, 128, 8)
    packing.reset_fetched()
    got, n_unc = nuset_marker_watershed_certified(scores, props, mask, 0.95, "cpu")
    fetched = dict(packing.FETCHED)
    want = nuset_marker_watershed(scores, props, mask, 0.95)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    auto, auto_unc = nuset_marker_watershed_auto(scores, props, mask, 0.95, "cpu")
    assert n_unc == auto_unc and (auto is None) == bool(n_unc)
    # one copy of the contour and certificate, and with a redo one of both flood inputs
    assert fetched["copies"] == 1 + bool(n_unc)
    assert fetched["bytes"] == 112 * 16 + 4 + bool(n_unc) * 2 * 112 * 128 * 4
    packing.reset_fetched()


def test_the_split_nuclei_are_redone_on_the_host():
    """The cases above hold the redo: the two markers of a disc meet at tied EDT values."""
    from ecseg_torch.ops.watershed_gpu import nuset_marker_watershed_certified

    mask, scores, props = _split_nuclei(0, 112, 128, 8)
    assert nuset_marker_watershed_certified(scores, props, mask, 0.95, "cpu")[1] > 0


def test_imread_bgr8_of_a_16_bit_colour_tiff_rounds_every_sample_as_before(tmp_path):
    """The readers' decode: each 16-bit colour sample x becomes rint(x / 257),
    for all 65536 values, in BGR order."""
    x = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    img = np.stack([x, x[::-1], x.T], axis=-1)
    path = str(tmp_path / "all.tif")
    imgio.write_tiff_lzw(path, img)
    got = imgio.imread_bgr8(path)
    want = np.rint(img[..., ::-1] / 257.0).astype(np.uint8)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
