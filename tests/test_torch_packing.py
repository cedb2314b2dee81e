"""The port's transfer packing (ecseg_torch/ops/packing.py) against
ecseg_tpu/ops/packing.py byte for byte, metaseg's per-canvas blob
(``pipelines/metaseg.post_blob`` / ``decode_post_blob``) against the JAX
package's ``_post_blob`` / ``_decode_post_blob`` (its Pallas entries as the
JAX suite runs them on the CPU), the grouped post's one copy, and the
packed matched filter against the JAX ``get_thresholded_device_packed``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ecseg_tpu.ops import matched_filter as jmf
from ecseg_tpu.ops import packing as jpk
from ecseg_tpu.pipelines import metaseg as jms
from ecseg_tpu.runtime import fallbacks as jfallbacks
from ecseg_torch.ops import matched_filter as tmf
from ecseg_torch.ops import packing as tpk
from ecseg_torch.ops.cc import count_cc
from ecseg_torch.ops.meta_post import meta_inference
from ecseg_torch.pipelines import metaseg as tms
from ecseg_torch.runtime import fallbacks

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

WIDTHS = (1, 13, 208, 256, 2027)  # 1 and 13 are not multiples of 4 or 8; 2027 is stat_fish's 2048 crop at /16
ROWS = 5


def _labels(w, seed=0):
    return np.random.default_rng(seed + w).integers(0, 4, (ROWS, w)).astype(np.int64)


def _mask(w, seed=0):
    return np.random.default_rng(seed + w).random((ROWS, w)) < 0.4


@pytest.mark.parametrize("w", WIDTHS)
def test_labels_2bit_bytes_equal_jax(w):
    lab = _labels(w)
    got = tpk.pack_labels_2bit(torch.from_numpy(lab)).numpy()
    want = np.asarray(jpk.pack_labels_2bit_jax(jnp.asarray(lab)))
    assert got.dtype == want.dtype == np.uint8 and got.shape == (ROWS, -(-w // 4))
    np.testing.assert_array_equal(got, want)
    back = tpk.unpack_labels_2bit(got, w)
    np.testing.assert_array_equal(back, jpk.unpack_labels_2bit(want, w))
    np.testing.assert_array_equal(back, lab)


@pytest.mark.parametrize("w", WIDTHS)
def test_mask_1bit_bytes_equal_jax(w):
    m = _mask(w)
    got = tpk.pack_mask_1bit(torch.from_numpy(m)).numpy()
    want = np.asarray(jpk.pack_mask_1bit_jax(jnp.asarray(m)))
    assert got.dtype == want.dtype == np.uint8 and got.shape == (ROWS, -(-w // 8))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpk.pack_mask_1bit_host(m), jpk.pack_mask_1bit_host(m))
    np.testing.assert_array_equal(tpk.pack_mask_1bit_host(m), got)
    host = tpk.unpack_mask_1bit(got, w)
    np.testing.assert_array_equal(host, jpk.unpack_mask_1bit(want, w))
    device = tpk.unpack_mask_1bit_device(torch.from_numpy(got), w).numpy()
    np.testing.assert_array_equal(device, np.asarray(jpk.unpack_mask_1bit_jax(jnp.asarray(want), w)))
    np.testing.assert_array_equal(host, m.astype(np.uint8))
    np.testing.assert_array_equal(device, host)


def test_nonzero_values_pack_as_set_bits():
    m = np.array([[0, 3, -1, 0, 255, 0, 0, 7, 1]], np.int32)
    got = tpk.pack_mask_1bit(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpk.pack_mask_1bit_jax(jnp.asarray(m))))
    np.testing.assert_array_equal(tpk.unpack_mask_1bit(got, m.shape[1]), (m != 0).astype(np.uint8))


def test_fetch_counts_bytes_and_copies():
    tpk.reset_fetched()
    a = tpk.fetch(torch.zeros((3, 7), dtype=torch.uint8))
    b = tpk.fetch(torch.zeros(5, dtype=torch.int32))
    assert a.shape == (3, 7) and b.dtype == np.int32
    assert tpk.FETCHED["bytes"] == 21 + 20 and tpk.FETCHED["copies"] == 2 and tpk.FETCHED["seconds"] >= 0
    tpk.reset_fetched()
    assert tpk.FETCHED == {"bytes": 0, "copies": 0, "seconds": 0.0}


def _ec_canvas(seed=0, shape=(256, 260)):
    """A 4-class canvas whose ecDNA count needs two header bytes: ecDNA
    squares on a jittered grid, a few chromosomes and nuclei."""
    rng = np.random.default_rng(seed)
    img = np.zeros(shape, np.int32)
    for y in range(2, shape[0] - 8, 9):
        for x in range(2, shape[1] - 8, 9):
            s = int(rng.integers(4, 7))
            img[y : y + s, x : x + s] = 3
    for _ in range(6):
        y, x = rng.integers(0, shape[0] - 24), rng.integers(0, shape[1] - 24)
        img[y : y + 20, x : x + 12] = 2
    img[100:140, 100:150] = 1
    return img


def _budget_overflow():
    """2304 one-pixel nuclei, over the device post's budget (``ok`` False),
    as tests/test_fallbacks.py builds it."""
    img = np.zeros((96, 96), np.int32)
    img[::2, ::2] = 1
    return img


CANVASES = {"ec_count_above_255": _ec_canvas, "budget_overflow": _budget_overflow}


@pytest.mark.parametrize("name", sorted(CANVASES))
def test_post_blob_equals_jax(name):
    """The blob's bytes equal the JAX package's, and so does its decode
    (with the fallback counted on both sides when ``ok`` is False)."""
    img = CANVASES[name]()
    want = np.asarray(jms._post_blob_jit(jnp.asarray(img)))
    got = tms.post_blob(torch.from_numpy(img)).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == (img.shape[0] + 1, -(-img.shape[1] // 4))
    np.testing.assert_array_equal(got, want)
    fallbacks.reset()
    jfallbacks.reset()
    ok, labels, num_ec = tms.decode_post_blob(got, img.shape[1])
    jok, jlabels, jnum = jms._decode_post_blob(want, img.shape[1])
    assert (ok, num_ec) == (jok, jnum)
    assert labels.dtype == jlabels.dtype == np.int64
    np.testing.assert_array_equal(labels, jlabels)
    assert fallbacks.counts() == jfallbacks.counts() == ({} if ok else {fallbacks.META_POST_OK: 1})
    if name == "ec_count_above_255":
        assert ok and num_ec > 255 and got[0, 2] != 0
        want_labels = meta_inference(img.astype(np.int64))
        np.testing.assert_array_equal(labels, want_labels)
        assert num_ec == count_cc(want_labels == 3)[0]
    else:
        assert not ok
    fallbacks.reset()
    jfallbacks.reset()


def test_post_group_makes_one_copy_and_redoes_only_the_failed_canvas():
    """A group's blobs cross in one copy; only the canvas whose ``ok`` is
    False has its raw map fetched (a second copy) and is redone on the
    host, counted once."""
    good = _ec_canvas(1, (96, 96))
    bad = CANVASES["budget_overflow"]()
    fallbacks.reset()
    tpk.reset_fetched()
    out = tms.post_group([torch.from_numpy(good), torch.from_numpy(bad)])
    blob_bytes = 2 * 97 * 24
    assert tpk.FETCHED["copies"] == 2 and tpk.FETCHED["bytes"] == blob_bytes + bad.nbytes
    assert fallbacks.counts() == {fallbacks.META_POST_OK: 1}
    for (labels, num_ec, ok), img, want_ok in zip(out, (good, bad), (True, False)):
        want = meta_inference(img.astype(np.int64))
        assert ok == want_ok and labels.dtype == np.int64
        np.testing.assert_array_equal(labels, want)
        assert num_ec == count_cc(want == 3)[0]
    fallbacks.reset()
    tpk.reset_fetched()


def test_post_blob_refuses_a_canvas_too_narrow_for_its_header():
    with pytest.raises(ValueError, match="too narrow"):
        tms.post_blob(torch.zeros((8, 16), dtype=torch.int32))


@pytest.mark.parametrize("mask_value", [255, 0])
def test_matched_filter_packed_equals_jax(mask_value):
    """``get_thresholded_device_packed`` on the CPU against the JAX
    function at 256x208 with two FISH channels and a {0, 255} mask (and an
    empty mask), and against the host chain."""
    h, w = 256, 208
    rng = np.random.default_rng(11)
    I = (rng.random((h, w, 3)) * 90).astype(np.uint8)
    for c in (1, 2):
        I[..., c][rng.random((h, w)) < 0.02] = 240
    yy, xx = np.ogrid[:h, :w]
    cells = (((yy - 120) ** 2 + (xx - 100) ** 2) <= 80**2).astype(np.uint8) * np.uint8(mask_value)
    args = (I, cells, 3.0, 15.0, [70, 70], [7, 7])
    tpk.reset_fetched()
    got = tmf.get_thresholded_device_packed(*args, "cpu")
    assert tpk.FETCHED["copies"] == 1 and tpk.FETCHED["bytes"] == 2 * h * (w // 8)
    want = jmf.get_thresholded_device_packed(*args)
    assert got.dtype == want.dtype == np.int32 and got.shape == (h, w, 2) and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tmf.get_thresholded(*args))
    assert got.any() == bool(mask_value)
    tpk.reset_fetched()
