"""The port's training data (``ecseg_torch/runtime/data.py``) against the JAX
package's (``ecseg_tpu/runtime/data.py``): the pairs a metaseg-format
folder gives, the skips, the random crops byte for byte, and
``pad_to_multiple`` against ``ecseg_tpu/parallel/mesh.py``'s.  Exact
equality throughout: both are numpy on the same decoded bytes and the same
generator draws."""

import cv2
import numpy as np
import pytest

from ecseg_tpu.parallel.mesh import pad_to_multiple as jax_pad
from ecseg_tpu.runtime import data as jd
from ecseg_torch.runtime import data as td


def _write_pair(d, name, img, lab=None):
    assert cv2.imwrite(str(d / f"{name}.tif"), img)
    if lab is not None:
        np.save(str(d / "labels" / f"{name}.npy"), lab)


def _training_folder(d, rng):
    """tests/test_training_e2e.py's folder: two 300x330 uint16 images
    (cv2's compressed TIFF) with a bright block labelled 1."""
    (d / "labels").mkdir(parents=True)
    for k in range(2):
        img = (rng.random((300, 330)) * 4000).astype(np.uint16)
        img[60:200, 80:260] = 52000
        lab = np.zeros((300, 330), np.int64)
        lab[60:200, 80:260] = 1
        _write_pair(d, f"t{k}", img, lab)
    return d


def _assert_pairs_equal(got, want):
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == np.uint8 and gl.dtype == wl.dtype == np.int32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_load_training_pairs_matches_jax(tmp_path, rng):
    d = _training_folder(tmp_path / "f", rng)
    got, want = td.load_training_pairs(str(d)), jd.load_training_pairs(str(d))
    assert len(got) == 2
    _assert_pairs_equal(got, want)


def test_skips_match_jax(tmp_path, rng):
    """A missing ``labels/<name>.npy`` and a side under 256 are skipped; an
    image and labels of different sizes are cut to the common size; an RGB
    uint8 image goes through meta_preprocess's blue channel."""
    d = _training_folder(tmp_path / "f", rng)
    _write_pair(d, "nolabel", (rng.random((300, 300)) * 255).astype(np.uint8))
    _write_pair(d, "small", (rng.random((200, 200)) * 255).astype(np.uint8), np.ones((200, 200), np.int64))
    _write_pair(d, "narrow", (rng.random((400, 255)) * 255).astype(np.uint8), np.ones((400, 300), np.int64))
    _write_pair(d, "bigger_labels", (rng.random((280, 270)) * 255).astype(np.uint8), rng.integers(0, 4, (290, 300)))
    _write_pair(d, "rgb", (rng.random((260, 261, 3)) * 255).astype(np.uint8), rng.integers(0, 4, (260, 261)))
    got, want = td.load_training_pairs(str(d)), jd.load_training_pairs(str(d))
    assert len(got) == 4
    assert sorted(p[0].shape for p in got) == sorted([(300, 330), (300, 330), (280, 270), (260, 261)])
    _assert_pairs_equal(got, want)
    assert td.load_training_pairs(str(tmp_path / "empty")) == jd.load_training_pairs(str(tmp_path / "empty")) == []


@pytest.mark.parametrize("augment", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_crop_batches_byte_equal_to_jax(tmp_path, rng, seed, augment):
    pairs = td.load_training_pairs(str(_training_folder(tmp_path / "f", rng)))
    got = list(td.crop_batches(pairs, 5, 4, seed=seed, augment=augment))
    want = list(jd.crop_batches(pairs, 5, 4, seed=seed, augment=augment))
    assert len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape == (5, 256, 256, 1) and gx.dtype == np.uint8
        assert gy.shape == (5, 256, 256) and gy.dtype == np.int32
        assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()
    assert list(td.crop_batches([], 5, 4)) == []


@pytest.mark.parametrize("n,multiple", [(5, 1), (5, 4), (8, 4), (1, 3)])
def test_pad_to_multiple_matches_jax(n, multiple):
    x = np.arange(n * 6, dtype=np.int32).reshape(n, 2, 3) + 1
    got, gn = td.pad_to_multiple(x, multiple)
    want, wn = jax_pad(x, multiple)
    assert gn == wn == n and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
