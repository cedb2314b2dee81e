"""The reference-API helpers that no pipeline calls, each against its JAX
package counterpart on one seeded CPU case: metaseg's ``meta_segment`` and
``load_params``, fish_distance's ``get_distances_img`` and
``get_distances_path``, ``meta_post.intensity_metrics``, the matched
filter's ``cell_splice_segmentation`` and ``count_blobs``,
``morphology.binary_opening``, ``threshold.otsu_binarize`` (the JAX side is
cv2's Otsu), tiling's ``patches2im_overlap``, ``stitch_labels_host`` and
``img_as_ubyte_float``, ``boxes.nms_numpy`` and ``encode``,
``conv_host.conv2d_valid_tf`` and ``mesh.shard_patch_batch``.  Exact
equality throughout, except ``encode`` (float32 log and division: 1e-6
relative)."""

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_tpu.ops import boxes as jboxes
from ecseg_tpu.ops import cc as jcc
from ecseg_tpu.ops import conv_host as jconv
from ecseg_tpu.ops import matched_filter as jmf
from ecseg_tpu.ops import meta_post as jmp
from ecseg_tpu.ops import morphology as jmorph
from ecseg_tpu.ops import threshold as jthr
from ecseg_tpu.ops import tiling as jtiling
from ecseg_tpu.parallel import mesh as jmesh
from ecseg_tpu.pipelines import fish_distance as jfd
from ecseg_tpu.pipelines import metaseg as jms
from ecseg_torch.models.weights import params_to_numpy
from ecseg_torch.ops import boxes as tboxes
from ecseg_torch.ops import cc as tcc
from ecseg_torch.ops import conv_host as tconv
from ecseg_torch.ops import matched_filter as tmf
from ecseg_torch.ops import meta_post as tmp
from ecseg_torch.ops import morphology as tmorph
from ecseg_torch.ops import threshold as tthr
from ecseg_torch.ops import tiling as ttiling
from ecseg_torch.parallel import mesh as tmesh
from ecseg_torch.pipelines import fish_distance as tfd
from ecseg_torch.pipelines import metaseg as tms

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_fish_distance import _folder, _synthetic
from test_torch_metaseg_pipeline import _crafted_tiny_params

ENCODE_RTOL = 1e-6


def _rng():
    return np.random.default_rng(2024)


def _metaseg_model_dir(tmp_path):
    d = tmp_path / "models"
    d.mkdir()
    save_npz_pytree(str(d / "metaseg.npz"), _crafted_tiny_params())
    return str(d)


def case_meta_segment(tmp_path, monkeypatch):
    rng = _rng()
    img = (rng.random((320, 384)) * 60).astype(np.uint8)
    img[40:120, 50:130] = 200
    img[200:210, 200:206] = 180
    img[250:253, 300:303] = 230
    path = str(tmp_path / "sample.tif")
    cv2.imwrite(path, img)
    models = _metaseg_model_dir(tmp_path)
    got = tms.meta_segment(tms.load_params(models, device="cpu"), path, save_dapi=False)
    want = jms.meta_segment(jms.load_params(models), path, save_dapi=False)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def case_load_params(tmp_path, monkeypatch):
    models = _metaseg_model_dir(tmp_path)
    params, _ = jms.load_params(models)
    got = params_to_numpy(tms.load_params(models, device="cpu"))
    assert sorted(got) == sorted(params)
    for name, leaves in params.items():
        for key in ("kernel", "bias"):
            np.testing.assert_array_equal(got[name][key], np.asarray(leaves[key]))


def case_get_distances_img(tmp_path, monkeypatch):
    lsq, seg = _synthetic(_rng())
    for presets in ((0, 1, 10), (1, 0, 3), (0, 2, 0)):
        assert tfd.get_distances_img(lsq, seg, presets) == jfd.get_distances_img(lsq, seg, presets)


def case_get_distances_path(tmp_path, monkeypatch):
    root = str(tmp_path / "fish")
    _folder(root, False, monkeypatch)
    got = tfd.get_distances_path(root, 1, 0, 3)
    assert got == jfd.get_distances_path(root, 1, 0, 3) and len(got) > 5


def case_intensity_metrics(tmp_path, monkeypatch):
    I = (_rng().random((60, 70)) * 300).astype(np.uint16)
    I[I < 120] = 0
    for image in (I, np.zeros((5, 6), np.uint16)):
        np.testing.assert_equal(tmp.intensity_metrics(image), jmp.intensity_metrics(image))


def case_cell_splice_segmentation(tmp_path, monkeypatch):
    lsq, seg = _synthetic(_rng())
    thresh = (lsq.astype(np.int32) > 0) * 255
    for treg, jreg in zip(tcc.regionprops(seg), jcc.regionprops(seg)):
        got = tmf.cell_splice_segmentation(lsq, thresh, seg, treg)
        want = jmf.cell_splice_segmentation(lsq, thresh, seg, jreg)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]


def case_count_blobs(tmp_path, monkeypatch):
    rng = _rng()
    fish = (rng.random((50, 60)) < 0.15).astype(np.int64) * 255
    cell = np.zeros((50, 60), np.int64)
    cell[5:45, 8:55] = 1
    for min_cc_size in (1, 2, 3):
        got_fish, want_fish = fish.copy(), fish.copy()
        got = tmf.count_blobs(got_fish, cell, min_cc_size)
        assert got == jmf.count_blobs(want_fish, cell, min_cc_size)
        np.testing.assert_array_equal(got_fish, want_fish)
    assert not np.array_equal(got_fish, fish)  # blobs under 3 pixels came out in place


def case_binary_opening(tmp_path, monkeypatch):
    m = _rng().random((70, 90)) < 0.55
    for fp in (tmorph.diamond(1), tmorph.disk(2), np.ones((2, 3), bool)):
        got = tmorph.binary_opening(m, fp)
        np.testing.assert_array_equal(got, jmorph.binary_opening(m, fp))
    assert got.any() and not np.array_equal(got, m)


def case_otsu_binarize(tmp_path, monkeypatch):
    rng = _rng()
    bimodal = np.where(rng.random((80, 90)) < 0.3, rng.normal(190, 20, (80, 90)), rng.normal(60, 25, (80, 90)))
    for img in ((rng.random((64, 64)) * 255).astype(np.uint8), np.clip(bimodal, 0, 255).astype(np.uint8),
                np.full((9, 9), 7, np.uint8)):
        t, th = tthr.otsu_binarize(img)
        jt, jth = jthr.otsu_binarize(img)
        assert t == jt and th.dtype == jth.dtype
        np.testing.assert_array_equal(th, jth)


GEOMETRIES = ((256, 256), (300, 330), (462, 874), (700, 700))  # 700x700: the quirk where a patch column equals h_l


def case_patches2im_overlap(tmp_path, monkeypatch):
    rng = _rng()
    for h, w in GEOMETRIES:
        _, patches, pos = ttiling.im2patches_overlap(np.zeros((h, w, 1), np.uint8))
        preds = rng.random((len(pos), 256, 256, 3))
        got = ttiling.patches2im_overlap(preds, pos)
        want = jtiling.patches2im_overlap(preds, pos)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def case_stitch_labels_host(tmp_path, monkeypatch):
    rng = _rng()
    for h, w in GEOMETRIES:
        _, _, pos = ttiling.im2patches_overlap(np.zeros((h, w, 1), np.uint8))
        labels = rng.integers(0, 4, (len(pos), 256, 256)).astype(np.uint8)
        got = ttiling.stitch_labels_host(labels, pos)
        want = jtiling.stitch_labels_host(labels, pos)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def case_img_as_ubyte_float(tmp_path, monkeypatch):
    x = np.concatenate([_rng().random(500), np.arange(256) / 255, (np.arange(256) + 0.5) / 255, [-0.1, 1.2]])
    got = ttiling.img_as_ubyte_float(x.astype(np.float32))
    np.testing.assert_array_equal(got, jtiling.img_as_ubyte_float(x.astype(np.float32)))
    np.testing.assert_array_equal(ttiling.img_as_ubyte_float(x), jtiling.img_as_ubyte_float(x))


def case_nms_numpy(tmp_path, monkeypatch):
    rng = _rng()
    yx = rng.random((300, 2)) * 200
    boxes = np.concatenate([yx, yx + rng.random((300, 2)) * 40 + 1], axis=1).astype(np.float32)
    scores = np.round(rng.random(300), 2).astype(np.float32)  # ties
    for max_output, thr in ((800, 0.01), (50, 0.3), (300, 0.7)):
        got = tboxes.nms_numpy(boxes, scores, max_output, thr)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, jboxes.nms_numpy(boxes, scores, max_output, thr))


def case_encode(tmp_path, monkeypatch):
    rng = _rng()
    xy = rng.random((64, 2)) * 300
    a = np.concatenate([xy, xy + rng.random((64, 2)) * 50 + 2], axis=1).astype(np.float32)
    g = (a + rng.normal(0, 0.5, a.shape)).astype(np.float32)
    for variances in (None, [0.1, 0.2]):
        got = tboxes.encode(a, g, variances).numpy()
        want = np.asarray(jboxes.encode(a, g, variances))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=ENCODE_RTOL, atol=0)


def case_conv2d_valid_tf(tmp_path, monkeypatch):
    rng = _rng()
    x = rng.random((40, 37))
    for k in (rng.random((3, 3)), np.array([[0, 1], [-1, 0]], np.float64), np.ones((5, 1))):
        got = tconv.conv2d_valid_tf(x, k)
        np.testing.assert_array_equal(got, jconv.conv2d_valid_tf(x, k))
    assert tconv.conv2d_valid_tf(np.arange(12, dtype=np.int64).reshape(3, 4), np.ones((2, 2), np.int64)).dtype == np.int64


def case_shard_patch_batch(tmp_path, monkeypatch):
    batch = np.arange(8 * 4 * 4 * 1, dtype=np.float32).reshape(8, 4, 4, 1)
    for n, model_axis in ((4, 1), (4, 2), (8, 2)):
        jm = jmesh.make_mesh(n, model_axis)
        arr = jax.device_put(jnp.asarray(batch), jmesh.shard_patch_batch(jm))
        want = [np.asarray(next(s.data for s in arr.addressable_shards if s.device == d)) for d in jm.devices.flat]
        got = tmesh.shard_patch_batch(tmesh.make_mesh(["cpu"] * n, model_axis=model_axis), torch.from_numpy(batch))
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name, tmp_path, monkeypatch):
    CASES[name](tmp_path, monkeypatch)
