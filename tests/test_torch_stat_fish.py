"""The port's stat_fish (ecseg_torch/pipelines/stat_fish.py) against the JAX
package's ``stat_fish.main`` on the same synthetic interphase folder and the
same crafted NuSeT weights (``models/nuset.npz``, read by both packages'
loaders): ``stat_fish_lsq.csv`` and ``*__segmentation_min_cut.npy`` byte for
byte, the five TIFFs per image pixel for pixel (read back with cv2), the
``annotated/`` folder protocol, for ``use_min_cut`` True and False and
``scale`` 1 and auto.  The JAX side runs its CPU default, the host chain
(tests/test_device_pipeline_e2e.py holds it byte-equal to its device chain);
the port runs its device path on the CPU.  Also the stat_fish host parts
against the JAX package's and cv2: the min-cut splitter, cv2's L1 distance
transform, ``imread_bgr8``, the TIFF writer, the matched filter (device
twin against ``get_thresholded_jax`` and the host twin) and the params
reader."""

import glob
import os
import pathlib
import sys

import cv2
import numpy as np
import pytest
import yaml
from scipy import ndimage as ndi

import jax

from ecseg_tpu.core.config import Config as JConfig
from ecseg_tpu.core.config import load_config as jload_config
from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_tpu.ops import matched_filter as jmf
from ecseg_tpu.ops import maxflow as jmx
from ecseg_tpu.pipelines import stat_fish as jsf
from ecseg_torch.core import imgio
from ecseg_torch.core.config import Config as TConfig
from ecseg_torch.core.config import StatFishParams, load_config, load_stat_fish_params
from ecseg_torch.ops import matched_filter as tmf
from ecseg_torch.ops import maxflow as tmx
from ecseg_torch.pipelines import stat_fish as tsf

from _nusetutil import crafted_nuset_model
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
PARAMS_FILE = REPO / "ecseg_torch" / "stat_fish_params.yaml"
OUTPUT_SUFFIXES = (
    "__segmentation_min_cut.npy", "_segmentation.tif", "_segmentation_corrected_min_cut.tif",
    "_original_with_segmentation.tif", "_original.tif",
)


def _cells(h, w, seed, dtype):
    """A BGR interphase image: DAPI nuclei in blue (two of them touching,
    for the min-cut to split), green and red foci inside them, some FISH
    signal outside; uint8, or uint16 scaled to the full range."""
    rng = np.random.default_rng(seed)
    img = (rng.random((h, w, 3)) * 25).astype(np.float64)
    yy, xx = np.ogrid[:h, :w]
    nuclei = [(60, 40, 26), (60, 95, 26), (140, 60, 22), (130, 140, 22)]  # the first two merge in NuSeT's mask
    for cy, cx, r in nuclei:
        img[..., 0][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 210 + rng.integers(0, 20)
        for ch in (1, 2):
            for _ in range(3):
                y, x = cy + rng.integers(-r // 2, r // 2), cx + rng.integers(-r // 2, r // 2)
                img[y - 1 : y + 2, x - 1 : x + 2, ch] = 160 + rng.integers(0, 90)
    img[5:8, w - 9 : w - 6, 1] = 200  # a focus outside every nucleus
    if dtype == np.uint16:
        return (img * 257).astype(np.uint16)
    return img.astype(np.uint8)


def _make_folder(d):
    os.makedirs(d)
    imgio.write_tiff(os.path.join(d, "a_cells.tif"), _cells(200, 180, 1, np.uint8)[..., ::-1])
    imgio.write_tiff(os.path.join(d, "b_cells16.tif"), _cells(176, 190, 2, np.uint16)[..., ::-1])
    np.save(os.path.join(d, "c_cells.npy"), _cells(168, 168, 3, np.uint16))
    return d


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A working directory holding ``models/nuset.npz`` (the crafted NuSeT
    tree, min_score cleared by no proposal) that both packages load."""
    d = tmp_path_factory.mktemp("stat_fish")
    m = crafted_nuset_model()
    tree = jax.tree.map(np.asarray, {"whole": m.unet_whole, "fg": {"unet": m.unet_fg, "rpn": m.rpn_fg}})
    os.makedirs(d / "models")
    save_npz_pytree(str(d / "models" / "nuset.npz"), tree)
    return d


def _outputs(inpath):
    ann = os.path.join(inpath, "annotated")
    return {os.path.relpath(p, ann): p for p in glob.glob(os.path.join(ann, "**"), recursive=True) if os.path.isfile(p)}


def _assert_same_outputs(got_dir, want_dir, use_min_cut):
    got, want = _outputs(got_dir), _outputs(want_dir)
    assert sorted(got) == sorted(want)
    for name in ("a_cells", "b_cells16", "c_cells"):
        for suffix in OUTPUT_SUFFIXES:
            key = os.path.join(name, name + suffix)
            assert (key in want) == (use_min_cut or "min_cut.tif" not in suffix), key
        assert len(glob.glob(os.path.join(got_dir, "annotated", name, name + "_lsq_*.tif"))) == 1
    for key in want:
        if key.startswith("config_"):  # each side's copy of its own config
            continue
        if key.endswith(".tif"):
            a, b = cv2.imread(got[key], cv2.IMREAD_UNCHANGED), cv2.imread(want[key], cv2.IMREAD_UNCHANGED)
            assert a.dtype == b.dtype and np.array_equal(a, b), key
        else:
            assert open(got[key], "rb").read() == open(want[key], "rb").read(), key


@pytest.mark.parametrize("use_min_cut", [True, False])
@pytest.mark.parametrize("scale", [1, "auto"])
def test_main_matches_jax_main(workdir, monkeypatch, use_min_cut, scale):
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("ECSEG_STAT_FISH_SHARD", "0")
    monkeypatch.delenv("ECSEG_DEVICE_PIPELINE", raising=False)
    tag = f"{int(use_min_cut)}_{scale}"
    jdir, tdir = _make_folder(str(workdir / f"jax_{tag}")), _make_folder(str(workdir / f"port_{tag}"))
    raw = lambda d: {"stat_fish": {"inpath": d, "scale": scale, "use_min_cut": use_min_cut, "nuclei_size_T": 500}}
    assert jsf.main(config=JConfig(raw=raw(jdir))) == 0
    assert tsf.main(config=TConfig(raw=raw(tdir)), device="cpu") == 0
    _assert_same_outputs(tdir, jdir, use_min_cut)
    rows = open(os.path.join(tdir, "annotated", "stat_fish_lsq.csv")).read().splitlines()
    assert rows[0].split(",") == tsf.csv_header(2)
    names = list(dict.fromkeys(r.split(",")[0] for r in rows[1:]))  # the images' rows in input order
    assert names == [os.path.basename(p)[:-4] for p in imgio.get_imgs(tdir)]
    assert len(names) == 3
    seg = np.load(os.path.join(tdir, "annotated", "a_cells", "a_cells__segmentation_min_cut.npy"))
    assert ndi.label(seg != 0)[1] == 3
    assert seg.max() == (4 if use_min_cut else 3)  # the min-cut split the touching pair


def test_host_chains_main_matches_jax(workdir, monkeypatch):
    """``device_path=False``: the host cleanup chain and the host matched
    filter, the same outputs."""
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("ECSEG_STAT_FISH_SHARD", "0")
    monkeypatch.delenv("ECSEG_DEVICE_PIPELINE", raising=False)
    jdir, tdir = _make_folder(str(workdir / "jax_host")), _make_folder(str(workdir / "port_host"))
    raw = lambda d: {"stat_fish": {"inpath": d, "scale": "auto", "use_min_cut": True, "nuclei_size_T": 500}}
    assert jsf.main(config=JConfig(raw=raw(jdir))) == 0
    assert tsf.main(config=TConfig(raw=raw(tdir)), device="cpu", device_path=False) == 0
    _assert_same_outputs(tdir, jdir, True)


def test_image_without_nuclei_matches_jax(workdir, monkeypatch):
    """A folder with an image in which NuSeT finds no nucleus: pandas'
    concat then writes every integer column as floats; the port's CSV
    follows, byte for byte."""
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("ECSEG_STAT_FISH_SHARD", "0")
    monkeypatch.delenv("ECSEG_DEVICE_PIPELINE", raising=False)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = d = str(workdir / f"blank_{side}")
        os.makedirs(d)
        imgio.write_tiff(os.path.join(d, "a_cells.tif"), _cells(200, 180, 1, np.uint8)[..., ::-1])
        imgio.write_tiff(os.path.join(d, "blank.tif"), (np.random.default_rng(0).random((160, 160, 3)) * 20).astype(np.uint8))
    raw = lambda d: {"stat_fish": {"inpath": d, "scale": 1, "use_min_cut": True, "nuclei_size_T": 500}}
    assert jsf.main(config=JConfig(raw=raw(dirs["jax"]))) == 0
    assert tsf.main(config=TConfig(raw=raw(dirs["port"])), device="cpu") == 0
    got, want = (open(os.path.join(dirs[s], "annotated", "stat_fish_lsq.csv"), "rb").read() for s in ("port", "jax"))
    assert got == want
    lines = got.decode().splitlines()
    dapi = lines[0].split(",").index("#_DAPI_pixels")
    assert len(lines) > 1 and all(r.split(",")[dapi].endswith(".0") for r in lines[1:])  # integers as floats
    assert np.load(os.path.join(dirs["port"], "annotated", "blank", "blank__segmentation_min_cut.npy")).max() == 0


def test_folder_protocol_matches_jax(workdir, monkeypatch):
    """The command line's form: the config read from a ``config.yaml``
    (PyYAML unimportable on the port's side) and copied as
    ``config_<commit>.yaml``, the params file copied byte for byte, and a
    second run archiving the first ``annotated/``."""
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("ECSEG_STAT_FISH_SHARD", "0")
    monkeypatch.delenv("ECSEG_DEVICE_PIPELINE", raising=False)
    for side in ("jax", "port"):
        _make_folder(str(workdir / f"proto_{side}"))
        (workdir / f"config_{side}.yaml").write_text(
            f"stat_fish:\n  inpath: ./proto_{side}\n  scale: 1\n  use_min_cut: True\n  nuclei_size_T: 500\n"
        )
    for _ in range(2):
        assert jsf.main(config=jload_config(str(workdir / "config_jax.yaml"))) == 0
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "yaml", None)
            assert tsf.main(config=load_config(str(workdir / "config_port.yaml")), device="cpu") == 0
    listing = {}
    for side in ("jax", "port"):
        root = workdir / f"proto_{side}"
        entries = sorted(os.listdir(root))
        assert "annotated" in entries and sum(e.startswith("annotated_") for e in entries) == 1, entries
        assert not any(e.startswith("tmp_") for e in entries)
        listing[side] = sorted(os.listdir(root / "annotated"))
        assert (root / "annotated" / "stat_fish_params.yaml").read_bytes() == PARAMS_FILE.read_bytes()
        copy = root / "annotated" / f"config_{tsf._git_commit()}.yaml"
        assert copy.read_bytes() == (workdir / f"config_{side}.yaml").read_bytes()
    assert listing["jax"] == listing["port"]
    _assert_same_outputs(str(workdir / "proto_port"), str(workdir / "proto_jax"), True)


def test_missing_folder_and_no_card(capsys, tmp_path):
    cfg = TConfig(raw={"stat_fish": {"inpath": "/nonexistent/nope", "scale": 1, "use_min_cut": True, "nuclei_size_T": 5}})
    assert tsf.main(config=cfg, device="cpu") == 2
    assert "Input folder does not exist. Exiting..." in capsys.readouterr().out


# --- the host parts ------------------------------------------------------


def test_params_reader_equals_the_jax_packages():
    text = PARAMS_FILE.read_text()
    assert text == (REPO / "ecseg_tpu" / "stat_fish_params.yaml").read_text()
    got = load_stat_fish_params()
    want = StatFishParams.from_mapping(yaml.safe_load(text))
    assert {k: v for k, v in vars(got).items() if k != "path"} == {k: v for k, v in vars(want).items() if k != "path"}
    assert got.path == str(PARAMS_FILE) and load_stat_fish_params("/nonexistent.yaml") == StatFishParams()


def _crops(rng):
    """Bounding-box crops of objects (touching the crop's edge on every
    side), a crop with no zero, and random masks."""
    out = []
    yy, xx = np.ogrid[:40, :50]
    blob = ((yy - 20) ** 2 / 400 + (xx - 25) ** 2 / 625) <= 1
    out += [blob, blob[3:-2, 4:-1], np.ones((7, 9), bool), np.ones((1, 5), bool)]
    out += [rng.random((rng.integers(1, 30), rng.integers(1, 30))) < p for p in (0.5, 0.9, 0.99)]
    return out


def test_l1_distance_equals_cv2():
    for m in _crops(np.random.default_rng(0)):
        want = cv2.distanceTransform(m.astype(np.uint8), cv2.DIST_L1, 3)
        got = tmx.l1_distance(m)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _dumbbells(rng, h=120, w=200):
    """Touching disk pairs, single disks and a thin ring (uint8 0/255)."""
    yy, xx = np.ogrid[:h, :w]
    m = np.zeros((h, w), bool)
    for cy, cx, r, gap in ((40, 40, 18, 30), (40, 130, 16, 26), (95, 60, 14, 0), (95, 150, 13, 0)):
        m |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        if gap:
            m |= (yy - cy) ** 2 + (xx - cx - gap) ** 2 <= r * r
    ring = ((yy - 90) ** 2 + (xx - 110) ** 2 <= 24**2) & ((yy - 90) ** 2 + (xx - 110) ** 2 >= 17**2)
    return ((m | ring) * 255).astype(np.uint8)


@pytest.mark.parametrize("coeff", [1.25, 0.5])
def test_min_cut_matches_jax(coeff):
    seg = _dumbbells(np.random.default_rng(1))
    got, got_vis = tmx.binary_seg_to_instance_min_cut(seg, 60, coeff)
    want, want_vis = jmx.binary_seg_to_instance_min_cut(seg, 60, coeff)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_vis, want_vis)
    assert got.max() > 5  # the pairs were split


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_get_centers_draws_off_mask_centroids_as_jax(seed):
    """A thick annulus: its center region is a ring whose centroid (the
    hole) is off the mask, so a random pixel of the ring is drawn; the
    port's RandomState(seed) draws what the JAX package's np.random.seed
    draws."""
    yy, xx = np.ogrid[:100, :100]
    d = (yy - 50) ** 2 + (xx - 50) ** 2
    ann = ((d <= 42**2) & (d >= 14**2)).astype(int)
    got = tmx.get_centers(ann, np.random.RandomState(seed))
    np.random.seed(seed)
    want = jmx.get_centers(ann)
    assert got == want and len(got) == 1 and got[0] != (50, 50) and ann[got[0]]


def test_imread_bgr8_equals_cv2(tmp_path):
    v = np.arange(65536, dtype=np.uint16).reshape(256, 256)
    rng = np.random.default_rng(2)
    images = {
        "gray16": v, "rgb16": np.dstack([v, v[::-1], v.T]), "rgba16": np.dstack([v, v.T, v[:, ::-1], v[::-1]]),
        "gray8": (rng.random((30, 40)) * 255).astype(np.uint8), "rgb8": (rng.random((30, 40, 3)) * 255).astype(np.uint8),
    }
    for name, img in images.items():
        p = str(tmp_path / f"{name}.tif")
        cv2.imwrite(p, img[..., [2, 1, 0, 3][: img.shape[2]]] if img.ndim == 3 else img)
        got, want = imgio.imread_bgr8(p), cv2.imread(p)
        assert got.dtype == np.uint8 and np.array_equal(got, want), name
    lzw = str(tmp_path / "lzw.tif")
    cv2.imwrite(lzw, images["rgb8"])  # cv2's default TIFF compression
    assert np.array_equal(imgio.imread_bgr8(lzw), cv2.imread(lzw))
    np.save(tmp_path / "x.npy", images["rgb16"])
    np.testing.assert_array_equal(imgio.imread_bgr8(str(tmp_path / "x.npy")), images["rgb16"])


def test_imwrite_reads_back_as_cv2_writes(tmp_path):
    rng = np.random.default_rng(3)
    for img in ((rng.random((21, 17)) * 255).astype(np.uint8), (rng.random((21, 17, 3)) * 255).astype(np.uint8)):
        ours, theirs = str(tmp_path / "ours.tif"), str(tmp_path / "theirs.tif")
        imgio.imwrite(ours, img)
        cv2.imwrite(theirs, img, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
        np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED), cv2.imread(theirs, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("sf", [1.0, 0.7])
def test_matched_filter_matches_jax_and_host(sf):
    rng = np.random.default_rng(4)
    I = _cells(120, 110, 5, np.uint8)
    cells = (((np.ogrid[:120, :110][0] - 60) ** 2 + (np.ogrid[:120, :110][1] - 50) ** 2) <= 45**2).astype(np.uint8) * 255
    I[..., 1] = np.maximum(I[..., 1], (rng.random((120, 110)) * 120).astype(np.uint8))
    shape = [int(d // sf) if (d // sf % 2) else int(d // sf) + 1 for d in (7, 7)]
    args = (I, cells, 3 / sf, 15, [70, 70], shape)
    got = tmf.get_thresholded_device_packed(*args, "cpu")
    host = tmf.get_thresholded(*args)
    want = np.asarray(jmf.get_thresholded_jax(I, cells, 3 / sf, 15.0, (70, 70), tuple(shape)))
    assert got.dtype == np.int32 and got.flags.writeable
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jmf.get_thresholded_device_packed(*args))
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(host, jmf.get_thresholded(*args))
    assert got.any()


def test_image_helpers_match_jax():
    rng = np.random.default_rng(6)
    lab = np.zeros((50, 60), np.int32)
    lab[5:20, 5:25], lab[18:40, 20:50], lab[42:48, 2:8] = 1, 2, 5
    for t in (1, 2, 3):
        np.testing.assert_array_equal(tmf.get_boundaries(lab, t), jmf.get_boundaries(lab, t))
    four = (rng.random((10, 12, 4)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tmf.merge_channels(four, tsf.AQUA_RGB), jmf.merge_channels(four, tsf.AQUA_RGB))
    assert tmf.get_scale(lab, 2500) == jmf.get_scale(lab, 2500)
    np.testing.assert_array_equal(tmf.get_gaussian_proj_kernel((5, 7), 1.3), jmf.get_gaussian_proj_kernel((5, 7), 1.3))
