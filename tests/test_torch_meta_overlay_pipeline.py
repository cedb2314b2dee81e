"""The port's meta_overlay slice as a whole:
``ecseg_torch.pipelines.meta_overlay.main(device="cpu")`` against
``ecseg_tpu.pipelines.meta_overlay.main`` on copies of one folder, with the
JAX package's host branch (``ECSEG_DEVICE_PIPELINE=0``: scipy counts) and
its device branch (``=1``: the fused program, interpret-mode Pallas).
``fish_quantification.csv`` must be byte-identical (the port writes it
without pandas) and the ``red/`` and ``green/`` PNGs must decode (cv2) to
identical pixels.  The folders are tests/test_meta_overlay.py's fixtures
(the basic image, the ``"(0, 0.0)"`` cells of an image whose FISH stays
under color_sensitivity, a grayscale image that is skipped) and a folder of
three RGB images (uint16 in cv2's default LZW TIFF, uint8, one with FISH
blobs large enough for the HSR filter) and a grayscale one; the early
exits (no input folder, no ``labels/``, no ``dapi/``,
``color_sensitivity`` 300) must give the same code and messages.  The
command line's path (``main`` with no config, reading ``config.yaml``) runs
once."""

import os
import shutil

import cv2
import numpy as np
import pytest

from ecseg_torch.core.config import Config as PortConfig
from ecseg_torch.pipelines import meta_overlay as port

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

H, W = 128, 160  # tests/test_meta_overlay.py's size: the JAX program compiles once


def _folder(d):
    os.makedirs(os.path.join(d, "labels"))
    os.makedirs(os.path.join(d, "dapi"))
    return d


def _basic(d):
    """tests/test_meta_overlay.py:13-33."""
    _folder(d)
    rgb = np.zeros((H, W, 3), np.uint8)
    rgb[10:20, 10:20, 1] = 200
    rgb[40:45, 40:45, 0] = 200
    rgb[..., 2] = 30
    cv2.imwrite(os.path.join(d, "img.tif"), rgb[..., ::-1])
    seg = np.zeros((H, W), np.int64)
    seg[10:20, 10:20] = 3
    seg[60:80, 60:90] = 2
    seg[100:120, 10:40] = 1
    np.save(os.path.join(d, "labels", "img.npy"), seg)


def _empty_fish(d):
    """tests/test_meta_overlay.py:60-72: no FISH above sensitivity, no ecDNA."""
    _folder(d)
    cv2.imwrite(os.path.join(d, "img.tif"), np.full((64, 64, 3), 20, np.uint8))
    seg = np.zeros((64, 64), np.int64)
    seg[10:30, 10:30] = 1
    np.save(os.path.join(d, "labels", "img.npy"), seg)


def _grayscale(d):
    """tests/test_meta_overlay.py:92-98: the only image is grayscale."""
    _folder(d)
    cv2.imwrite(os.path.join(d, "g.tif"), np.zeros((32, 32), np.uint8))


def _three(d):
    """Three RGB images and a grayscale one: seeded FISH dots and blobs, on
    ecDNA, chromosomes, nuclei and background, and label maps with every
    class; one image uint16 (cv2's default LZW), one with its FISH dim."""
    _folder(d)
    rng = np.random.default_rng(5)
    for k in range(3):
        seg = np.zeros((H, W), np.int64)
        for lab, n, lo, hi in ((1, 3, 10, 30), (2, 10, 4, 16), (3, 30, 1, 5)):
            for _ in range(n):
                y, x = rng.integers(0, H - 4), rng.integers(0, W - 4)
                seg[y : y + int(rng.integers(lo, hi)), x : x + int(rng.integers(lo, hi))] = lab
        rgb = (rng.random((H, W, 3)) * 60).astype(np.uint8)
        for ch in (0, 1):
            for _ in range(25):
                y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
                s = int(rng.integers(1, 8))
                rgb[y : y + s, x : x + s, ch] = 40 if k == 2 else int(rng.integers(90, 256))
        name = f"im{k}"
        if k == 0:
            cv2.imwrite(os.path.join(d, f"{name}.tif"), (rgb.astype(np.uint16) * 257)[..., ::-1])
        else:
            cv2.imwrite(os.path.join(d, f"{name}.tif"), rgb[..., ::-1], [cv2.IMWRITE_TIFF_COMPRESSION, 1])
        np.save(os.path.join(d, "labels", f"{name}.npy"), seg)
    cv2.imwrite(os.path.join(d, "gray.tif"), (rng.random((H, W)) * 255).astype(np.uint8))


FOLDERS = {"basic": _basic, "empty_fish": _empty_fish, "grayscale": _grayscale, "three": _three}


def _run_jax(folder, monkeypatch, device_path, sensitivity=85):
    from ecseg_tpu.core.config import Config
    from ecseg_tpu.pipelines import meta_overlay as jax_overlay

    with monkeypatch.context() as m:
        m.setenv("ECSEG_DEVICE_PIPELINE", device_path)
        m.setenv("ECSEG_OVERLAY_SHARD", "0")  # one device, images in order
        return jax_overlay.main(config=Config(raw={"meta_overlay": {"inpath": folder, "color_sensitivity": sensitivity}}))


def _run_port(folder, sensitivity=85):
    return port.main(config=PortConfig(raw={"meta_overlay": {"inpath": folder, "color_sensitivity": sensitivity}}), device="cpu")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_outputs(a, b):
    csv_a, csv_b = (os.path.join(d, "fish_quantification.csv") for d in (a, b))
    assert os.path.exists(csv_a) == os.path.exists(csv_b)
    if os.path.exists(csv_a):
        assert _read(csv_a) == _read(csv_b)
    for sub in ("red", "green"):
        names = sorted(os.listdir(os.path.join(a, sub)))
        assert names == sorted(os.listdir(os.path.join(b, sub)))
        for name in names:
            pa, pb = os.path.join(a, sub, name), os.path.join(b, sub, name)
            np.testing.assert_array_equal(cv2.imread(pa, cv2.IMREAD_UNCHANGED), cv2.imread(pb, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("device_path", ["0", "1"])
@pytest.mark.parametrize("name", sorted(FOLDERS))
def test_main_matches_the_jax_package(tmp_path, monkeypatch, name, device_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    FOLDERS[name](jax_dir)
    shutil.copytree(jax_dir, port_dir)
    assert _run_jax(jax_dir, monkeypatch, device_path) == 0
    assert _run_port(port_dir) == 0
    _assert_same_outputs(jax_dir, port_dir)
    csv = os.path.join(port_dir, "fish_quantification.csv")
    if name == "grayscale":
        assert not os.path.exists(csv)  # no rows, no CSV (README "Deliberate deviations")
    else:
        lines = _read(csv).decode().splitlines()
        assert len(lines) == 1 + {"basic": 1, "empty_fish": 1, "three": 3}[name]
        if name == "basic":
            assert lines[1].startswith('img.tif,"(1, 100)","(1, 100)",')
        if name == "empty_fish":
            assert lines[1].count('"(0, 0.0)"') == 3


def test_the_three_image_folder_reaches_every_statistic(tmp_path):
    d = str(tmp_path / "three")
    _three(d)
    assert _run_port(d) == 0
    rows = [ln.split(",") for ln in _read(os.path.join(d, "fish_quantification.csv")).decode().splitlines()[1:]]
    assert [r[0] for r in rows] == [os.path.basename(p) for p in port.imgio.get_imgs(d) if "gray" not in p]
    hsr = [int(r[-1]) + int(r[-2]) for r in rows]
    assert max(hsr) > 0  # the HSR filter keeps some FISH on chromosomes


@pytest.mark.parametrize("case", ["no_inpath", "no_labels", "no_dapi", "sensitivity_300"])
def test_early_exits_match_the_jax_package(tmp_path, monkeypatch, capsys, case):
    d = str(tmp_path / "ov")
    sensitivity = 85
    if case != "no_inpath":
        _basic(d)
    if case == "no_labels":
        shutil.rmtree(os.path.join(d, "labels"))
    if case == "no_dapi":
        shutil.rmtree(os.path.join(d, "dapi"))
    if case == "sensitivity_300":
        sensitivity = 300
    capsys.readouterr()
    assert _run_jax(d, monkeypatch, "0", sensitivity) == 2
    jax_out = capsys.readouterr().out
    assert _run_port(d, sensitivity) == 2
    assert capsys.readouterr().out == jax_out


def test_command_line_path_reads_config_yaml(tmp_path, monkeypatch):
    """``main`` with no config reads ``./config.yaml`` (the port's YAML
    reader) as ``python -m ecseg_torch.pipelines.meta_overlay`` does."""
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _three(jax_dir)
    shutil.copytree(jax_dir, port_dir)
    (tmp_path / "config.yaml").write_text(
        "metaseg:\n  inpath: ./port\nmeta_overlay:\n  inpath: ./port\n  color_sensitivity: 85\n"
    )
    monkeypatch.chdir(tmp_path)
    assert _run_jax(jax_dir, monkeypatch, "0") == 0
    assert port.main(device="cpu") == 0
    _assert_same_outputs(jax_dir, port_dir)
