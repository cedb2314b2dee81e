"""The port's TIFF decoder (``ecseg_torch.core.imgio``): uncompressed, LZW
(``csrc/tiff_lzw.cpp``) and deflate strips, with and without the
horizontal predictor, equal to ``cv2.imread(..., IMREAD_UNCHANGED)`` on the
repository's own input and on files cv2 writes, all decoded with cv2 made
unimportable, which proves the port decodes them itself.  Also the LZW
writer ``chip_smoke.py`` uses on the card (no cv2 there): cv2 and the port
read its files back, in both byte orders.  And the port's own LZW writer
(``imgio.write_tiff_lzw``, the encoder of ``csrc/tiff_lzw.cpp``), which
``imgio.imwrite`` takes under ``ECSEG_TIF_LZW=1`` as the JAX package's
``imwrite`` takes cv2's default: its files equal ``cv2.imwrite``'s byte for
byte and decode to the same pixels; every spelling of the switch."""

import os
import pathlib
import sys

import cv2
import numpy as np
import pytest

from chip_smoke import lzw_tiff_bytes
from ecseg_torch.core import imgio

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

INPUT_TIF = str(pathlib.Path(__file__).resolve().parents[1] / "example_ecSeg" / "input.tif")


def _rgb_order(img):
    """cv2's channel order of an RGB(A) array, and back."""
    if img.ndim == 3:
        return img[..., [2, 1, 0, 3][: img.shape[2]]]
    return img


def _read_no_cv2(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        return imgio.imread_rgb(path)


def test_repo_input_decodes_without_cv2(monkeypatch):
    with open(INPUT_TIF, "rb") as f:
        _, tags = imgio._tiff_header(f.read())
    assert tags[259] == (5,) and tags[317] == (2,)  # LZW with the predictor
    got = _read_no_cv2(INPUT_TIF, monkeypatch)
    assert got.dtype == np.uint16 and got.shape == (700, 900)
    np.testing.assert_array_equal(got, cv2.imread(INPUT_TIF, cv2.IMREAD_UNCHANGED))


_KINDS = {"u8_gray": (np.uint8, 0), "u16_gray": (np.uint16, 0), "u8_rgb": (np.uint8, 3),
          "u16_rgb": (np.uint16, 3), "u8_rgba": (np.uint8, 4), "u16_rgba": (np.uint16, 4)}
_SIZES = {"one_strip": (5, 7), "many_strips": (211, 131)}  # odd widths


@pytest.mark.parametrize("size", sorted(_SIZES))
@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("comp", [5, 8, 32946], ids=["lzw", "deflate", "deflate_old"])
def test_cv2_written_files_decode_without_cv2(tmp_path, monkeypatch, comp, kind, size):
    dtype, spp = _KINDS[kind]
    h, w = _SIZES[size]
    rng = np.random.default_rng(comp + h)
    shape = (h, w) if spp == 0 else (h, w, spp)
    smooth = np.add.outer(np.arange(h), 3 * np.arange(w)).reshape(h, w, *([1] * (spp > 0)))
    img = (smooth + rng.integers(0, 4, shape)).astype(dtype)  # runs LZW's table through clears
    p = str(tmp_path / "img.tif")
    assert cv2.imwrite(p, np.ascontiguousarray(_rgb_order(img)), [cv2.IMWRITE_TIFF_COMPRESSION, comp])
    with open(p, "rb") as f:
        _, tags = imgio._tiff_header(f.read())
    assert tags[259] == (comp,) and (len(tags[273]) == 1) == (size == "one_strip")
    got = _read_no_cv2(p, monkeypatch)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(_rgb_order(got), cv2.imread(p, cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("comp", [1, 5, 8])
def test_files_without_the_predictor_decode_without_cv2(tmp_path, monkeypatch, comp):
    img = (np.random.default_rng(comp).random((33, 29)) * 65535).astype(np.uint16)
    p = str(tmp_path / "img.tif")
    params = [cv2.IMWRITE_TIFF_COMPRESSION, comp, cv2.IMWRITE_TIFF_PREDICTOR, cv2.IMWRITE_TIFF_PREDICTOR_NONE]
    assert cv2.imwrite(p, img, params)
    with open(p, "rb") as f:
        assert imgio._tiff_header(f.read())[1].get(317, (1,)) == (1,)
    np.testing.assert_array_equal(_read_no_cv2(p, monkeypatch), img)


@pytest.mark.parametrize("byte_order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("kind", ["u16_gray", "u8_rgb"])
def test_smoke_lzw_writer_round_trips(tmp_path, monkeypatch, byte_order, kind):
    """chip_smoke's LZW writer against cv2's reader (libtiff), and the
    port's decoder on big-endian files, which cv2 does not write; one strip
    of 64 KB runs the table full many times."""
    dtype, spp = _KINDS[kind]
    rng = np.random.default_rng(spp)
    img = (rng.random((64, 256) if spp == 0 else (64, 171, spp)) * np.iinfo(dtype).max).astype(dtype)
    p = str(tmp_path / "img.tif")
    with open(p, "wb") as f:
        f.write(lzw_tiff_bytes(img, byte_order, rows_per_strip=64 if spp == 0 else 9))
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_UNCHANGED), _rgb_order(img))
    np.testing.assert_array_equal(_read_no_cv2(p, monkeypatch), img)


@pytest.mark.parametrize("comp", [32773, 7], ids=["packbits", "jpeg"])
def test_undecodable_files_name_file_and_compression(tmp_path, monkeypatch, comp):
    img = (np.random.default_rng(0).random((20, 30)) * 255).astype(np.uint8)
    p = str(tmp_path / f"c{comp}.tif")
    assert cv2.imwrite(p, img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])
    with pytest.raises(RuntimeError, match=rf"c{comp}\.tif: .*compression \(tag 259\) is {comp}"):
        _read_no_cv2(p, monkeypatch)


def test_undecodable_files_go_to_cv2(tmp_path):
    img = (np.random.default_rng(1).random((20, 30)) * 255).astype(np.uint8)
    p = str(tmp_path / "packbits.tif")
    assert cv2.imwrite(p, img, [cv2.IMWRITE_TIFF_COMPRESSION, 32773])
    np.testing.assert_array_equal(imgio.imread_rgb(p), img)


def test_malformed_lzw_raises_naming_the_file(tmp_path):
    img = (np.random.default_rng(2).random((40, 50)) * 255).astype(np.uint8)
    data = bytearray(lzw_tiff_bytes(img, "<", rows_per_strip=40))
    data[8 + 200 : 8 + 260] = b"\xff" * 60  # codes of all ones, past the table
    p = tmp_path / "broken.tif"
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=r"broken\.tif: LZW strip 0"):
        imgio.imread_rgb(str(p))


_LZW_SIZES = {"1x1": (1, 1), "5x7": (5, 7), "37x2049": (37, 2049), "211x131": (211, 131), "3x5000": (3, 5000)}


@pytest.mark.parametrize("size", sorted(_LZW_SIZES))
@pytest.mark.parametrize("kind", ["u8_gray", "u16_gray", "u8_rgb", "u16_rgb"])
@pytest.mark.parametrize("content", ["flat", "random", "sparse"])
def test_lzw_writer_equals_cv2(tmp_path, monkeypatch, content, kind, size):
    """The port's LZW file of a BGR/gray array against ``cv2.imwrite``'s
    default TIFF of the same array: equal bytes (the codes, table clears,
    rows per strip, tags and layout of OpenCV's libtiff), compression 5 with
    the predictor, and the same pixels through cv2 and the port's decoder.
    Random full-range samples run the table full and through the ratio
    check's clears."""
    dtype, spp = _KINDS[kind]
    h, w = _LZW_SIZES[size]
    rng = np.random.default_rng(h * w + spp)
    shape = (h, w) if spp == 0 else (h, w, spp)
    top = np.iinfo(dtype).max
    img = {"flat": np.full(shape, top // 3, dtype), "random": rng.integers(0, top, shape, dtype, endpoint=True),
           "sparse": ((rng.random(shape) < 0.02) * (top - 5)).astype(dtype)}[content]
    want, got = str(tmp_path / "cv2.tif"), str(tmp_path / "port.tif")
    assert cv2.imwrite(want, img)
    monkeypatch.setenv("ECSEG_TIF_LZW", "1")
    imgio.imwrite(got, img)
    data = pathlib.Path(got).read_bytes()
    assert data == pathlib.Path(want).read_bytes()
    tags = imgio._tiff_header(data)[1]
    assert tags[259] == (5,) and tags[317] == (2,)
    np.testing.assert_array_equal(cv2.imread(got, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(_rgb_order(_read_no_cv2(got, monkeypatch)), img)


def test_lzw_is_smaller_on_the_flat_image(tmp_path, monkeypatch):
    """tests/test_imgio_tif.py's image: LZW shrinks it, the pixels stay."""
    img = np.zeros((64, 96, 3), np.uint8)
    img[8:30, 10:40] = (40, 200, 120)
    img[50:60, 60:90, 2] = 255
    raw, lzw = str(tmp_path / "raw.tif"), str(tmp_path / "lzw.tif")
    monkeypatch.delenv("ECSEG_TIF_LZW", raising=False)
    imgio.imwrite(raw, img)
    monkeypatch.setenv("ECSEG_TIF_LZW", "1")
    imgio.imwrite(lzw, img)
    np.testing.assert_array_equal(cv2.imread(raw), img)
    np.testing.assert_array_equal(cv2.imread(lzw), img)
    assert os.path.getsize(raw) > os.path.getsize(lzw)


@pytest.mark.parametrize("value", [None, "", "0", "false", "no", "off", "2", "1", "true", "yes", "on", " TRUE ", "On\n", "YES"])
@pytest.mark.parametrize("suffix", [".tif", ".TIFF", ".png"])
def test_tif_lzw_switch_spellings(tmp_path, monkeypatch, value, suffix):
    """``ECSEG_TIF_LZW`` is on for 1/true/yes/on, stripped and in any case
    (ecseg_tpu/core/imgio.py:57-59), and only for .tif/.tiff paths; off, the
    file's bytes are the uncompressed writer's, as before the switch."""
    img = (np.random.default_rng(4).random((19, 23, 3)) * 255).astype(np.uint8)
    if value is None:
        monkeypatch.delenv("ECSEG_TIF_LZW", raising=False)
    else:
        monkeypatch.setenv("ECSEG_TIF_LZW", value)
    on = value is not None and value.strip().lower() in ("1", "true", "yes", "on")
    assert imgio.tif_lzw() == on
    p = str(tmp_path / ("img" + suffix))
    imgio.imwrite(p, img)
    data = pathlib.Path(p).read_bytes()
    lzw = on and suffix != ".png"
    assert imgio._tiff_header(data)[1][259] == ((5,) if lzw else (1,))
    if not lzw:
        imgio.write_tiff(str(tmp_path / "plain.tif"), img[..., ::-1])
        assert data == (tmp_path / "plain.tif").read_bytes()
    np.testing.assert_array_equal(_rgb_order(_read_no_cv2(p, monkeypatch)), img)
