"""The port's TIFF decoder (``ecseg_torch.core.imgio``): uncompressed, LZW
(``csrc/tiff_lzw.cpp``) and deflate strips, with and without the
horizontal predictor, equal to ``cv2.imread(..., IMREAD_UNCHANGED)`` on the
repository's own input and on files cv2 writes, all decoded with cv2 made
unimportable, which proves the port decodes them itself.  Also the LZW
writer ``chip_smoke.py`` uses on the card (no cv2 there): cv2 and the port
read its files back, in both byte orders."""

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
