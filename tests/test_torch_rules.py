"""Rules of the port (ecseg_torch) and its host I/O helpers:

- no module of the package, nor chip_smoke.py, imports jax or ecseg_tpu,
  and the metaseg path imports no cv2, pandas or yaml when it loads;
- an entry point given no device raises when there is no CUDA device;
- a kernel wrapper given a tensor that is neither on the CPU nor on a CUDA
  device raises, and never falls back to its plain twin;
- the TIFF/PNG/CSV/Otsu helpers that replace cv2, pandas and yaml agree with
  them.
"""

import ast
import os
import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from ecseg_torch.core import imgio
from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import convt, fused_tail
from ecseg_torch.ops.meta_post import meta_preprocess, otsu_threshold_u8

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "ecseg_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_importing_every_module_loads_no_jax():
    code = """
import importlib, pkgutil, sys
import ecseg_torch
for m in pkgutil.walk_packages(ecseg_torch.__path__, "ecseg_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ecseg_tpu", "cv2", "pandas", "yaml"))
print(bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "ecseg_tpu"), (path, name)


def test_main_without_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from ecseg_torch.core.config import Config
    from ecseg_torch.pipelines import metaseg

    with pytest.raises(RuntimeError, match="device='cpu'"):
        metaseg.main(config=Config(raw={"metaseg": {"inpath": str(tmp_path)}}))


def _meta(shape, dtype=torch.bool):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "call",
    [
        lambda: K.stitch_labels(_meta((1, 256, 256), torch.uint8), [(0, 0)]),
        lambda: K.label(_meta((8, 8)), 2),
        lambda: K.flood_from_border(_meta((8, 8))),
        lambda: K.flood_from_seeds(_meta((8, 8)), _meta((8, 8)), 2),
        lambda: K.label_multiclass(_meta((8, 8), torch.uint8)),
        lambda: K.flood_multiclass(_meta((8, 8), torch.uint8), _meta((8, 8))),
        lambda: K.label_and_flood(_meta((8, 8)), _meta((8, 8)), 2),
        lambda: K.count_components(_meta((8, 8)), 2),
        lambda: K.count_from_patches(_meta((1, 256, 256), torch.uint8), [(0, 0)]),
        lambda: fused_tail.fused_dec1_head(
            _meta((1, 256, 256, 8), torch.bfloat16), _meta((3, 3, 8, 8), torch.float32), _meta((8,), torch.float32),
            _meta((3, 3, 8, 8), torch.float32), _meta((8,), torch.float32), _meta((1, 1, 8, 4), torch.float32),
            _meta((4,), torch.float32),
        ),
        lambda: convt.conv2d_transpose_packed(_meta((1, 8, 8, 4), torch.bfloat16), _meta((3, 3, 4, 64), torch.bfloat16)),
    ],
    ids=[
        "stitch", "label", "flood_border", "flood_seeds", "label_mc", "flood_mc", "label_flood",
        "count", "count_patches", "fused_tail", "convt",
    ],
)
def test_wrappers_raise_off_cpu_and_never_call_twins(monkeypatch, call):
    def forbidden(*a, **k):
        raise AssertionError("a wrapper fell back to its plain twin")

    for name in (
        "stitch_plain", "label_plain", "flood_from_border_plain", "flood_from_seeds_plain",
        "label_multiclass_plain", "flood_multiclass_plain", "label_and_flood_plain",
        "count_components_plain", "count_from_patches_plain",
    ):
        monkeypatch.setattr(K, name, forbidden)
    monkeypatch.setattr(fused_tail, "fused_dec1_head_plain", forbidden)
    monkeypatch.setattr(convt, "conv2d_transpose_packed_plain", forbidden)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="expected a CPU or CUDA tensor"):
        call()
    assert K.LAUNCHES == before


# --- host I/O helpers against cv2 / pandas -------------------------------


def _images(rng):
    return {
        "u8_gray": (rng.random((37, 53)) * 255).astype(np.uint8),
        "u16_gray": (rng.random((41, 29)) * 65535).astype(np.uint16),
        "u8_rgb": (rng.random((19, 23, 3)) * 255).astype(np.uint8),
        "u16_rgb": (rng.random((17, 31, 3)) * 65535).astype(np.uint16),
    }


@pytest.mark.parametrize("kind", ["u8_gray", "u16_gray", "u8_rgb", "u16_rgb"])
def test_tiff_round_trips_with_cv2(tmp_path, rng, kind):
    img = _images(rng)[kind]
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ours = str(tmp_path / "ours.tif")
    imgio.write_tiff(ours, img)
    np.testing.assert_array_equal(cv2.imread(ours, cv2.IMREAD_UNCHANGED), bgr)
    theirs = str(tmp_path / "theirs.tif")
    cv2.imwrite(theirs, np.ascontiguousarray(bgr), [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    with open(theirs, "rb") as f:
        assert imgio._decode_tiff(f.read()) is not None  # decoded without cv2
    got = imgio.imread_rgb(theirs)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


def test_tiff_rgba_and_compressed_reads_match_cv2(tmp_path, rng):
    rgba = (rng.random((13, 11, 4)) * 255).astype(np.uint8)
    p = str(tmp_path / "rgba.tif")
    cv2.imwrite(p, rgba[..., [2, 1, 0, 3]], [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    np.testing.assert_array_equal(imgio.imread_rgb(p), rgba)
    lzw = str(tmp_path / "lzw.tif")
    gray = (rng.random((30, 40)) * 255).astype(np.uint8)
    cv2.imwrite(lzw, gray)  # cv2's default TIFF encoding is compressed
    np.testing.assert_array_equal(imgio.imread_rgb(lzw), gray)


def test_label_png_decodes_to_the_palette(tmp_path, rng):
    labels = rng.integers(0, 4, size=(45, 67)).astype(np.int64)
    p = str(tmp_path / "l.png")
    imgio.save_label_png(p, labels)
    np.testing.assert_array_equal(cv2.imread(p), imgio.METASEG_PALETTE_RGB[labels][..., ::-1])


def test_csv_bytes_match_pandas(tmp_path):
    from ecseg_torch.pipelines.metaseg import write_csv

    header = ["image name", "# of ec"]
    for rows in ([], [("a.tif", 3), ("b,c.tif", 0), ('q"uote.tif', 12), ("sp ace.tif", 7)]):
        ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
        write_csv(str(ours), header, rows)
        pd.DataFrame(rows, columns=header).to_csv(theirs, index=False)
        assert ours.read_bytes() == theirs.read_bytes()


def _otsu_cases(rng):
    two = np.where(rng.random((40, 60)) < 0.3, 17, 201).astype(np.uint8)
    skew = (rng.random((64, 64)) * 60).astype(np.uint8)
    skew[:20, :20] = 220
    return {
        "uniform": (rng.random((80, 90)) * 255).astype(np.uint8),
        "normal": np.clip(rng.normal(128, 30, (70, 50)), 0, 255).astype(np.uint8),
        "skewed": skew,
        "constant": np.full((32, 32), 77, np.uint8),
        "two_valued": two,
        "sparse_levels": (rng.integers(0, 3, (33, 47)) * 100).astype(np.uint8),
    }


@pytest.mark.parametrize("name", ["uniform", "normal", "skewed", "constant", "two_valued", "sparse_levels"])
def test_otsu_and_preprocess_match_cv2(rng, name):
    img = _otsu_cases(rng)[name]
    t, th3 = cv2.threshold(img, 0, 1, cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    assert otsu_threshold_u8(img) == t
    want = ~img if th3.sum() > img.size * 0.5 else img
    np.testing.assert_array_equal(meta_preprocess(img.copy()), want)


def test_u16_to_u8_matches_cv2(rng):
    img = (rng.random((64, 80)) * 65535).astype(np.uint16)
    img[0, :16] = np.linspace(0, 65535, 16).astype(np.uint16)
    np.testing.assert_array_equal(
        imgio.u16_to_u8(img), cv2.convertScaleAbs(img, alpha=255.0 / 65535.0)
    )
