"""Rules of the port (ecseg_torch) and its host I/O helpers:

- no module of the package, nor chip_smoke.py, imports jax or ecseg_tpu,
  and the on-chip studies, their timer and the two model scripts
  (compare_archs, roofline_forward and the peak table) import no
  chip_smoke either,
  and no module imports cv2, pandas, yaml or h5py when it loads (h5py only
  inside the Keras readers); stat_fish and interseg run from their
  config.yaml with the first five unimportable;
- the TensorFlow weight converters and the readers they stand on import
  no tensorflow, tf_keras, keras, h5py or jax, and both converters run
  with those unimportable;
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
from ecseg_torch.ops import conv3x3, convt, fused_tail, overlay_gpu
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
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ecseg_tpu", "cv2", "pandas", "yaml", "h5py"))
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


STUDY_FILES = [f"ecseg_torch/{name}.py" for name in (
    "profile_meta_post", "profile_metaseg_2048", "profile_layers", "profile_nuclei_segment", "profile_fast_watershed",
    "quantify_watershed_divergence", "runtime/devtime", "runtime/study", "compare_archs", "roofline_forward", "peaks")]


@pytest.mark.parametrize("rel", STUDY_FILES)
def test_studies_import_no_jax_reference_or_chip_smoke(rel):
    """The on-chip studies and their timer stand alone: no JAX, no
    ecseg_tpu, and no chip_smoke (which imports its timers from them)."""
    tree = ast.parse((REPO / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "ecseg_tpu", "chip_smoke"), (rel, name)


CONVERTER_FILES = ["ecseg_torch/convert_tf1_ckpt.py", "ecseg_torch/convert_savedmodel.py", "ecseg_torch/core/tfbundle.py",
                   "ecseg_torch/core/hdf5.py"]
TF_STACK = ("tensorflow", "tf_keras", "keras", "h5py", "jax", "jaxlib", "ecseg_tpu")


@pytest.mark.parametrize("rel", CONVERTER_FILES)
def test_converters_import_no_tensorflow_keras_h5py_or_jax(rel):
    tree = ast.parse((REPO / rel).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in TF_STACK, (rel, name)


@pytest.mark.parametrize("module, args, out", [
    ("ecseg_torch.convert_tf1_ckpt", ["nuset", "{tmp}/nuset.npz"], "nuset.npz"),
    ("ecseg_torch.convert_savedmodel", ["func", "{tmp}/func.h5"], "func.h5"),
])
def test_converters_run_without_tensorflow_keras_h5py_or_jax(tmp_path, module, args, out):
    """``python -m`` each converter as the card's machine runs it, in a
    process where TensorFlow, TF-Keras, Keras, h5py and JAX cannot be
    imported, on the TensorFlow-written fixtures: exit code 0 and the
    file written."""
    fix = REPO / "tests" / "fixtures" / "tf"
    code = f"""
import runpy, sys
for name in {TF_STACK!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
sys.argv = [{module!r}] + {[a.format(tmp=tmp_path) for a in args]!r}
runpy.run_module({module!r}, run_name="__main__")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=fix, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout == f"wrote {tmp_path / out}\n" and (tmp_path / out).stat().st_size > 10000


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
        lambda: overlay_gpu.overlay_stats(*[np.zeros((8, 8), bool)] * 5, device="meta"),
        lambda: conv3x3.conv3x3_relu(_meta((1, 4, 8, 8), torch.float32), _meta((8, 4, 3, 3), torch.float32), _meta((8,), torch.float32)),
    ],
    ids=[
        "stitch", "label", "flood_border", "flood_seeds", "label_mc", "flood_mc", "label_flood",
        "count", "count_patches", "fused_tail", "convt", "overlay", "conv3x3",
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
    monkeypatch.setattr(conv3x3, "conv3x3_relu_plain", forbidden)
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
    """str and int cells (metaseg), the (count, px) tuple cells with an int
    or the float 0.0 (meta_overlay) and float64 cells with inf
    (fish_distance), as pandas writes them."""
    from ecseg_torch.pipelines.metaseg import write_csv

    header = ["image name", "# of ec"]
    tables = (
        [],
        [("a.tif", 3), ("b,c.tif", 0), ('q"uote.tif', 12), ("sp ace.tif", 7)],
        [("a.tif", (1, 100)), ("b.tif", (0, 0.0)), ("c.tif", (12, 4096))],
        [(np.float64(0.125),), (np.float64(1) / 3,), (np.float64(np.inf),), (np.float64(2.0),), (np.float64(1e-7),)],
    )
    for rows in tables:
        cols = header[: len(rows[0])] if rows else header
        ours, theirs = tmp_path / "ours.csv", tmp_path / "theirs.csv"
        write_csv(str(ours), cols, rows)
        pd.DataFrame(rows, columns=cols).to_csv(theirs, index=False)
        assert ours.read_bytes() == theirs.read_bytes()


def test_gray_png_decodes_as_cv2_writes_it(tmp_path, rng):
    """``save_gray_inverted`` to a ``.png`` path (meta_overlay's red/ and
    green/ images): an 8-bit grayscale PNG that cv2 decodes to 255 - the
    image, as the JAX package's cv2 PNG decodes."""
    img = (rng.random((37, 53)) * 256).astype(np.uint8)
    ours, theirs = str(tmp_path / "sub" / "ours.png"), str(tmp_path / "theirs.png")
    imgio.save_gray_inverted(ours, img)
    cv2.imwrite(theirs, 255 - img)
    got = cv2.imread(ours, cv2.IMREAD_UNCHANGED)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, 255 - img)
    np.testing.assert_array_equal(got, cv2.imread(theirs, cv2.IMREAD_UNCHANGED))
    with pytest.raises(IOError):
        imgio.save_gray_inverted(str(tmp_path / "x.jpg"), img)


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


def test_stat_fish_main_without_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from ecseg_torch.core.config import Config
    from ecseg_torch.pipelines import stat_fish

    cfg = Config(raw={"stat_fish": {"inpath": str(tmp_path), "scale": 1, "use_min_cut": True, "nuclei_size_T": 50}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stat_fish.main(config=cfg)


def test_stat_fish_runs_without_cv2_pandas_yaml_or_jax(tmp_path):
    """stat_fish as the card's machine runs it: from a ``config.yaml``, in a
    process where cv2, pandas, yaml, jax and ecseg_tpu cannot be imported,
    on a 64x64 folder (a uint16 RGB TIFF, the crafted demo weights)."""
    img = np.zeros((64, 64, 3), np.uint16)
    yy, xx = np.ogrid[:64, :64]
    img[..., 2][(yy - 30) ** 2 + (xx - 34) ** 2 <= 15**2] = 56000  # blue nucleus (RGB order on disk)
    img[28:31, 30:33, 1] = 50000
    (tmp_path / "in").mkdir()
    imgio.write_tiff(str(tmp_path / "in" / "cells.tif"), img)
    (tmp_path / "config.yaml").write_text("stat_fish:\n  inpath: ./in\n  scale: 1\n  use_min_cut: True\n  nuclei_size_T: 20\n")
    code = f"""
import sys
for name in ("cv2", "pandas", "yaml", "jax", "jaxlib", "ecseg_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
from ecseg_torch.pipelines import stat_fish
sys.exit(stat_fish.main(device="cpu"))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ann = tmp_path / "in" / "annotated"
    rows = (ann / "stat_fish_lsq.csv").read_text().splitlines()
    assert rows[0].startswith("image_name,nucleus_center,") and len(rows) == 2
    assert (ann / "cells" / "cells__segmentation_min_cut.npy").exists()
    assert len(list((ann / "cells").glob("*.tif"))) == 5


def test_interseg_main_without_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from ecseg_torch.core.config import Config
    from ecseg_torch.pipelines import interseg

    cfg = Config(raw={"interseg": {"inpath": str(tmp_path), "FISH_color": "red", "has_centromeric_probe": True}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interseg.main(config=cfg)


def test_interseg_runs_without_cv2_pandas_yaml_or_jax(tmp_path):
    """interseg as the card's machine runs it: ``python -m
    ecseg_torch.pipelines.interseg`` from a ``config.yaml`` (whose
    ``has_centromeric_probe: False`` must reach it as a bool), in a process
    where cv2, pandas, yaml, jax and ecseg_tpu cannot be imported, on a
    64x64 stat_fish output (a uint8 RGB TIFF, its segmentation TIFF, the
    CSV); with no model file, the seeded default classifiers."""
    img = np.zeros((64, 64, 3), np.uint8)
    yy, xx = np.ogrid[:64, :64]
    disk = (yy - 30) ** 2 + (xx - 34) ** 2 <= 15**2
    img[..., 0][disk] = 180  # red target (RGB on disk)
    img[..., 2][disk] = 200
    ann = tmp_path / "in" / "annotated"
    (ann / "cells").mkdir(parents=True)
    imgio.write_tiff(str(tmp_path / "in" / "cells.tif"), img)
    imgio.write_tiff(str(ann / "cells" / "cells_segmentation.tif"), disk.astype(np.uint8) * 255)
    (ann / "stat_fish_lsq.csv").write_text("image_name,Avg fish intensity (green)\ncells,1.5\n")
    (tmp_path / "config.yaml").write_text("interseg:\n  inpath: ./in\n  FISH_color: red\n  has_centromeric_probe: False\n")
    code = f"""
import sys
for name in ("cv2", "pandas", "yaml", "jax", "jaxlib", "ecseg_tpu"):
    sys.modules[name] = None
sys.path.insert(0, {str(REPO)!r})
from ecseg_torch.core.config import load_config
assert load_config().interseg.has_centromeric_probe is False
from ecseg_torch.pipelines import interseg
sys.exit(interseg.main(device="cpu"))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = (tmp_path / "in" / "interphase_prediction_red.csv").read_text().splitlines()
    assert rows[0] == "image_name,nucleus_center,interSeg_label,ecSeg-i_label" and len(rows) == 2
    assert rows[1].startswith("cells,30_34,")
