"""The port's metaseg slice as a whole: ``ecseg_torch.pipelines.metaseg.main``
on the CPU against ``ecseg_tpu.pipelines.metaseg.main`` on copies of one
folder with one set of weights (written once through save_npz_pytree and
read by both packages' ``load_model``).  ``labels/*.npy`` and
``ec_quantification.csv`` must be byte-identical; the PNG and the ``dapi/``
TIFF must decode to identical pixels.

The folder holds the geometry of tests/test_device_pipeline_e2e.py (a cv2
TIFF, which the port hands to cv2), a uint16 image in an uncompressed TIFF
(decoded by the port itself) and an image with more than MAX_NUC nuclei,
whose device post-processing overflows its budget and is redone on the
host oracle."""

import os

import cv2
import numpy as np
import pytest

import jax

from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_torch.core.config import Config as PortConfig
from ecseg_torch.pipelines import metaseg as port_metaseg
from ecseg_torch.runtime import fallbacks as port_fallbacks

from _torchutil import numpy_metaseg_tree, single_torch_thread  # noqa: F401 (autouse fixture)


def _crafted_tiny_params():
    """widths (8, 16)/32 with the demo crafting of ecseg_tpu/models/demo.py
    applied in numpy: brightness bands -> classes, large argmax margins."""
    p = numpy_metaseg_tree((8, 16), 32)
    for name in ("enc1_1", "enc1_2", "dec1_1", "dec1_2"):
        k = np.zeros_like(p[name]["kernel"])
        k[1, 1, 0, 0] = 1.0
        p[name]["kernel"] = k
        p[name]["bias"] = np.zeros_like(p[name]["bias"])
    head = np.zeros_like(p["head"]["kernel"])
    head[0, 0, 0, 1] = 20.0
    head[0, 0, 0, 3] = 40.0
    p["head"]["kernel"] = head
    p["head"]["bias"] = np.array([6.0, 0.0, -1e3, -14.0], np.float32)
    return p


def _make_folder(d):
    os.makedirs(d)
    rng = np.random.default_rng(42)
    # tests/test_device_pipeline_e2e.py:22-30, written by cv2 (compressed)
    img = (rng.random((320, 384)) * 60).astype(np.uint8)
    img[40:120, 50:130] = 200
    img[200:210, 200:206] = 180
    img[250:253, 300:303] = 230
    cv2.imwrite(os.path.join(d, "sample.tif"), img)
    # uint16, uncompressed: nuclei discs and ecDNA dots
    yy, xx = np.mgrid[:300, :520]
    img16 = (rng.random((300, 520)) * 8000).astype(np.uint16)
    for cy, cx, r in [(80, 100, 40), (200, 300, 55), (150, 450, 30)]:
        img16[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 33000
    for _ in range(60):
        y, x = rng.integers(2, 296), rng.integers(2, 516)
        img16[y : y + int(rng.integers(1, 6)), x : x + int(rng.integers(1, 6))] = 60000
    cv2.imwrite(os.path.join(d, "wide16.tif"), img16, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    # > MAX_NUC (512) nuclei: 2x2 mid-brightness dots on a 4-px grid
    crowd = (rng.random((260, 300)) * 40).astype(np.uint8)
    crowd[4:256:4, 4:296:4] = 128
    crowd[5:256:4, 4:296:4] = 128
    crowd[4:256:4, 5:296:4] = 128
    crowd[5:256:4, 5:296:4] = 128
    cv2.imwrite(os.path.join(d, "crowded.tif"), crowd, [cv2.IMWRITE_TIFF_COMPRESSION, 1])
    return sorted(os.listdir(d))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    os.makedirs(tmp_path / "models")
    save_npz_pytree(str(tmp_path / "models" / "metaseg.npz"), _crafted_tiny_params())
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _run_jax(folder, monkeypatch):
    from ecseg_tpu.core.config import Config
    from ecseg_tpu.pipelines import metaseg

    dev0 = jax.devices()[0]
    with monkeypatch.context() as m:
        # the single-device per-image program with the host oracle post
        m.setattr(metaseg.jax, "devices", lambda *a, **k: [dev0])
        m.setenv("ECSEG_DEVICE_PIPELINE", "0")
        assert metaseg.main(config=Config(raw={"metaseg": {"inpath": folder}})) == 0


def test_port_main_matches_jax_main(workdir, monkeypatch):
    jdir, tdir = str(workdir / "jax"), str(workdir / "port")
    names = _make_folder(jdir)
    assert _make_folder(tdir) == names
    _run_jax(jdir, monkeypatch)
    before = port_fallbacks.counts().get(port_fallbacks.META_POST_OK, 0)
    assert port_metaseg.main(config=PortConfig(raw={"metaseg": {"inpath": tdir}}), device="cpu") == 0
    # the crowded image's budget overflow went through the counted host redo
    assert port_fallbacks.counts()[port_fallbacks.META_POST_OK] == before + 1

    rel = ["ec_quantification.csv"] + [f"labels/{n[:-4]}.npy" for n in names]
    for r in rel:
        assert _read(os.path.join(tdir, r)) == _read(os.path.join(jdir, r)), r
    for n in names:
        png = f"labels/{n[:-4]}.png"  # RGB (JAX) and palette (port) PNGs
        np.testing.assert_array_equal(
            cv2.imread(os.path.join(tdir, png)), cv2.imread(os.path.join(jdir, png))
        )
        a = cv2.imread(os.path.join(jdir, "dapi", n), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(tdir, "dapi", n), cv2.IMREAD_UNCHANGED)
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(b, a)
    labels = np.load(os.path.join(tdir, "labels", "wide16.npy"))
    assert labels.dtype == np.int64 and set(np.unique(labels)) == {0, 1, 3}


def test_missing_folder_exit_code(capsys):
    cfg = PortConfig(raw={"metaseg": {"inpath": "/nonexistent/nope"}})
    assert port_metaseg.main(config=cfg, device="cpu") == 2
    assert "Input folder does not exist. Exiting..." in capsys.readouterr().out


def test_empty_folder_writes_header_only_csv(workdir, monkeypatch):
    jdir, tdir = str(workdir / "ej"), str(workdir / "et")
    os.makedirs(jdir)
    os.makedirs(tdir)
    _run_jax(jdir, monkeypatch)
    assert port_metaseg.main(config=PortConfig(raw={"metaseg": {"inpath": tdir}}), device="cpu") == 0
    got = _read(os.path.join(tdir, "ec_quantification.csv"))
    assert got == _read(os.path.join(jdir, "ec_quantification.csv")) == b"image name,# of ec\n"


def test_load_model_refuses_h5_alone(tmp_path):
    (tmp_path / "metaseg.h5").write_bytes(b"")
    with pytest.raises(RuntimeError, match="ROADMAP A7"):
        port_metaseg.load_model(str(tmp_path), device="cpu")
