"""The port's fish_distance_calculation (host only,
ecseg_torch/pipelines/fish_distance.py) against the JAX package's module:
``image_distances`` on tests/test_fish_distance.py's synthetic cells, and
``main``'s ``centromere_distances.csv`` bytes (the port writes it without
pandas) on a folder of stat_fish outputs whose LSQ images are written by
the JAX package's ``imgio.imwrite`` (cv2) as stat_fish writes them,
uncompressed and, under ``ECSEG_TIF_LZW=1``, LZW.  Exact equality: both
compute each float64 by the same formula."""

import os

import numpy as np
import pytest

from ecseg_tpu.core import imgio as jax_imgio
from ecseg_tpu.core.config import Config as JaxConfig
from ecseg_tpu.pipelines import fish_distance as jax_fd
from ecseg_torch.core.config import Config as PortConfig
from ecseg_torch.pipelines import fish_distance as port_fd

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)


def _synthetic(rng, n_cells=6, shape=(160, 160), per_channel=((0, 4), (1, 3), (2, 5))):
    """tests/test_fish_distance.py:42-60."""
    seg = np.zeros(shape, np.int64)
    lsq = np.zeros(shape + (3,), np.uint8)
    for lab in range(1, n_cells + 1):
        cy, cx = rng.integers(20, shape[0] - 20, 2)
        r = int(rng.integers(10, 18))
        yy, xx = np.ogrid[: shape[0], : shape[1]]
        disk = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        disk &= seg == 0
        seg[disk] = lab
        ys, xs = np.nonzero(disk)
        if len(ys) == 0:
            continue
        for ch, k in per_channel:
            take = rng.choice(len(ys), size=min(k, len(ys)), replace=False)
            lsq[ys[take], xs[take], ch] = 200
    return lsq, seg


@pytest.mark.parametrize("trial", range(5))
def test_image_distances_match_jax(trial):
    rng = np.random.default_rng(100 + trial)
    lsq, seg = _synthetic(rng)
    for cent_idx, fish_idx in [(0, 1), (1, 0), (0, 2)]:
        for max_spots in (0, 3, 10):
            want = jax_fd.image_distances(lsq, seg, cent_idx, fish_idx, max_spots)
            assert port_fd.image_distances(lsq, seg, cent_idx, fish_idx, max_spots) == want


def test_min_set_distance_and_quirks():
    f = np.array([[0, 0], [10, 10]])
    c = np.array([[0, 3], [20, 20]])
    assert port_fd.min_set_distance(f, c) == jax_fd.min_set_distance(f, c) == 3.0
    assert port_fd.min_set_distance(np.empty((0, 2)), c) == float("inf")
    with pytest.raises(ValueError):
        port_fd.min_set_distance(f, np.empty((0, 2)))
    seg = np.zeros((40, 40), np.int64)
    seg[5:25, 5:25] = 1
    lsq = np.zeros((40, 40, 3), np.uint8)
    lsq[10, 10, 0] = lsq[12, 12, 1] = 1  # the gate on channels 0 and 1
    assert port_fd.image_distances(lsq, seg, 0, 2, 10) == jax_fd.image_distances(lsq, seg, 0, 2, 10) == [float("inf")]


def _folder(root, lzw, monkeypatch):
    rng = np.random.default_rng(9)
    os.makedirs(root)
    with monkeypatch.context() as m:
        m.setenv("ECSEG_TIF_LZW", "1" if lzw else "0")
        for k in range(3):
            name = f"img{k}"
            # imwrite takes cv2's BGR order and fish_distance reads RGB, so
            # the file's red (the FISH probe) is this array's channel 2
            lsq, seg = _synthetic(rng, 8, (200, 240), ((0, 4), (1, 3), (2, 2)))
            assert jax_imgio.imwrite(os.path.join(root, f"{name}.tif"), lsq[..., 0])
            ann = os.path.join(root, "annotated", name)
            os.makedirs(ann)
            np.save(os.path.join(ann, f"{name}__segmentation_min_cut.npy"), seg)
            assert jax_imgio.imwrite(os.path.join(ann, f"{name}_lsq_n15_std1.00_s5_g70.0_r70.0.tif"), lsq)


@pytest.mark.parametrize("lzw", [False, True], ids=["uncompressed", "lzw"])
def test_main_csv_bytes_match_jax(tmp_path, monkeypatch, lzw):
    jax_root, port_root = str(tmp_path / "jax"), str(tmp_path / "port")
    for root in (jax_root, port_root):
        _folder(root, lzw, monkeypatch)
    section = {"centromere_probe_color": "green", "fish_probe_color": "red", "max_centromeric_spots": 3}
    assert jax_fd.main(config=JaxConfig(raw={"fish_distance_calculation": {"inpath": jax_root, **section}})) == 0
    assert port_fd.main(config=PortConfig(raw={"fish_distance_calculation": {"inpath": port_root, **section}})) == 0
    with open(os.path.join(jax_root, "centromere_distances.csv"), "rb") as f:
        want = f.read()
    with open(os.path.join(port_root, "centromere_distances.csv"), "rb") as f:
        got = f.read()
    assert got == want
    assert len(got.decode().splitlines()) > 10


def test_main_without_annotated_raises(tmp_path):
    cfg = PortConfig(raw={"fish_distance_calculation": {
        "inpath": str(tmp_path), "centromere_probe_color": "green", "fish_probe_color": "red", "max_centromeric_spots": 3,
    }})
    with pytest.raises(FileNotFoundError):
        port_fd.main(config=cfg)
