"""The port's interseg (ecseg_torch/pipelines/interseg.py) against the JAX
package's ``interseg.main`` on the same stat_fish outputs and the same
classifier weights: the crafted demo trees, which the JAX loader is
monkeypatched to return (as tests/test_interseg_e2e.py does) and the port
reads from ``interseg_models/*.npz``.  ``interphase_prediction_<color>.csv``
must be byte-equal and stdout equal, for:

- ``FISH_color`` red and green x ``has_centromeric_probe`` True and False,
  on a folder of three images (a 680^2 one with a normal, a dim, a
  centromere-less, an oversized (grid-tiled), a zero-DAPI (ecSeg-c's input
  0/0, so its sigmoid is NaN and the label "No-amp"), a sparse-foci and a
  bright nucleus; a 300^2 one with a single stat_fish row (kurtosis NaN);
  a 200^2 one with no region);
- an image with an all-digit name (its CSV ``image_name`` reads as int64,
  so no row matches and every ecSeg-c row reads "Failed Centromeric
  Quality Score");
- the missing-inpath and bad-colour exits (rc 2, the same stdout).

The JAX side runs sequentially (``ECSEG_INTERSEG_SHARD=0``); its sharded
path writes the same bytes by design."""

import os

import cv2
import numpy as np
import pandas as pd
import pytest

from ecseg_tpu.core.config import Config as JConfig
from ecseg_tpu.models import demo as jdemo
from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_tpu.pipelines import interseg as jis
from ecseg_tpu.runtime import fallbacks as jfallbacks
from ecseg_torch.core.config import Config as TConfig
from ecseg_torch.pipelines import interseg as tis
from ecseg_torch.runtime import fallbacks as tfallbacks

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)


def _write_image(d, name, shape, nuclei, rng):
    """A BGR uint8 image and its stat_fish segmentation: ``nuclei`` are
    (y, x, r, red, green, blue, kind); kind "noise" adds speckle to the
    red/green level, "foci" puts a few 6x6 foci of 250 on it."""
    h, w = shape
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = 15  # dim DAPI floor
    seg = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for y, x, r, red, green, blue, kind in nuclei:
        m = (yy - y) ** 2 + (xx - x) ** 2 <= r * r
        seg[m] = 255
        img[..., 0][m] = blue
        img[..., 1][m] = green
        img[..., 2][m] = red
        if kind == "noise":
            for ch in (1, 2):
                img[..., ch][m] = np.clip(img[..., ch][m].astype(int) + rng.integers(0, 40, m.sum()), 0, 255)
        elif kind == "foci":
            for dy, dx in ((-r // 2, -r // 3), (r // 3, r // 4), (0, r // 2)):
                img[y + dy : y + dy + 6, x + dx : x + dx + 6, 2] = 250
                img[y + dy : y + dy + 6, x + dx : x + dx + 6, 1] = 250
    cv2.imwrite(os.path.join(d, f"{name}.tif"), img)
    sub = os.path.join(d, "annotated", name)
    os.makedirs(sub, exist_ok=True)
    cv2.imwrite(os.path.join(sub, f"{name}_segmentation.tif"), seg)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    root = tmp_path_factory.mktemp("interseg_port")
    rng = np.random.default_rng(7)
    main = str(root / "main")
    os.makedirs(main)
    _write_image(main, "cells", (680, 680), [
        (60, 60, 35, 160, 90, 200, "noise"),  # normal
        (60, 180, 30, 2, 90, 200, "plain"),  # dim target (red)
        (60, 300, 30, 160, 0, 200, "plain"),  # no centromere (green)
        (60, 420, 40, 180, 80, 0, "noise"),  # zero DAPI: ecSeg-c's input is 0/0
        (60, 540, 40, 30, 70, 200, "foci"),  # sparse foci
        (60, 640, 30, 250, 250, 220, "plain"),  # bright
        (160, 620, 25, 20, 60, 200, "plain"),  # faint target: ecSeg-i No-amp
        (420, 340, 258, 140, 60, 200, "noise"),  # oversized: grid-tiled
    ], rng)
    _write_image(main, "single", (300, 300), [(100, 100, 40, 150, 80, 200, "noise"), (220, 200, 30, 200, 40, 180, "plain")], rng)
    _write_image(main, "empty", (200, 200), [], rng)
    green = [80.0, 85.0, 2.0, 60.0, 70.0, 90.0, 75.0, 65.0, 88.0, 71.0]  # kurtosis 1.8: red mode passes
    red = [1.0] * 9 + [200.0]  # kurtosis > 3: green mode fails
    pd.DataFrame({
        "image_name": ["cells"] * 10 + ["single"],
        "nucleus_center": [f"{k}_{k}" for k in range(11)],
        "Avg fish intensity (green)": green + [40.0],
        "Avg fish intensity (red)": red + [7.5],
    }).to_csv(os.path.join(main, "annotated", "stat_fish_lsq.csv"), index=False)

    digits = str(root / "digits")
    os.makedirs(digits)
    _write_image(digits, "001", (300, 300), [(90, 90, 40, 160, 90, 200, "noise"), (200, 200, 35, 120, 70, 200, "noise")], rng)
    pd.DataFrame({
        "image_name": ["001", "001", "002"],
        "nucleus_center": ["90_90", "200_200", "5_5"],
        "Avg fish intensity (green)": [80.0, 60.0, 70.0],
        "Avg fish intensity (red)": [150.0, 120.0, 90.0],
    }).to_csv(os.path.join(digits, "annotated", "stat_fish_lsq.csv"), index=False)

    work = str(root / "work")  # the port reads interseg_models/*.npz from here
    trees = (jdemo.demo_ecseg_i_params(), jdemo.demo_ecseg_c_params())
    save_npz_pytree(os.path.join(work, "interseg_models", "interseg.npz"), trees[0]) if os.makedirs(os.path.join(work, "interseg_models")) is None else None
    save_npz_pytree(os.path.join(work, "interseg_models", "ecseg_c.npz"), trees[1])
    return {"main": main, "digits": digits, "work": work, "trees": trees}


def _cfg(cls, inpath, color, cent):
    return cls(raw={"interseg": {"inpath": inpath, "FISH_color": color, "has_centromeric_probe": cent}})


def _run_both(folders, inpath, color, cent, monkeypatch, capsys):
    """(JAX rc, stdout, CSV bytes or None), then the port's."""
    i_tree, c_tree = folders["trees"]
    monkeypatch.setenv("ECSEG_INTERSEG_SHARD", "0")
    monkeypatch.setattr(jis, "load_classifier_models", lambda has_cent, model_dir="interseg_models": (i_tree, c_tree if has_cent else None))
    monkeypatch.chdir(folders["work"])
    out = os.path.join(inpath, f"interphase_prediction_{str(color).lower()}.csv")
    results = []
    for main, cls, kw in ((jis.main, JConfig, {}), (tis.main, TConfig, {"device": "cpu"})):
        if os.path.exists(out):
            os.remove(out)
        # the fallback counters are process-global: other tests of this
        # worker must not reach the summary line either package prints
        jfallbacks.reset()
        tfallbacks.reset()
        capsys.readouterr()
        rc = main(config=_cfg(cls, inpath, color, cent), **kw)
        stdout = capsys.readouterr().out
        results.append((rc, stdout, open(out, "rb").read() if os.path.exists(out) else None))
    return results


@pytest.mark.parametrize("cent", [True, False], ids=["centromere", "no_centromere"])
@pytest.mark.parametrize("color", ["red", "green"])
def test_interseg_csv_bytes_equal_jax(folders, monkeypatch, capsys, color, cent):
    want, got = _run_both(folders, folders["main"], color, cent, monkeypatch, capsys)
    assert got == want
    rc, stdout, csv = got
    assert rc == 0 and stdout.count("Processing image:") == 3
    text = csv.decode()
    assert "No_Prediction (Low_TRGT_brightness)" in text and "HSR-amp" in text and "EC-amp" in text
    assert text.count("\ncells,420_340,") == 4  # the oversized nucleus's grid patches
    if cent and color == "red":  # the gates this fixture is for
        for s in ("No_Prediction (Low_CENT_Brightness)", "No_Prediction (Failed Centromeric Quality Score)", "Focal-amp"):
            assert s in text, s
        rows = {r.split(",")[1]: r.split(",")[2:] for r in text.splitlines()[1:] if r.startswith("cells,")}
        assert rows["60_420"][:2] == ["No-amp", "No-amp"]  # zero DAPI: NaN sigmoid, "No-amp"
        assert rows["160_620"][2] == "No-amp"
    if cent and color == "green":  # the red column's kurtosis fails the gate on every image
        assert "Focal-amp" not in text
    assert text.count("\nsingle,") == 2 and "\nempty," not in text


def test_interseg_all_digit_names_fail_the_quality_gate(folders, monkeypatch, capsys):
    want, got = _run_both(folders, folders["digits"], "red", True, monkeypatch, capsys)
    assert got == want and got[0] == 0
    rows = got[2].decode().splitlines()[1:]
    assert len(rows) == 2 and all(r.split(",")[3] == "No_Prediction (Failed Centromeric Quality Score)" for r in rows)


@pytest.mark.parametrize(
    "inpath, color", [("/nonexistent/nope", "red"), (None, "blue")], ids=["missing_inpath", "bad_colour"]
)
def test_interseg_early_exits_match_jax(folders, monkeypatch, capsys, inpath, color):
    want, got = _run_both(folders, inpath or folders["digits"], color, True, monkeypatch, capsys)
    assert got == want
    assert got[0] == 2 and got[1].strip() in (
        "Input folder does not exist. Exiting...",
        'FISH_color can only be "green" or "red". Please update the config.yaml file accordingly.',
    )
