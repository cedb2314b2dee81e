"""The port's grouped metaseg dispatch (``ECSEG_METASEG_GROUP``, the JAX
package's default single-device path) and its ``ECSEG_DEVICE_PIPELINE=0``
host branch against the JAX package's grouped run.

The folder is tests/test_metaseg_pipeline.py's grouped case (three images
of two geometries, so the geometry buckets are partial groups at the end of
the folder) plus an image with more than MAX_NUC nuclei in the first
geometry, whose device post-processing overflows and is redone on the host
inside its group.  The JAX package runs it once, grouped on one CPU device
(``ECSEG_DEVICE_PIPELINE=1``, partial groups zero-padded); the port runs it
per image (``ECSEG_METASEG_GROUP=1``), grouped (the default 8), in pairs (a
pair of the first geometry is flushed before the end of the folder),
clamped (``ECSEG_METASEG_PATCH_BUDGET=4``: every flush holds one image) and
with the host post.  The rows keep the folder's listing order.  ``labels/*.npy`` and ``ec_quantification.csv`` must be
byte-equal, the PNGs pixel-equal (the JAX package writes RGB, the port a
palette), and the port's runs byte-equal to each other."""

import os

import cv2
import numpy as np
import pytest

import jax

from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_tpu.pipelines import metaseg as jax_metaseg
from ecseg_torch.core.config import Config as PortConfig
from ecseg_torch.pipelines import metaseg as port_metaseg
from ecseg_torch.runtime import fallbacks as port_fallbacks

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_meta_post_forms import _count_wrapper_calls
from test_torch_metaseg_pipeline import _crafted_tiny_params

NAMES = ["im0.tif", "im1.tif", "im2.tif", "im3.tif"]
PORT_RUNS = {  # run -> its environment
    "per_image": {"ECSEG_METASEG_GROUP": "1"},
    "grouped": {},
    "pairs": {"ECSEG_METASEG_GROUP": "2"},
    "clamped": {"ECSEG_METASEG_PATCH_BUDGET": "4"},
    "host_post": {"ECSEG_DEVICE_PIPELINE": "0"},
}
SWITCHES = ("ECSEG_METASEG_GROUP", "ECSEG_METASEG_PATCH_BUDGET", "ECSEG_DEVICE_PIPELINE")


def _make_folder(d):
    """tests/test_metaseg_pipeline.py:174-182's images (im0, im2 320x384, im1
    256x320) and a crowded 320x384 im3: 2x2 dots on a 4-px grid."""
    os.makedirs(d)
    frng = np.random.default_rng(7)
    for k in range(3):
        h, w = (320, 384) if k != 1 else (256, 320)
        img = (frng.random((h, w)) * 60).astype(np.uint8)
        img[40:120, 50:130] = 200
        img[200 - 8 * k : 210, 200:206] = 180
        cv2.imwrite(os.path.join(d, f"im{k}.tif"), img)
    crowd = (frng.random((320, 384)) * 40).astype(np.uint8)
    for dy in (0, 1):
        for dx in (0, 1):
            crowd[4 + dy : 316 : 4, 4 + dx : 380 : 4] = 128
    cv2.imwrite(os.path.join(d, "im3.tif"), crowd)


def _outputs(d):
    files = {"csv": open(os.path.join(d, "ec_quantification.csv"), "rb").read()}
    for n in NAMES:
        stem = os.path.join(d, "labels", n[:-4])
        files[n] = open(stem + ".npy", "rb").read()
        files[n + " png"] = cv2.imread(stem + ".png")
    return files


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("grouped")
    os.makedirs(d / "models")
    save_npz_pytree(str(d / "models" / "metaseg.npz"), _crafted_tiny_params())
    return d


@pytest.fixture(scope="module")
def jax_grouped(workdir):
    """The JAX package's grouped single-device run, once."""
    from ecseg_tpu.core.config import Config

    folder = str(workdir / "jax")
    _make_folder(folder)
    dev0 = jax.devices()[0]
    with pytest.MonkeyPatch.context() as m:
        m.chdir(workdir)
        m.setattr(jax_metaseg.jax, "devices", lambda *a, **k: [dev0])
        m.setenv("ECSEG_DEVICE_PIPELINE", "1")
        for var in SWITCHES[:2] + ("ECSEG_FAST_START", "ECSEG_MC_LABEL", "ECSEG_MC_MERGE"):
            m.delenv(var, raising=False)
        assert jax_metaseg._group_size() == 8
        assert jax_metaseg.main(config=Config(raw={"metaseg": {"inpath": folder}})) == 0
    return _outputs(folder)


@pytest.fixture(scope="module")
def port_runs(workdir):
    """Each of ``PORT_RUNS`` on its own copy of the folder: (outputs, host
    redos, kernel wrapper calls)."""
    out = {}
    for run, env in PORT_RUNS.items():
        folder = str(workdir / run)
        _make_folder(folder)
        with pytest.MonkeyPatch.context() as m:
            m.chdir(workdir)
            for var in SWITCHES + ("ECSEG_MC_LABEL", "ECSEG_MC_MERGE"):
                m.delenv(var, raising=False)
            for var, value in env.items():
                m.setenv(var, value)
            calls = _count_wrapper_calls(m)
            before = port_fallbacks.counts().get(port_fallbacks.META_POST_OK, 0)
            assert port_metaseg.main(config=PortConfig(raw={"metaseg": {"inpath": folder}}), device="cpu") == 0
            redos = port_fallbacks.counts().get(port_fallbacks.META_POST_OK, 0) - before
        out[run] = (_outputs(folder), redos, calls)
    return out


@pytest.mark.parametrize("run", sorted(PORT_RUNS))
def test_port_run_matches_jax_grouped_run(workdir, jax_grouped, port_runs, run):
    got, _, _ = port_runs[run]
    for key, want in jax_grouped.items():
        if key.endswith(" png"):
            np.testing.assert_array_equal(got[key], want, err_msg=key)
        else:
            assert got[key] == want, key
    rows = got["csv"].decode().splitlines()
    order = [os.path.basename(p) for p in port_metaseg.imgio.get_imgs(str(workdir / run))]
    assert sorted(order) == NAMES
    assert [r.rsplit(",", 1)[0] for r in rows[1:]] == order  # input order across the interleaved geometries


def test_port_runs_are_byte_equal_to_each_other(port_runs):
    ref = port_runs["per_image"][0]
    for run, (got, _, _) in port_runs.items():
        for key, want in ref.items():
            if key.endswith(" png"):
                np.testing.assert_array_equal(got[key], want, err_msg=f"{run} {key}")
            else:
                assert got[key] == want, f"{run} {key}"


def test_crowded_image_redone_on_the_host_once(port_runs):
    """One counted host redo in each device-post run (the crowded image,
    inside its group); the host branch records none."""
    assert {run: r for run, (_, r, _) in port_runs.items()} == {run: int(run != "host_post") for run in PORT_RUNS}


def test_kernel_calls_per_run(port_runs):
    """Every device-post run calls each wrapper as often as the per-image
    run (grouping changes no launch); the host branch calls B1 once an
    image and nothing else."""
    per_image = port_runs["per_image"][2]
    assert per_image["stitch"] == len(NAMES) and per_image["label"] > 0
    for run in ("grouped", "pairs", "clamped"):
        assert port_runs[run][2] == per_image, run
    assert port_runs["host_post"][2] == {key: len(NAMES) if key == "stitch" else 0 for key in per_image}


@pytest.mark.parametrize("value", [None, "1", "3", "x", "0", " 2 "])
def test_group_size_parsed_as_the_jax_package_parses_it(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("ECSEG_METASEG_GROUP", raising=False)
    else:
        monkeypatch.setenv("ECSEG_METASEG_GROUP", value)
    assert port_metaseg._group_size() == jax_metaseg._group_size()


@pytest.mark.parametrize("budget,n,group,want", [(None, 100, 8, 2), (None, 25, 8, 8), ("300", 100, 3, 3), ("4", 20, 8, 1), (None, 300, 8, 1)])
def test_geo_group_caps_the_patches_of_a_forward(monkeypatch, budget, n, group, want):
    """At 2048^2 (100 patches) the default budget of 256 gives groups of 2."""
    if budget is None:
        monkeypatch.delenv("ECSEG_METASEG_PATCH_BUDGET", raising=False)
    else:
        monkeypatch.setenv("ECSEG_METASEG_PATCH_BUDGET", budget)
    assert port_metaseg.geo_group([(0, 0)] * n, group) == want
