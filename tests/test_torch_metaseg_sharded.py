"""The port's multi-device metaseg paths (``pipelines/metaseg.py``:
``segment_folder_sharded_device``, its default on more than one device, and
``segment_folder_sharded``, under ``ECSEG_DEVICE_PIPELINE=0``) on a list of
four CPU entries, against the JAX package's on its 8-device virtual mesh.

The folder is ``tests/test_parallel.py``'s nine images (eight of 320x384,
one of 300x300) and a crowded 320x384 one, whose device post-processing
overflows (``ok`` False) and is redone on the host.  On four entries the
320x384 images make two full groups and a remainder, the 300x300 one a
group of its own; on the JAX mesh of eight, one full group and two
remainders.  Label maps, ecDNA counts, ``labels/*.npy`` and
``ec_quantification.csv`` bytes must be equal, the PNGs pixel-equal (the
JAX package writes RGB, the port a palette), across the JAX package's
multi-device runs, the port's mesh runs and its single-device run; the
kernel wrappers are called as often as in the single-device run."""

import collections
import os
import threading

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ecseg_tpu.core.config import Config as JConfig
from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_tpu.ops.meta_post import meta_inference as jax_meta_inference
from ecseg_tpu.parallel.mesh import make_mesh as jmake_mesh
from ecseg_tpu.pipelines import metaseg as jax_metaseg
from ecseg_torch.core.config import Config as TConfig
from ecseg_torch.models.weights import params_from_numpy
from ecseg_torch.ops import cc_kernels as K
from ecseg_torch.ops import meta_post_gpu, morphology_gpu
from ecseg_torch.pipelines import metaseg as port_metaseg
from ecseg_torch.runtime import fallbacks as port_fallbacks

import chip_smoke
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_metaseg_pipeline import _crafted_tiny_params

CPU4 = [torch.device("cpu")] * 4
NAMES = [f"im{k:02d}.tif" for k in range(10)]
CROWDED = "im09.tif"
SWITCHES = ("ECSEG_DEVICE_PIPELINE", "ECSEG_METASEG_GROUP", "ECSEG_METASEG_PATCH_BUDGET", "ECSEG_MC_LABEL", "ECSEG_MC_MERGE", "ECSEG_FAST_START")


def _make_folder(d):
    """tests/test_parallel.py:313-322's images and a crowded one (2x2 dots
    on a 4-px grid, tests/test_torch_metaseg_grouped.py's)."""
    os.makedirs(d)
    rng = np.random.default_rng(0)
    for k in range(9):
        h, w = (320, 384) if k != 5 else (300, 300)
        img = (rng.random((h, w)) * 60).astype(np.uint8)
        img[h // 4 : h // 2, w // 4 : w // 2] = 200
        img[20:24, 30:33] = 230
        cv2.imwrite(os.path.join(d, f"im{k:02d}.tif"), img)
    crowd = (np.random.default_rng(7).random((320, 384)) * 40).astype(np.uint8)
    for dy in (0, 1):
        for dx in (0, 1):
            crowd[4 + dy : 316 : 4, 4 + dx : 380 : 4] = 128
    cv2.imwrite(os.path.join(d, CROWDED), crowd)
    return [os.path.join(d, n) for n in NAMES]


def _outputs(d):
    files = {"csv": open(os.path.join(d, "ec_quantification.csv"), "rb").read()}
    for n in NAMES:
        stem = os.path.join(d, "labels", n[:-4])
        files[n] = open(stem + ".npy", "rb").read()
        files[n + " png"] = cv2.imread(stem + ".png")
    return files


def _assert_same(got, want, tag):
    assert got.keys() == want.keys()
    for key, w in want.items():
        if key.endswith(" png"):
            np.testing.assert_array_equal(got[key], w, err_msg=f"{tag} {key}")
        else:
            assert got[key] == w, f"{tag} {key}"


def _count_wrapper_calls(monkeypatch):
    """Each kernel wrapper's calls where the port's modules call it, counted
    under a lock (the sharded paths call them from several threads)."""
    calls = collections.Counter()
    lock = threading.Lock()
    for key, (_, fname, *_rest) in chip_smoke.KERNELS.items():
        fn = getattr(K, fname)

        def counted(*a, _fn=fn, _key=key, **kw):
            with lock:
                calls[_key] += 1
            return _fn(*a, **kw)

        for m in (meta_post_gpu, morphology_gpu, port_metaseg):
            if getattr(m, fname, None) is fn:
                monkeypatch.setattr(m, fname, counted)
    return calls


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    os.makedirs(d / "models")
    save_npz_pytree(str(d / "models" / "metaseg.npz"), _crafted_tiny_params())
    return d


@pytest.fixture(scope="module")
def folder(workdir):
    return _make_folder(str(workdir / "fn_inputs"))


@pytest.fixture(scope="module")
def jax_runs(workdir, folder):
    """The JAX package's two sharded folder functions on the flat 8-device
    mesh (``segment_folder_sharded_device`` by the test_parallel.py recipe,
    ``segment_folder_sharded`` with its host oracle), and ``main`` on the
    8-device mesh in both forms.  One process compiles each program once."""
    assert len(jax.devices()) >= 8, "the JAX suite's 8-device virtual CPU mesh (root conftest.py)"
    params = jax.tree.map(jnp.asarray, _crafted_tiny_params())
    mesh = jmake_mesh(8)
    device = list(jax_metaseg.segment_folder_sharded_device((params, jax_metaseg._default_forward), folder, mesh=mesh, save_dapi=False))
    host = [(p, jax_meta_inference(lab)) for p, lab in jax_metaseg.segment_folder_sharded(params, folder, mesh=mesh, batch_patches=16, save_dapi=False)]
    mains = {}
    with pytest.MonkeyPatch.context() as m:
        m.chdir(workdir)
        for var in SWITCHES:
            m.delenv(var, raising=False)
        for form, value in (("device", "1"), ("host", "0")):
            d = str(workdir / f"jax_main_{form}")
            _make_folder(d)
            m.setenv("ECSEG_DEVICE_PIPELINE", value)
            assert jax_metaseg.main(config=JConfig(raw={"metaseg": {"inpath": d}})) == 0
            mains[form] = _outputs(d)
    return {"device": device, "host": host, "main": mains}


def test_sharded_device_path_matches_jax(folder, jax_runs):
    before = port_fallbacks.counts().get(port_fallbacks.META_POST_OK, 0)
    got = list(port_metaseg.segment_folder_sharded_device(params_from_numpy(_crafted_tiny_params()), folder, CPU4))
    assert port_fallbacks.counts().get(port_fallbacks.META_POST_OK, 0) == before + 1  # the crowded image's redo
    assert [g[0] for g in got] == folder
    for (p, I, num), (q, J, jnum) in zip(got, jax_runs["device"]):
        assert p == q and I.dtype == J.dtype == np.int64
        np.testing.assert_array_equal(I, J, err_msg=p)
        assert num == jnum, p
    assert [g[2] for g in got] == [1] * 9 + [0]


def test_sharded_host_path_matches_jax(folder, jax_runs):
    got = list(port_metaseg.segment_folder_sharded(params_from_numpy(_crafted_tiny_params()), folder, CPU4, batch_patches=16))
    assert [g[0] for g in got] == folder
    for (p, raw), (q, J), (_, I, _) in zip(got, jax_runs["host"], jax_runs["device"]):
        assert p == q and raw.dtype == np.int64
        out, num = port_metaseg.host_post(raw)
        np.testing.assert_array_equal(out, J, err_msg=p)
        np.testing.assert_array_equal(out, I, err_msg=p)


@pytest.fixture(scope="module")
def port_mains(workdir):
    """``main`` on one device and on ``["cpu"] * 4``, in the default form
    and under ``ECSEG_DEVICE_PIPELINE=0``: (outputs, host redos, wrapper
    calls)."""
    out = {}
    for tag, kw, env in (
        ("one", {"device": "cpu"}, {}),
        ("mesh", {"devices": ["cpu"] * 4}, {}),
        ("one host", {"device": "cpu"}, {"ECSEG_DEVICE_PIPELINE": "0"}),
        ("mesh host", {"devices": ["cpu"] * 4}, {"ECSEG_DEVICE_PIPELINE": "0"}),
    ):
        d = str(workdir / tag.replace(" ", "_"))
        _make_folder(d)
        with pytest.MonkeyPatch.context() as m:
            m.chdir(workdir)
            for var in SWITCHES:
                m.delenv(var, raising=False)
            for var, value in env.items():
                m.setenv(var, value)
            calls = _count_wrapper_calls(m)
            before = port_fallbacks.counts().get(port_fallbacks.META_POST_OK, 0)
            assert port_metaseg.main(config=TConfig(raw={"metaseg": {"inpath": d}}), **kw) == 0
            redos = port_fallbacks.counts().get(port_fallbacks.META_POST_OK, 0) - before
        out[tag] = (_outputs(d), redos, dict(calls))
    return out


@pytest.mark.parametrize("tag", ["mesh", "mesh host", "one"])
def test_main_on_cpu_entries_matches_jax_main_on_its_mesh(port_mains, jax_runs, tag):
    _assert_same(port_mains[tag][0], jax_runs["main"]["device"], tag)
    _assert_same(jax_runs["main"]["host"], jax_runs["main"]["device"], "jax host")


def test_mesh_runs_equal_the_single_device_runs(workdir, port_mains):
    for tag in ("mesh", "one host", "mesh host"):
        _assert_same(port_mains[tag][0], port_mains["one"][0], tag)
    rows = port_mains["mesh"][0]["csv"].decode().splitlines()
    order = [os.path.basename(p) for p in port_metaseg.imgio.get_imgs(str(workdir / "mesh"))]
    assert sorted(order) == NAMES
    assert [r.split(",")[0] for r in rows[1:]] == order  # input order across groups and geometries


def test_redos_and_kernel_calls(port_mains):
    """One counted redo with the device post, none under ``=0``; the mesh
    calls each wrapper as often as one device (B1 once a canvas, B2-B6 per
    ``chip_smoke.PER_IMAGE_LAUNCHES``); the host path calls only the stitch,
    on host tensors (its twin: no launch on the card)."""
    assert {tag: r for tag, (_, r, _) in port_mains.items()} == {"one": 1, "mesh": 1, "one host": 0, "mesh host": 0}
    want = {k: n * len(NAMES) for k, n in chip_smoke.PER_IMAGE_LAUNCHES["default"].items() if k in chip_smoke.KERNELS and n}
    assert port_mains["one"][2] == want
    assert port_mains["mesh"][2] == want
    assert port_mains["mesh host"][2] == {"stitch": len(NAMES)}


def test_sharded_host_path_pads_its_last_batch_and_ignores_the_rest_of_the_folder(folder, monkeypatch):
    """ROADMAP C8's remainder: on two entries every chunk dispatched has the
    one shape (``batch_patches`` / 2 patches), the last batch padded with
    zero patches whose labels are dropped; each image's raw labels equal
    its single-device ``segment_raw`` and a run on the folder reversed with
    one image removed (its patches in other batches, beside others)."""
    model = params_from_numpy(_crafted_tiny_params())
    shapes = []
    real = port_metaseg._patch_labels_on

    def recording(replica, dev, chunk):
        shapes.append(chunk.shape)
        return real(replica, dev, chunk)

    monkeypatch.setattr(port_metaseg, "_patch_labels_on", recording)
    cpu2 = [torch.device("cpu")] * 2
    got = list(port_metaseg.segment_folder_sharded(model, folder, cpu2, batch_patches=16))
    prepared = {p: port_metaseg._prepare_image(p, save_dapi=False) for p in folder}
    total = sum(len(patches) for patches, _ in prepared.values())
    assert total % 16, "the folder must leave a partial last batch"
    assert set(shapes) == {(8, 256, 256, 1)} and len(shapes) == 2 * -(-total // 16)
    assert [p for p, _ in got] == folder
    for path, raw in got:
        want = port_metaseg.segment_raw(model, *prepared[path]).numpy().astype(np.int64)
        np.testing.assert_array_equal(raw, want, err_msg=path)
    others = folder[::-1][1:]
    again = list(port_metaseg.segment_folder_sharded(model, others, cpu2, batch_patches=16))
    assert [p for p, _ in again] == others
    ref = dict(got)
    for path, raw in again:
        np.testing.assert_array_equal(raw, ref[path], err_msg=path)
