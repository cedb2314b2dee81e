"""The port's fan-outs of a folder's images over a device list
(``meta_overlay``, ``interseg`` and ``stat_fish`` ``main(devices=...)``),
on lists of three CPU entries: outputs equal to the port's sequential run
(``device="cpu"``), to the JAX package's ``*_SHARD=1`` run on its 8-device
virtual mesh, and to the port's run under each ``*_SHARD=0`` switch, which
takes the sequential path.  CSV, ``.npy`` and PNG bytes are compared
between the port's runs; against the JAX package, CSV and ``.npy`` bytes,
and PNG and TIFF pixels (read back with cv2)."""

import collections
import os
import shutil

import numpy as np
import pytest

import jax

from ecseg_tpu.core.config import Config as JConfig
from ecseg_tpu.pipelines import interseg as jis
from ecseg_tpu.pipelines import meta_overlay as jmo
from ecseg_tpu.pipelines import stat_fish as jsf
from ecseg_torch.core import imgio
from ecseg_torch.core.config import Config as TConfig
from ecseg_torch.models.keras_import import KerasModel
from ecseg_torch.pipelines import interseg as tis
from ecseg_torch.pipelines import meta_overlay as tmo
from ecseg_torch.pipelines import stat_fish as tsf
from ecseg_torch.runtime import batching

import chip_smoke
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)
from test_sharded_folder_fanout import _overlay_folder
from test_torch_interseg import folders  # noqa: F401 (module fixture)
from test_torch_keras_import import write_legacy_h5
from test_torch_meta_overlay_pipeline import _assert_same_outputs as _assert_same_overlay
from test_torch_stat_fish import _assert_same_outputs as _assert_same_stat_fish
from test_torch_stat_fish import _make_folder as _stat_fish_folder
from test_torch_stat_fish import workdir  # noqa: F401 (module fixture)

CPU3 = ["cpu"] * 3
RUNS = {  # tag -> (main's device arguments, the *_SHARD value, fan-out expected)
    "sequential": ({"device": "cpu"}, None, False),
    "mesh": ({"devices": CPU3}, None, True),
    "mesh_shard_0": ({"devices": CPU3}, "0", False),
}


def _spy_fan_out(monkeypatch, module):
    """Count the module's ``fan_out`` calls and the items each ran, by
    entry."""
    calls = []

    def spy(fn, items, devices, start=0, per_device=2):
        entries = collections.Counter()

        def counted(item, k):
            entries[k] += 1
            return fn(item, k)

        calls.append(entries)
        yield from batching.fan_out(counted, items, devices, start, per_device)

    monkeypatch.setattr(module, "fan_out", spy)
    return calls


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_jax_sharded(var):
    assert len(jax.devices()) >= 8, "the JAX suite's 8-device virtual CPU mesh (root conftest.py)"
    assert os.environ.get(var, "1") == "1"


# --------------------------------------------------------------------------
# meta_overlay
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def overlay_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("overlay_fanout")
    out = {}
    with pytest.MonkeyPatch.context() as m:
        for var in ("ECSEG_OVERLAY_SHARD", "ECSEG_DEVICE_PIPELINE"):
            m.delenv(var, raising=False)
        d = str(root / "jax")
        _overlay_folder(d)
        _assert_jax_sharded("ECSEG_OVERLAY_SHARD")
        assert jmo.main(config=JConfig(raw={"meta_overlay": {"inpath": d, "color_sensitivity": 85}})) == 0
        out["jax"] = (d, None)
        for tag, (kw, shard, _) in RUNS.items():
            d = str(root / tag)
            _overlay_folder(d)
            if shard is not None:
                m.setenv("ECSEG_OVERLAY_SHARD", shard)
            calls = _spy_fan_out(m, tmo)
            assert tmo.main(config=TConfig(raw={"meta_overlay": {"inpath": d, "color_sensitivity": 85}}), **kw) == 0
            m.delenv("ECSEG_OVERLAY_SHARD", raising=False)
            out[tag] = (d, calls)
    return out


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_meta_overlay_fanout(overlay_runs, tag):
    d, calls = overlay_runs[tag]
    _assert_same_overlay(d, overlay_runs["jax"][0])
    ref = overlay_runs["sequential"][0]
    assert _read(os.path.join(d, "fish_quantification.csv")) == _read(os.path.join(ref, "fish_quantification.csv"))
    for sub in ("red", "green"):
        for name in sorted(os.listdir(os.path.join(ref, sub))):
            assert _read(os.path.join(d, sub, name)) == _read(os.path.join(ref, sub, name)), f"{sub}/{name}"
    if RUNS[tag][2]:
        assert calls == [collections.Counter({0: 2, 1: 2, 2: 1})]  # image k on entry k % 3
    else:
        assert calls == []


# --------------------------------------------------------------------------
# interseg
# --------------------------------------------------------------------------


def _interseg_run(folders, monkeypatch, tmp, tag, kw, shard, work=None):
    d = str(tmp / tag)
    shutil.copytree(folders["main"], d)
    cfg = {"inpath": d, "FISH_color": "red", "has_centromeric_probe": True}
    with monkeypatch.context() as m:
        m.chdir(work or folders["work"])
        m.delenv("ECSEG_INTERSEG_SHARD", raising=False)
        if shard is not None:
            m.setenv("ECSEG_INTERSEG_SHARD", shard)
        calls = _spy_fan_out(m, tis)
        assert tis.main(config=TConfig(raw={"interseg": cfg}), **kw) == 0
    return _read(os.path.join(d, "interphase_prediction_red.csv")), calls


def test_interseg_fanout(folders, monkeypatch, tmp_path):
    i_tree, c_tree = folders["trees"]
    d = str(tmp_path / "jax")
    shutil.copytree(folders["main"], d)
    with monkeypatch.context() as m:
        m.delenv("ECSEG_INTERSEG_SHARD", raising=False)
        _assert_jax_sharded("ECSEG_INTERSEG_SHARD")
        m.setattr(jis, "load_classifier_models", lambda has_cent, model_dir="interseg_models": (i_tree, c_tree if has_cent else None))
        assert jis.main(config=JConfig(raw={"interseg": {"inpath": d, "FISH_color": "red", "has_centromeric_probe": True}})) == 0
    want = _read(os.path.join(d, "interphase_prediction_red.csv"))
    for tag, (kw, shard, fanned) in RUNS.items():
        got, calls = _interseg_run(folders, monkeypatch, tmp_path, tag, kw, shard)
        assert got == want, tag
        assert calls == ([collections.Counter({0: 1, 1: 1, 2: 1})] if fanned else []), tag


def test_interseg_fanout_replicates_an_imported_keras_model(folders, monkeypatch, tmp_path):
    """ecSeg-i from an ``interseg_models/interseg.h5`` (the imported-Keras
    executor, whose weights are buffers): the mesh run's CSV equals the
    sequential run's, each entry on its own copy of the graph."""
    i_tree, c_tree = folders["trees"]
    work = tmp_path / "work"
    os.makedirs(work / "interseg_models")
    shutil.copy(os.path.join(folders["work"], "interseg_models", "ecseg_c.npz"), work / "interseg_models")
    weights = {name: [(f"{name}/kernel:0", np.asarray(p["kernel"])), (f"{name}/bias:0", np.asarray(p["bias"]))] for name, p in i_tree.items()}
    write_legacy_h5(str(work / "interseg_models" / "interseg.h5"), chip_smoke.ecseg_i_keras_config(), weights)
    copies = []
    real_deepcopy = tis.copy.deepcopy

    def deepcopy(obj, *a):
        copies.append(type(obj))
        return real_deepcopy(obj, *a)

    monkeypatch.setattr(tis.copy, "deepcopy", deepcopy)
    seq, _ = _interseg_run(folders, monkeypatch, tmp_path, "h5_sequential", {"device": "cpu"}, None, work)
    assert copies == []
    mesh, _ = _interseg_run(folders, monkeypatch, tmp_path, "h5_mesh", {"devices": CPU3}, None, work)
    assert mesh == seq
    assert copies.count(KerasModel) == 3


# --------------------------------------------------------------------------
# stat_fish
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1, "auto"])
def test_stat_fish_fanout(workdir, monkeypatch, scale):  # noqa: F811 (the imported fixture)
    monkeypatch.chdir(workdir)
    monkeypatch.delenv("ECSEG_DEVICE_PIPELINE", raising=False)
    monkeypatch.delenv("ECSEG_STAT_FISH_SHARD", raising=False)
    raw = lambda d: {"stat_fish": {"inpath": d, "scale": scale, "use_min_cut": True, "nuclei_size_T": 500}}
    _assert_jax_sharded("ECSEG_STAT_FISH_SHARD")
    jdir = _stat_fish_folder(str(workdir / f"fan_jax_{scale}"))
    assert jsf.main(config=JConfig(raw=raw(jdir))) == 0
    for tag, (kw, shard, fanned) in RUNS.items():
        d = _stat_fish_folder(str(workdir / f"fan_{tag}_{scale}"))
        with monkeypatch.context() as m:
            if shard is not None:
                m.setenv("ECSEG_STAT_FISH_SHARD", shard)
            calls = _spy_fan_out(m, tsf)
            assert tsf.main(config=TConfig(raw=raw(d)), **kw) == 0
        _assert_same_stat_fish(d, jdir, True)
        if not fanned:
            assert calls == [], tag
        elif scale == "auto":  # image 0 alone on entry 0, then the rest from entry 1 on
            assert calls == [collections.Counter({0: 1}), collections.Counter({1: 1, 2: 1})], tag
        else:
            assert calls == [collections.Counter({0: 1, 1: 1, 2: 1})], tag
        rows = open(os.path.join(d, "annotated", "stat_fish_lsq.csv")).read().splitlines()
        names = list(dict.fromkeys(r.split(",")[0] for r in rows[1:]))
        assert names == [os.path.basename(p)[:-4] for p in imgio.get_imgs(d)], tag
