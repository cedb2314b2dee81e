"""The switches the JAX package reads, read by the port too, with the same
parsing: the stage tracer's self-time accounting and ``ECSEG_TRACE_DIR``
(``runtime/trace.py``) against ``ecseg_tpu/runtime/trace.py`` and
tests/test_trace.py's cases; ``ECSEG_STAT_FISH_TAIL_WORKERS`` (stat_fish's
CSV and ``.npy`` bytes equal to the JAX run at the same value);
``ECSEG_NO_NATIVE`` (the Python twins of the min-cut partition and the
watershed, equal to the C++).  ``ECSEG_TIF_LZW`` is in
tests/test_torch_tiff.py."""

import glob
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax

from ecseg_tpu.core.config import Config as JConfig
from ecseg_tpu.models.keras_import import save_npz_pytree
from ecseg_tpu.pipelines import stat_fish as jsf
from ecseg_tpu.runtime.trace import Tracer as JaxTracer
from ecseg_torch.core import imgio
from ecseg_torch.core.config import Config as TConfig
from ecseg_torch.core.config import load_stat_fish_params
from ecseg_torch.ops import maxflow as tmx
from ecseg_torch.ops import watershed as tws
from ecseg_torch.pipelines import stat_fish as tsf
from ecseg_torch.runtime.trace import Tracer

from _nusetutil import crafted_nuset_model
from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

REPO = pathlib.Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------------------
# the stage tracer
# ---------------------------------------------------------------------------


def test_disabled_tracer_is_noop():
    t = Tracer(enabled=False)
    with t.stage("x"):
        pass
    assert t.report() == "" and t.times() == {}


def test_stage_timing_and_report():
    t = Tracer(enabled=True)
    for _ in range(3):
        with t.stage("fast"):
            pass
    with t.stage("slow"):
        time.sleep(0.01)
    text = t.report()
    lines = text.splitlines()
    assert lines[1].startswith("slow")  # sorted by total time, slow first
    assert " 3 " in [ln for ln in lines if ln.startswith("fast")][0]
    t.reset()
    assert t.report() == ""


def _schedule(t):
    """Nested stages: self times outer 40 ms, inner 50 ms (two runs),
    leaf 20 ms; 110 ms of wall."""
    with t.stage("outer"):
        time.sleep(0.03)
        with t.stage("inner"):
            time.sleep(0.03)
            with t.stage("leaf"):
                time.sleep(0.02)
        time.sleep(0.01)
    with t.stage("inner"):
        time.sleep(0.02)


def test_nested_stages_record_self_time_as_the_jax_tracer():
    port, ref = Tracer(enabled=True), JaxTracer(enabled=True)
    t0 = time.perf_counter()
    _schedule(port)
    wall = time.perf_counter() - t0
    _schedule(ref)
    got = port.times()
    want = {k: list(v) for k, v in ref._times.items()}
    assert sorted(got) == sorted(want) == ["inner", "leaf", "outer"]
    assert [len(got[k]) for k in sorted(got)] == [len(want[k]) for k in sorted(want)] == [2, 1, 1]
    for name, expect in (("outer", 0.04), ("inner", 0.05), ("leaf", 0.02)):
        assert abs(sum(got[name]) - sum(want[name])) < 0.02, name
        assert expect - 0.001 <= sum(got[name]) < expect + 0.02, (name, got[name])
    assert abs(sum(map(sum, got.values())) - wall) < 0.02  # the columns sum to the wall


def test_a_second_threads_stages_are_kept_apart():
    """A worker's stage that runs while the main thread's stage is open
    takes nothing from it: nesting is per thread."""
    for t in (Tracer(enabled=True), JaxTracer(enabled=True)):
        with t.stage("main"):
            done = threading.Event()

            def work():
                with t.stage("worker"):
                    time.sleep(0.05)
                done.set()

            worker = threading.Thread(target=work)
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive() and done.is_set()
        times = t._times
        assert len(times["main"]) == len(times["worker"]) == 1
        assert times["main"][0] >= 0.045 and 0.045 <= times["worker"][0] < 0.07


def _traced_run(tmp_path, env):
    """A process that opens two nested stages around a torch op, with
    ``env``; returns the files under ``tmp_path/traces``."""
    code = (
        "import torch\n"
        "from ecseg_torch.runtime import trace\n"
        "with trace.stage('outer'):\n"
        "    with trace.stage('inner'):\n"
        "        torch.ones(64).cumsum(0)\n"
    )
    base = {k: v for k, v in os.environ.items() if k not in ("ECSEG_TRACE", "ECSEG_TRACE_DIR")}
    base["PYTHONPATH"] = os.pathsep.join([str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], env=dict(base, **env), capture_output=True, text=True, check=True, timeout=300)
    return out.stdout, sorted(glob.glob(str(tmp_path / "traces" / "**"), recursive=True))[1:]


def test_trace_dir_writes_one_chrome_trace(tmp_path):
    stdout, files = _traced_run(tmp_path, {"ECSEG_TRACE": "1", "ECSEG_TRACE_DIR": str(tmp_path / "traces")})
    assert "[ecseg trace]" in stdout and "outer" in stdout and "inner" in stdout
    assert len(files) == 1 and os.path.basename(files[0]).startswith("ecseg_trace_") and files[0].endswith(".json")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)  # a CPU op of the traced run
    # the program's own ranges, one a stage run
    assert sorted(e["name"] for e in events if e.get("name", "").startswith("stage:")) == ["stage:inner", "stage:outer"]


def test_trace_dir_without_trace_writes_nothing(tmp_path):
    stdout, files = _traced_run(tmp_path, {"ECSEG_TRACE_DIR": str(tmp_path / "traces")})
    assert "[ecseg trace]" not in stdout
    assert files == [] and not (tmp_path / "traces").exists()


# ---------------------------------------------------------------------------
# ECSEG_STAT_FISH_TAIL_WORKERS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nuset_dir(tmp_path_factory):
    """A working directory holding ``models/nuset.npz`` (the crafted NuSeT
    tree) that both packages' stat_fish load."""
    d = tmp_path_factory.mktemp("tail_workers")
    m = crafted_nuset_model()
    os.makedirs(d / "models")
    save_npz_pytree(str(d / "models" / "nuset.npz"), jax.tree.map(np.asarray, {"whole": m.unet_whole, "fg": {"unet": m.unet_fg, "rpn": m.rpn_fg}}))
    return d


def _fish_folder(d, n=4):
    """``n`` BGR images of two nuclei with a green and a red focus each
    (tests/test_stat_fish_e2e.py's tail-pool folder)."""
    os.makedirs(d)
    yy, xx = np.mgrid[:160, :160]
    for k in range(n):
        img = np.zeros((160, 160, 3), np.uint8)
        img[..., 0] = 20
        for c, (y, x) in enumerate([(50, 50), (110, 110)]):
            img[..., 0][(yy - y) ** 2 + (xx - x) ** 2 <= (25 + 3 * k + 4 * c) ** 2] = 220
            img[y - 1 : y + 2, x - 1 : x + 2, 1] = 220
            img[y + 6 : y + 9, x + 6 : x + 9, 2] = 220
        imgio.imwrite(os.path.join(d, f"im{k}.tif"), img)
    return d


def _csv_and_npy(d):
    ann = os.path.join(d, "annotated")
    return {os.path.relpath(p, ann): open(p, "rb").read() for p in glob.glob(os.path.join(ann, "**"), recursive=True)
            if p.endswith((".csv", ".npy"))}


@pytest.mark.parametrize("workers", ["", "0", "1", "3"])
def test_tail_workers_outputs_equal_jax(nuset_dir, monkeypatch, workers):
    monkeypatch.chdir(nuset_dir)
    monkeypatch.setenv("ECSEG_STAT_FISH_SHARD", "0")
    monkeypatch.setenv("ECSEG_STAT_FISH_TAIL_WORKERS", workers)
    monkeypatch.delenv("ECSEG_DEVICE_PIPELINE", raising=False)
    assert tsf.tail_workers() == max(1, int(workers or 2))  # the JAX package's expression
    raw = lambda d: {"stat_fish": {"inpath": d, "scale": "auto", "use_min_cut": True, "nuclei_size_T": 400}}
    jdir, tdir = (_fish_folder(str(nuset_dir / f"{side}_{workers or 'unset'}")) for side in ("jax", "port"))
    assert jsf.main(config=JConfig(raw=raw(jdir))) == 0
    assert tsf.main(config=TConfig(raw=raw(tdir)), device="cpu") == 0
    got, want = _csv_and_npy(tdir), _csv_and_npy(jdir)
    assert sorted(got) == sorted(want) and len(got) == 5
    assert got == want


def test_tail_workers_junk_raises_as_jax(nuset_dir, monkeypatch):
    monkeypatch.chdir(nuset_dir)
    monkeypatch.setenv("ECSEG_STAT_FISH_SHARD", "0")
    monkeypatch.setenv("ECSEG_STAT_FISH_TAIL_WORKERS", "two")
    raw = lambda d: {"stat_fish": {"inpath": d, "scale": 1, "use_min_cut": True, "nuclei_size_T": 400}}
    for main, cfg, kw, side in ((jsf.main, JConfig, {}, "jax"), (tsf.main, TConfig, {"device": "cpu"}, "port")):
        with pytest.raises(ValueError):
            main(config=cfg(raw=raw(_fish_folder(str(nuset_dir / f"junk_{side}"), n=1))), **kw)


# ---------------------------------------------------------------------------
# ECSEG_NO_NATIVE
# ---------------------------------------------------------------------------


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def _touching_nuclei():
    """A mask of small discs and joined pairs of large ones: the pairs are
    over the median-area gate, so the min-cut splits them."""
    yy, xx = np.mgrid[:240, :240]
    mask = np.zeros((240, 240), np.uint8)
    for cy, cx, r in [(30, 30, 12), (30, 200, 12), (200, 30, 12), (210, 200, 11), (120, 200, 12)]:
        mask[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 1
    for cy, cx in [(70, 60), (160, 110)]:
        for dx in (0, 34):
            mask[(yy - cy) ** 2 + (xx - cx - dx) ** 2 <= 20**2] = 1
    return mask


@pytest.mark.parametrize("value", ["1", "0"])  # any non-empty value, as the JAX package tests it
def test_no_native_min_cut_runs_the_python_twin(monkeypatch, value):
    params = load_stat_fish_params()
    mask = _touching_nuclei()
    calls = _counting(monkeypatch, tmx, "partition_py")
    monkeypatch.delenv("ECSEG_NO_NATIVE", raising=False)
    native = tmx.binary_seg_to_instance_min_cut(mask, params.flow_limit, params.cell_size_threshold_coeff)
    assert calls == []
    monkeypatch.setenv("ECSEG_NO_NATIVE", value)
    twin = tmx.binary_seg_to_instance_min_cut(mask, params.flow_limit, params.cell_size_threshold_coeff)
    assert len(calls) >= 2  # one partition a joined pair
    for a, b in zip(native, twin):
        np.testing.assert_array_equal(a, b)
    assert native[0].max() == 9  # five discs and two pairs split in two


@pytest.mark.parametrize("line", [False, True])
def test_no_native_watershed_runs_the_python_twin(monkeypatch, line):
    rng = np.random.default_rng(3)
    image = rng.random((40, 50))
    markers = np.zeros((40, 50), np.int64)
    markers[5, 5], markers[30, 40], markers[5, 45], markers[35, 3] = 1, 2, 3, 4
    mask = rng.random((40, 50)) > 0.1
    calls = _counting(monkeypatch, tws, "watershed_py")
    monkeypatch.delenv("ECSEG_NO_NATIVE", raising=False)
    native = tws.watershed(image, markers, mask, watershed_line=line)
    assert calls == []
    monkeypatch.setenv("ECSEG_NO_NATIVE", "1")
    twin = tws.watershed(image, markers, mask, watershed_line=line)
    assert len(calls) == 1
    np.testing.assert_array_equal(native, twin)
    assert native.max() > 0 and (line or set(np.unique(native)) >= {1, 2, 3, 4})
