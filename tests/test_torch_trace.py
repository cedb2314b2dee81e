"""The port's stage tracer and the profiler ranges it opens
(``ecseg_torch/runtime/trace.py``), and the names metaseg's single-device
folder path gives them (``pipelines/metaseg.segment_folder``).

Whenever a ``torch.profiler`` records, a stage (tracer on or off) and a
region each open one ``record_function`` range ``stage:<name>``; with no
profiler neither calls ``record_function``.  A region takes no self time
from the stage it is nested in, is never in ``times()`` and never
synchronises.  On the CPU over three small images, ``segment_folder``'s
stage table holds exactly its four stages, and under a profiler the main
thread opens exactly the nine names the benchmark's idle readers sum."""

import contextlib
import os
import threading
import time
import types

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ecseg_torch.models.weights import params_from_numpy
from ecseg_torch.pipelines import metaseg
from ecseg_torch.runtime import trace
from ecseg_torch.runtime.trace import Tracer

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_metaseg_pipeline import _crafted_tiny_params

MAIN = "test.main"  # the range that marks the main thread in a profile

FOLDER_STAGES = ["metaseg.decode_wait", "metaseg.forward", "metaseg.post", "metaseg.stitch"]
FOLDER_RANGES = FOLDER_STAGES + ["metaseg.forward.encoder", "metaseg.forward.decoder", "metaseg.forward.head",
                                 "metaseg.post.device", "metaseg.post.decode"]


def _ranges(prof, main_only=False):
    """The ``stage:`` ranges a profile recorded, as (name without the
    prefix, host thread, start ns, end ns), in order of start; with
    ``main_only`` only those on the thread of the ``MAIN`` range."""
    events = sorted(prof.profiler.kineto_results.events(), key=lambda e: e.start_ns())
    cpu = [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns()) for e in events
           if e.device_type() == torch.autograd.DeviceType.CPU]
    if main_only:
        main = next(r[1] for r in cpu if r[0] == MAIN)
        cpu = [r for r in cpu if r[1] == main]
    return [(r[0][len(trace.PREFIX):],) + r[1:] for r in cpu if r[0].startswith(trace.PREFIX)]


@pytest.mark.parametrize("what", ["stage_traced", "stage_untraced", "region"])
def test_each_stage_and_region_records_one_range_under_a_profiler(what):
    t = Tracer(enabled=what == "stage_traced")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with (t.stage("a") if what.startswith("stage") else trace.region("a")):
            torch.ones(8).cumsum(0)
    assert [r[0] for r in _ranges(prof)] == ["a"]
    assert sorted(t.times()) == (["a"] if what == "stage_traced" else [])


@pytest.mark.parametrize("enabled", [True, False])
def test_without_a_profiler_nothing_calls_record_function(monkeypatch, enabled):
    def refuse(*a, **k):
        raise AssertionError("record_function called with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    t = Tracer(enabled=enabled)
    with t.stage("s"), trace.region("r"):
        pass
    assert sorted(t.times()) == (["s"] if enabled else [])


@pytest.mark.parametrize("profiled", [False, True], ids=["no_profiler", "profiler"])
def test_a_region_in_a_stage_leaves_its_self_time_whole_and_never_syncs(monkeypatch, profiled):
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    # a stage waits for the calling thread's current stream alone
    stream = types.SimpleNamespace(synchronize=lambda: syncs.append(threading.get_ident()))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("a stage synchronised the whole card"))
    t = Tracer(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
        with trace.region("alone"):
            time.sleep(0.01)
        assert syncs == []
        with t.stage("s"):
            time.sleep(0.01)
            with trace.region("r"):
                time.sleep(0.02)
    assert len(syncs) == 1  # the stage's own, at its end
    assert list(t.times()) == ["s"] and len(t.times()["s"]) == 1
    assert 0.03 <= t.times()["s"][0] < 0.2


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Three small DAPI images, written by cv2, with the ``dapi/`` folder
    ``segment_folder`` writes beside them."""
    d = tmp_path_factory.mktemp("trace_folder")
    os.makedirs(d / "dapi")
    rng = np.random.default_rng(3)
    paths = []
    for k in range(3):
        img = (rng.random((300, 300)) * 60).astype(np.uint8)
        img[60:140, 80:170] = 200
        img[220:224, 40 + 20 * k : 44 + 20 * k] = 230
        path = str(d / f"im{k}.tif")
        cv2.imwrite(path, img)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def model():
    return params_from_numpy(_crafted_tiny_params()).eval()


def test_segment_folder_times_its_four_stages(monkeypatch, folder, model):
    t = Tracer(enabled=True)
    monkeypatch.setattr(trace, "_tracer", t)
    out = list(metaseg.segment_folder(model, folder))
    assert [p for p, _, _ in out] == folder
    times = t.times()
    assert sorted(times) == FOLDER_STAGES
    assert len(times["metaseg.decode_wait"]) == len(folder) + 1  # each image, and the end of the folder


@pytest.mark.parametrize("enabled", [True, False], ids=["traced", "untraced"])
def test_segment_folder_opens_the_nine_names_on_the_main_thread(monkeypatch, folder, model, enabled):
    monkeypatch.setattr(trace, "_tracer", Tracer(enabled=enabled))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(MAIN):
            out = list(metaseg.segment_folder(model, folder))
    assert len(out) == len(folder)
    main = _ranges(prof, main_only=True)
    names = [r[0] for r in main]
    assert sorted(set(names)) == sorted(FOLDER_RANGES)
    assert names.count("metaseg.forward.encoder") == names.count("metaseg.forward.head") == len(folder)
    assert names.count("metaseg.post.device") == names.count("metaseg.post.decode") == names.count("metaseg.post")
    # each region lies inside a run of the stage it names a part of
    for name, _, a, b in main:
        parent = name.rsplit(".", 1)[0]
        if parent in ("metaseg.forward", "metaseg.post"):
            assert any(p == parent and pa <= a and b <= pb for p, _, pa, pb in main), name
