"""The port's host allocator tune (ecseg_torch/runtime/hostmem.py, twin of
ecseg_tpu/runtime/hostmem.py) and its call at the start of every entry point
the JAX package tunes: the five pipeline ``main``s (before they read their
configuration), the two benches, the six studies and ``compare_archs``."""

import importlib

import numpy as np
import pytest

from ecseg_torch.runtime import hostmem

PIPELINES = ("metaseg", "meta_overlay", "stat_fish", "interseg", "fish_distance")
ENTRY_POINTS = ("bench", "bench_stat_fish", "profile_meta_post", "profile_metaseg_2048", "profile_layers",
                "profile_nuclei_segment", "profile_fast_watershed", "quantify_watershed_divergence", "compare_archs")


def test_tune_takes_effect_on_glibc_and_is_idempotent():
    assert hostmem.tune_host_allocator() is True
    assert hostmem.tune_host_allocator() is True


def test_large_allocations_work_after_the_tune():
    assert hostmem.tune_host_allocator()
    for _ in range(3):
        a = np.ones(64 << 20, np.uint8)
        b = np.bincount(np.zeros(2 << 20, np.int64))
        assert int(a.sum()) == 64 << 20 and b.tolist() == [2 << 20]
        del a, b


def test_no_glibc_changes_nothing(monkeypatch):
    def no_libc(*a, **k):
        raise OSError("no libc here")

    monkeypatch.setattr(hostmem, "_done", False)
    monkeypatch.setattr(hostmem.ctypes, "CDLL", no_libc)
    assert hostmem.tune_host_allocator() is False
    assert hostmem._done is False


class _ConfigRead(BaseException):
    """Raised at a main's first read of its configuration (a BaseException:
    interseg's main turns an ``Exception`` from its section into exit 2)."""


class _RecordingConfig:
    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        self._log.append("config")
        raise _ConfigRead(name)


@pytest.mark.parametrize("name", PIPELINES)
def test_pipeline_main_tunes_once_before_reading_its_config(monkeypatch, name):
    module = importlib.import_module(f"ecseg_torch.pipelines.{name}")
    log = []
    monkeypatch.setattr(module, "tune_host_allocator", lambda: log.append("tune") or True)
    kwargs = {} if name == "fish_distance" else {"device": "cpu"}
    with pytest.raises(_ConfigRead):
        module.main(config=_RecordingConfig(log), **kwargs)
    assert log == ["tune", "config"]


class _Tuned(BaseException):
    pass


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_tunes_at_startup(monkeypatch, name):
    """Each bench, study and ``compare_archs`` calls the tune at its start
    (the spy stops the entry point there)."""
    module = importlib.import_module(f"ecseg_torch.{name}")
    calls = []

    def spy():
        calls.append(name)
        raise _Tuned

    monkeypatch.setattr(module, "tune_host_allocator", spy)
    with pytest.raises(_Tuned):
        module.main([], device="cpu")
    assert calls == [name]
