"""``ecseg_torch/runtime/devtime.py`` on the CPU: the profiler pass's
completeness test, its retries and its refusal of a partial sum, held on
fake event lists; the sync counter on a CPU function; and every timer
raising without a card.  ``split`` on the card against ``cuda_ms`` is in
tests/test_torch_cuda.py."""

import types
import warnings
from collections import Counter

import pytest
import torch

from ecseg_torch.runtime import devtime
from ecseg_torch.runtime.study import Study


def event(name, us):
    return types.SimpleNamespace(name=name, device_type=torch.autograd.DeviceType.CUDA,
                                 time_range=types.SimpleNamespace(elapsed_us=lambda: us))


ONE_CALL = [event("ecseg_label_tiles", 30.0), event("ecseg_label_edges", 10.0), event("Memset", 2.0)]


def fake_trace(lost_passes=0, drop="ecseg_label_edges"):
    """A trace of ``calls`` calls that records ONE_CALL per call; its first
    ``lost_passes`` many-call windows lose one record of ``drop``."""
    state = {"lost": lost_passes}

    def trace(fn, calls):
        events = [e for _ in range(calls) for e in ONE_CALL]
        if calls > 1 and state["lost"] > 0:
            state["lost"] -= 1
            events.remove(next(e for e in events if e.name == drop))
        return events
    return trace


def test_complete_counts_every_name():
    one = Counter({"a": 2, "b": 1})
    assert devtime.complete(one, Counter({"a": 10, "b": 5}), 5)
    assert not devtime.complete(one, Counter({"a": 10, "b": 4}), 5)
    assert not devtime.complete(one, Counter({"a": 10, "b": 5, "c": 1}), 5)
    assert not devtime.complete(Counter(), Counter(), 5)  # a pass that recorded nothing


def test_device_events_drop_the_host_and_the_spin_kernel():
    host = types.SimpleNamespace(name="aten::add", device_type=torch.autograd.DeviceType.CPU)
    spin = event("spin_kernel(long)", 1000.0)
    assert devtime.device_events([host, spin, *ONE_CALL]) == ONE_CALL


def test_device_ms_retries_a_pass_that_lost_records():
    log = []
    ms = devtime.device_ms(lambda: None, 4, trace=fake_trace(lost_passes=2), log=lambda *a, **k: log.append(a[0]))
    assert ms == pytest.approx(0.042)
    assert len(log) == 2 and all("incomplete" in line for line in log)


def test_device_ms_raises_rather_than_sum_a_partial_pass():
    with pytest.raises(devtime.IncompleteProfile):
        devtime.device_ms(lambda: None, 4, tries=3, trace=fake_trace(lost_passes=3), log=lambda *a, **k: None)


def test_device_ms_with_a_kernel_and_the_event_mean():
    total, own = devtime.device_ms(lambda: None, 3, kernel="tiles", trace=fake_trace(), log=print)
    assert (total, own) == (pytest.approx(0.042), pytest.approx(0.030))
    with pytest.raises(RuntimeError, match="no kernel named"):
        devtime.device_ms(lambda: None, 3, kernel="count", trace=fake_trace(), log=print)
    log = []
    done = devtime.device_ms(lambda: None, 3, tries=2, kernel="tiles", event_ms=0.1, trace=fake_trace(),
                             log=lambda *a, **k: log.append(a[0]))
    assert done == (pytest.approx(0.042), pytest.approx(0.030)) and len(log) == 3  # two retries, then the last kept


def test_complete_pass_returns_one_call_names():
    ops, per_call, calls = devtime.complete_pass(lambda: None, 5, trace=fake_trace(lost_passes=1), log=lambda *a, **k: None)
    assert per_call == Counter(e.name for e in ONE_CALL) and len(ops) == 15 and calls == 5


def test_complete_pass_caps_the_records_of_a_window(monkeypatch):
    monkeypatch.setattr(devtime, "MAX_RECORDS", 10)
    ops, _, calls = devtime.complete_pass(lambda: None, 50, trace=fake_trace(), log=print)
    assert calls == 3 and len(ops) == 9
    assert devtime.device_ms(lambda: None, 50, trace=fake_trace(), log=print) == pytest.approx(0.042)


def test_count_syncs_counts_the_sync_debug_warnings_and_restores_the_mode():
    modes = ["default"]

    def fn():
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")
        warnings.warn("called a synchronizing CUDA operation")
        return 7

    out, n = devtime.count_syncs(fn, set_mode=modes.append, get_mode=lambda: modes[-1])
    assert (out, n) == (7, 2) and modes == ["default", "warn", "default"]

    def boom():
        warnings.warn("called a synchronizing CUDA operation")
        raise ValueError("x")

    with pytest.raises(ValueError):
        devtime.count_syncs(boom, set_mode=modes.append, get_mode=lambda: modes[-1])
    assert modes[-1] == "default"


@pytest.mark.parametrize("call", [
    lambda: devtime.card(),
    lambda: devtime.cuda_ms(lambda: None, 2),
    lambda: devtime.device_ms(lambda: None, 2),
    lambda: devtime.device_kernels(lambda: None),
    lambda: devtime.split(lambda: None, 2),
    lambda: devtime.wall_ms(lambda: None, 2),
    lambda: Study("x", torch.device("cuda")),
])
def test_timers_raise_without_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_study_on_the_cpu_reports_no_time(capsys):
    study = Study("t", torch.device("cpu"))
    assert study.device_row("a", lambda: torch.arange(3), report=lambda t: {"s": int(t.sum())}).tolist() == [0, 1, 2]
    assert study.host_row("b", lambda: 5, per=2, k=1) == 5
    line = study.emit(extra=1)
    assert line["card"] is None and line["extra"] == 1 and line["launches"] == {}
    assert [(r["name"], r["wall_ms"], r["device_ms"], r.get("s"), r.get("k")) for r in line["rows"]] == [
        ("a", None, None, 3, None), ("b", None, None, None, 1)]
    assert "not measured" in capsys.readouterr().out
