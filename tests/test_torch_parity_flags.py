"""Shared state that the port's fan-out threads touch: ``parity_flags``
(cuDNN's process-wide flags, ``models/layers.py``) and the kernel launch
counters (``ops/cc_kernels.count_launch``).

``torch.backends.cudnn.flags`` saves the flags on entry and restores them
on exit, so with two overlapping threads the first to leave restored the
caller's flags (TF32 on) while the other was still inside.  The holder
count keeps the parity values while any holder is inside and restores the
caller's when the last one leaves.  These run on the CPU build: the cuDNN
flags are plain process state there too."""

import sys
import threading

import pytest
import torch

from ecseg_torch.models.layers import parity_flags
from ecseg_torch.ops import cc_kernels as K

from _torchutil import single_torch_thread  # noqa: F401 (autouse fixture)

CALLER = dict(enabled=True, benchmark=False, deterministic=False, allow_tf32=True)
PARITY = {"enabled": True, "benchmark": False, "deterministic": True, "allow_tf32": False}
JOIN_S = 60


def _flags():
    c = torch.backends.cudnn
    return {"enabled": c.enabled, "benchmark": c.benchmark, "deterministic": c.deterministic, "allow_tf32": c.allow_tf32}


def _join(threads):
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a thread did not finish"


def test_overlapping_holders_keep_the_parity_flags_until_the_last_leaves():
    """A enters, B enters, A leaves: B still reads the parity flags; after B
    leaves the caller's flags are back."""
    seen = {}
    a_in, b_in, a_out, b_go = (threading.Event() for _ in range(4))

    def a():
        with parity_flags():
            a_in.set()
            assert b_in.wait(JOIN_S)
        a_out.set()

    def b():
        assert a_in.wait(JOIN_S)
        with parity_flags():
            b_in.set()
            assert a_out.wait(JOIN_S)
            seen["b after a left"] = _flags()
            assert b_go.wait(JOIN_S)
        seen["b left"] = True

    with torch.backends.cudnn.flags(**CALLER):
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        assert a_out.wait(JOIN_S)
        seen["main while b inside"] = _flags()
        b_go.set()
        _join(threads)
        seen["after both"] = _flags()
    assert seen["b after a left"] == PARITY
    assert seen["main while b inside"] == PARITY
    assert seen["after both"] == CALLER


def test_nested_and_raising_holders_restore_the_callers_flags():
    with torch.backends.cudnn.flags(**CALLER):
        with parity_flags():
            with parity_flags():
                assert _flags() == PARITY
            assert _flags() == PARITY
        assert _flags() == CALLER
        with pytest.raises(ValueError):
            with parity_flags():
                raise ValueError("inside")
        assert _flags() == CALLER


def test_many_threads_entering_and_leaving_see_the_parity_flags_inside():
    """More threads than cores, a short switch interval: every holder reads
    the parity flags inside, and the caller's come back at the end."""
    bad = []

    def worker():
        for _ in range(300):
            with parity_flags():
                if _flags() != PARITY:
                    bad.append(_flags())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.backends.cudnn.flags(**CALLER):
            threads = [threading.Thread(target=worker) for _ in range(16)]
            for t in threads:
                t.start()
            _join(threads)
            after = _flags()
    finally:
        sys.setswitchinterval(interval)
    assert not bad, bad[:3]
    assert after == CALLER


def test_launch_counter_loses_no_increment_across_threads():
    """8 threads add to one counter at a short switch interval; every
    increment lands.  ``reset_launches`` zeroes every key."""
    n, per = 8, 5000
    K.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [K.count_launch("label") for _ in range(per)]) for _ in range(n)]
        for t in threads:
            t.start()
        _join(threads)
    finally:
        sys.setswitchinterval(interval)
    assert K.LAUNCHES["label"] == n * per
    assert sum(K.LAUNCHES.values()) == n * per
    K.reset_launches()
    assert not any(K.LAUNCHES.values())
