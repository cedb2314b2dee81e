"""Opt-in per-stage wall-time tracing (twin of ``ecseg_tpu/runtime/trace.py``).

``ECSEG_TRACE=1`` makes the pipelines print a per-stage table (count /
total / mean / max) at exit.  Stages nest freely, and time is attributed to
the innermost stage: a stage records its self time, its elapsed wall time
less that of the stages nested inside it on the same thread, so the
report's columns sum to real wall time.  CUDA work is asynchronous, so
while tracing is on a stage synchronises the calling thread's current
CUDA stream when it ends and its time includes the device work it
enqueued there.  When tracing is off and no
profiler records, ``stage()`` costs two flag tests.

Stages may run on several threads at once (stat_fish's tail pool, the
fan-outs over a device list): each thread keeps its own nesting stack, so
one thread's stages never take time from another's.  A stage synchronises
the calling thread's current stream on its current CUDA device, so a
fan-out worker sets its device (``torch.cuda.set_device``) before its
first stage, and each of its stages waits for its own card; a thread on a
stream of its own (stat_fish's watershed worker) waits for that stream
alone, not for another thread's work on the default one.

With ``ECSEG_TRACE_DIR=<dir>`` as well, a ``torch.profiler`` capture (CPU
activity, and CUDA activity when a card is present) runs from the first
use of :func:`tracer` to the exit of the process and is written to
``<dir>/ecseg_trace_<pid>.json`` as a Chrome trace (the directory is made
if missing; the pid keeps concurrent processes apart).  Without
``ECSEG_TRACE`` the directory does nothing.

Whenever a ``torch.profiler`` records (that capture, or any other in the
process), each stage also opens a ``record_function`` range named
``stage:<name>`` around its body, whether or not ``ECSEG_TRACE`` is set,
and :func:`region` opens such a range alone: a part of a stage (the
forward's encoder, the post's device half) that is named in a device
trace but takes no self time, makes no sync and is never in
:meth:`Tracer.times`.  One prefix marks every range the program opens, so
that a reader of the trace tells the program's ranges from its device
operations (the trace copies each range onto the device's line as well)
and gives a device's idle gap to the innermost range open on the host.
When no profiler records, a region costs one flag test.

:func:`counters` hands a module a named dict of counts (``nuset_infer.COUNTS``)
that the exit report prints after the stage table, when tracing is on.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "stage:"  # of every profiler range the program opens
_NO_RANGE = contextlib.nullcontext()
_COUNTERS: Dict[str, Dict[str, int]] = {}


def counters(owner: str) -> Dict[str, int]:
    """The named dict of counts that the exit report prints as
    ``<owner> counts: key=value ...`` (made empty on first use); the owner
    keeps its keys and adds to them."""
    return _COUNTERS.setdefault(owner, {})


def region(name: str):
    """``with trace.region("metaseg.forward.encoder"): ...``: a profiler
    range ``stage:<name>`` while a profiler records, else nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _NO_RANGE


class Tracer:
    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("ECSEG_TRACE", "") not in ("", "0")
        self.enabled = enabled
        self._times: Dict[str, List[float]] = defaultdict(list)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._profile_dir = os.environ.get("ECSEG_TRACE_DIR") or None
        self._profile = None

    def _stack(self) -> List[float]:
        """This thread's nesting stack: the seconds of the children of each
        open stage, under a root entry."""
        st = getattr(self._local, "child_time", None)
        if st is None:
            st = self._local.child_time = [0.0]
        return st

    @contextlib.contextmanager
    def stage(self, name: str):
        with region(name):
            if not self.enabled:
                yield
                return
            stack = self._stack()
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if torch.cuda.is_initialized():
                    torch.cuda.current_stream().synchronize()
                elapsed = time.perf_counter() - t0
                inner = stack.pop()
                stack[-1] += elapsed
                with self._lock:
                    self._times[name].append(elapsed - inner)

    def times(self) -> Dict[str, List[float]]:
        """stage -> the self seconds of each of its runs."""
        with self._lock:
            return {k: list(v) for k, v in self._times.items()}

    def report(self, out=None) -> str:
        times = self.times()
        if not times:
            return ""
        lines = [
            f"{'stage':34s} {'n':>5s} {'total_s':>9s} {'mean_ms':>9s} {'max_ms':>9s}"
        ]
        for name, ts in sorted(times.items(), key=lambda kv: -sum(kv[1])):
            lines.append(
                f"{name:34s} {len(ts):5d} {sum(ts):9.3f} "
                f"{1e3 * sum(ts) / len(ts):9.2f} {1e3 * max(ts):9.2f}"
            )
        for owner, counts in sorted(_COUNTERS.items()):
            if any(counts.values()):
                lines.append(f"{owner} counts: " + " ".join(f"{k}={v}" for k, v in counts.items()))
        text = "\n".join(lines)
        print("\n[ecseg trace]\n" + text, file=out)
        return text

    def reset(self):
        with self._lock:
            self._times.clear()

    def start_device_profile(self) -> None:
        """Start the ``ECSEG_TRACE_DIR`` capture (once; nothing without the
        variable)."""
        if self._profile_dir is None or self._profile is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._profile = profile(activities=activities)
        self._profile.start()

    def stop_device_profile(self) -> Optional[str]:
        """Stop the capture and write its Chrome trace; returns the file's
        path (None when nothing was captured)."""
        if self._profile is None:
            return None
        prof, self._profile = self._profile, None
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        path = os.path.join(self._profile_dir, f"ecseg_trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        return path


_tracer: Optional[Tracer] = None


def tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
        if _tracer.enabled:
            _tracer.start_device_profile()
            atexit.register(_tracer.stop_device_profile)  # runs after the report
            atexit.register(_tracer.report)
    return _tracer


def stage(name: str):
    """``with trace.stage("metaseg.forward"): ...``"""
    return tracer().stage(name)
