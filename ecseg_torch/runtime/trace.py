"""Opt-in per-stage wall-time tracing (twin of ``ecseg_tpu/runtime/trace.py``).

``ECSEG_TRACE=1`` makes the pipelines print a per-stage table (count /
total / mean / max) at exit.  Stages do not nest: each records its own
elapsed wall time.  CUDA work is asynchronous, so while tracing is on a
stage synchronises the card when it ends and its time includes the device
work it enqueued.  When tracing is off ``stage()`` costs one attribute test.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch


class Tracer:
    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get("ECSEG_TRACE", "") not in ("", "0")
        self.enabled = enabled
        self._times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._times[name].append(time.perf_counter() - t0)

    def times(self) -> Dict[str, List[float]]:
        """stage -> the seconds of each of its runs."""
        return {k: list(v) for k, v in self._times.items()}

    def report(self, out=None) -> str:
        if not self._times:
            return ""
        lines = [
            f"{'stage':34s} {'n':>5s} {'total_s':>9s} {'mean_ms':>9s} {'max_ms':>9s}"
        ]
        for name, ts in sorted(self._times.items(), key=lambda kv: -sum(kv[1])):
            lines.append(
                f"{name:34s} {len(ts):5d} {sum(ts):9.3f} "
                f"{1e3 * sum(ts) / len(ts):9.2f} {1e3 * max(ts):9.2f}"
            )
        text = "\n".join(lines)
        print("\n[ecseg trace]\n" + text, file=out)
        return text

    def reset(self):
        self._times.clear()


_tracer: Optional[Tracer] = None


def tracer() -> Tracer:
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
        if _tracer.enabled:
            atexit.register(_tracer.report)
    return _tracer


def stage(name: str):
    """``with trace.stage("metaseg.forward"): ...``"""
    return tracer().stage(name)
