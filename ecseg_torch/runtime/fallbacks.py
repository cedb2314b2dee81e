"""Device -> host fallback counters (twin of ``ecseg_tpu/runtime/fallbacks.py``).

A device meta_inference whose ``ok`` is False is redone on the host oracle;
the bytes are identical either way, but a run where every image quietly
falls back is a performance regression.  Each such event is counted here
and the pipeline prints one summary line at the end (``fallbacks: none`` is
the healthy signal).  Process-global and thread-safe.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict

_lock = threading.Lock()
_counts: Counter = Counter()

META_POST_OK = "meta_post_ok_false"  # device meta_inference said redo-on-host


def record(kind: str, n: int = 1) -> None:
    with _lock:
        _counts[kind] += n


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset() -> None:
    with _lock:
        _counts.clear()


def summary() -> str:
    c = counts()
    if not c:
        return "fallbacks: none"
    return "fallbacks: " + " ".join(f"{k}={v}" for k, v in sorted(c.items()))


def report(out=None) -> str:
    line = "[ecseg] " + summary()
    print(line, file=out, flush=True)
    return line
