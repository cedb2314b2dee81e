"""Device -> host fallback counters (twin of ``ecseg_tpu/runtime/fallbacks.py``).

A device meta_inference whose ``ok`` is False is redone on the host oracle,
and a NuSeT watershed whose certificate is not clean is recomputed by the
host priority flood; the bytes are identical either way, but a run where
every image quietly falls back is a performance regression.  Each such
event is counted here, as are the order-dependent contour pixels that
``ECSEG_FAST_WATERSHED=check`` finds and the metaseg and NuSeT forwards' 3x3
convs that the hand-written kernel refused, and the pipeline prints one summary
line at the end (``fallbacks: none`` is the healthy signal).  Process-global and thread-safe.
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Dict

_lock = threading.Lock()
_counts: Counter = Counter()

META_POST_OK = "meta_post_ok_false"  # device meta_inference said redo-on-host
WATERSHED_UNCERTAIN_PX = "fast_watershed_uncertain_px"  # the uncertain pixels of such watersheds
WATERSHED_HOST_RECOMPUTE = "fast_watershed_host_recompute"  # watersheds recomputed on the host
WATERSHED_TIE_PX = "fast_watershed_tie_px"  # ECSEG_FAST_WATERSHED=check: contour pixels that flip under permuted ids
WATERSHED_TIE_IMAGES = "fast_watershed_tie_images"  # ... and the watersheds that had any
CONV3X3_CUDNN = "conv3x3_cudnn"  # float32 no-grad 3x3 convs of the metaseg and NuSeT forwards on the card left to cuDNN (a shape ops/conv3x3 refuses)


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
