"""Host allocator tuning for the numpy post-processing stages (twin of
``ecseg_tpu/runtime/hostmem.py``).

glibc's malloc serves every allocation above ``M_MMAP_THRESHOLD`` from a
fresh ``mmap``, so each large numpy temporary (label images, masks,
bincounts over 2048x2048 canvases) pays the kernel's first-touch page
faults again.  Raising the threshold keeps big buffers on the heap, where
pages are faulted once and then reused across numpy allocations; turning
heap trimming off keeps freed top-of-heap blocks faulted.  The trade-off
(the heap's high-water mark is not returned to the OS) suits batch
pipelines that allocate same-shaped images in a loop.

Every pipeline ``main`` (metaseg, meta_overlay, stat_fish, interseg,
fish_distance), ``ecseg_torch.bench``, ``bench_stat_fish``, the six studies
and ``compare_archs`` call :func:`tune_host_allocator` once at startup, as
the JAX package's do.

``python -m ecseg_torch.runtime.hostmem`` measures what the tune is worth
on this host: in a fresh process each, untuned and tuned, the first and
second fill of a fresh 128 MB buffer, ``np.bincount`` over a fresh 16 MB
zeros array and, with a card, the pageable copy of a 2048x2048 int64
canvas to the host (a fresh host buffer each); one JSON line each.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import subprocess
import sys
import time

import numpy as np

# glibc malloc.h
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3

_done = False


def tune_host_allocator(threshold_bytes: int = 1 << 30) -> bool:
    """Raise glibc's mmap threshold to ``threshold_bytes`` and turn heap
    trimming off.  Idempotent; returns True when the tune took effect
    (glibc present and ``mallopt`` accepted both values), False otherwise,
    having changed nothing (no glibc)."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, ctypes.c_int(threshold_bytes)))
        ok = bool(libc.mallopt(M_TRIM_THRESHOLD, ctypes.c_int(2**31 - 1))) and ok
    except (OSError, AttributeError):
        return False
    _done = ok
    return ok


FILL_BYTES = 128 << 20
BINCOUNT_BYTES = 16 << 20
BINCOUNT_REPS = 5


def _probe(tuned: bool) -> dict:
    """One process's measurement: ms of the first and second fill of a
    fresh ``FILL_BYTES`` buffer (freed after), then the median ms of
    ``np.bincount`` over ``BINCOUNT_REPS`` fresh ``BINCOUNT_BYTES`` int64
    zeros arrays."""
    took = tune_host_allocator() if tuned else False
    buf = np.empty(FILL_BYTES, np.uint8)
    fills = []
    for value in (1, 2):
        t0 = time.perf_counter()
        buf.fill(value)
        fills.append(1e3 * (time.perf_counter() - t0))
    del buf
    counts = []
    for _ in range(BINCOUNT_REPS):
        t0 = time.perf_counter()
        np.bincount(np.zeros(BINCOUNT_BYTES // 8, np.int64))
        counts.append(1e3 * (time.perf_counter() - t0))
    out = {"tuned": tuned, "tune_took_effect": took, "fill_mb": FILL_BYTES >> 20, "first_fill_ms": fills[0],
           "second_fill_ms": fills[1], "bincount_mb": BINCOUNT_BYTES >> 20, "bincount_ms": counts,
           "bincount_median_ms": float(np.median(counts))}
    import torch  # after the host measurements, whose fresh heap it would fill

    if torch.cuda.is_available():
        canvas = torch.zeros((2048, 2048), dtype=torch.int64, device="cuda")
        copies = []
        for _ in range(BINCOUNT_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            canvas.cpu()
            copies.append(1e3 * (time.perf_counter() - t0))
        out.update(card=torch.cuda.get_device_name(0), int64_canvas_copy_ms=copies,
                   int64_canvas_copy_median_ms=float(np.median(copies)))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:
        print(json.dumps(_probe(argv[1] == "tuned")), flush=True)
        return 0
    for mode in ("untuned", "tuned"):
        out = subprocess.run([sys.executable, "-m", "ecseg_torch.runtime.hostmem", "--child", mode],
                             capture_output=True, text=True, check=True)
        print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
