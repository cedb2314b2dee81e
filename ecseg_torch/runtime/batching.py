"""Prefetching map for folder-batch inference (twin of
``ecseg_tpu/runtime/batching.py``): reader threads decode and patchify the
next images while the main thread drives the card; and the fan-out of a
folder's images over a device list, one worker thread per entry (the JAX
package's ``jax.default_device`` fan-outs)."""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterable, Iterator, Sequence, Tuple, TypeVar

import torch

from ..device import pin_thread

T = TypeVar("T")
U = TypeVar("U")


def prefetch_map(
    fn: Callable[[T], U],
    items: Iterable[T],
    prefetch: int = 2,
    max_workers: int = 2,
) -> Iterator[Tuple[T, U]]:
    """Map ``fn`` over ``items`` on a thread pool, yielding in order while
    keeping up to ``prefetch`` results in flight."""
    items = list(items)
    if not items:
        return
    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {}
        n = len(items)
        for k in range(min(prefetch, n)):
            futures[k] = pool.submit(fn, items[k])
        next_submit = min(prefetch, n)
        for i in range(n):
            result = futures.pop(i).result()
            if next_submit < n:
                futures[next_submit] = pool.submit(fn, items[next_submit])
                next_submit += 1
            yield items[i], result


def fan_out(
    fn: Callable[[T, int], U],
    items: Iterable[T],
    devices: Sequence[torch.device],
    start: int = 0,
    per_device: int = 2,
) -> Iterator[U]:
    """``fn(item, entry)`` for each of ``items``, the k-th on entry
    ``(start + k) % n`` of ``devices``, on a pool of one thread per entry;
    each call first makes its entry's device the thread's current one
    (``device.pin_thread``).  Yields the results in input order, with at
    most ``per_device`` items in flight an entry (the oldest drained first,
    which bounds host memory).  An error in a call is raised when its
    result is reached; nothing falls back."""
    n = len(devices)

    def run(item, entry):
        pin_thread(devices[entry])
        return fn(item, entry)

    with cf.ThreadPoolExecutor(max_workers=n) as pool:
        inflight = []
        for k, item in enumerate(items):
            while len(inflight) >= per_device * n:
                yield inflight.pop(0).result()
            inflight.append(pool.submit(run, item, (start + k) % n))
        while inflight:
            yield inflight.pop(0).result()
