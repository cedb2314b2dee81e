"""Prefetching map for folder-batch inference (twin of
``ecseg_tpu/runtime/batching.py``): reader threads decode and patchify the
next images while the main thread drives the card."""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterable, Iterator, Tuple, TypeVar

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
