"""The traced run's device profile: one unit of the driver's work under
``torch.profiler``, checked for lost records, read for the
device's busy time, its idle gaps by the program stage that was open on
the host, and the device operations that took the most time.

The profiler drops device records once the card has idled (a known fault
of it on this card), and at some hundred thousand records a stretch also
loses a few at random, so a stretch is used only if it is complete to
within ``LOST_SHARE``.  The test follows the port's
``runtime/devtime.complete``: a stretch is held against a stretch of the
same work just before it, operation name by operation name; each record
it lacks counts at its operation's mean time in the stretch before, and
all of them together may hold at most ``LOST_SHARE`` of that stretch's
device time (the busy time read is then at most that share short).  The
driver's stretch is work that repeats exactly (for a folder, one pass
over its images: single images launch data-dependent numbers of
operations).  A spin kernel opens each stretch, since the
trace often loses the first kernel of its window; it is left out.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

STAGE = "stage:"
STRETCH = "portbench.stretch"


LOST_SHARE = 0.002


def lost_share(before: List[Event], after: List[Event]) -> float:
    """The share of ``before``'s device time that the records ``after``
    lacks held: the shortfall of each operation name, at its mean time in
    ``before``; 1 when either stretch recorded nothing."""
    count_before, count_after = Counter(e[0] for e in before), Counter(e[0] for e in after)
    if not count_before or not count_after:
        return 1.0
    time_ns: Counter = Counter()
    for name, _, a, b, _ in before:
        time_ns[name] += b - a
    lost = sum(max(0, n - count_after[k]) * time_ns[k] / n for k, n in count_before.items())
    return lost / max(1, sum(time_ns.values()))


@contextlib.contextmanager
def annotated_stages():
    """While open, each of the program's tracer stages also opens a
    ``record_function`` range named ``stage:<name>``, so an idle gap can be
    given the stage its host thread was in."""
    from ecseg_torch.runtime import trace

    tr = trace.tracer()
    plain = tr.stage

    @contextlib.contextmanager
    def stage(name):
        with torch.profiler.record_function(STAGE + name), plain(name):
            yield

    tr.stage = stage
    try:
        yield
    finally:
        del tr.stage


Event = Tuple[str, bool, int, int, int]  # (name, on the device, start ns, end ns, host thread)


def _device(events: List[Event]) -> List[Event]:
    """The device's operations: not the spin kernel, and not the copies of
    the host's annotations that the trace also puts on the device's line."""
    return [e for e in events if e[1] and "spin_kernel" not in e[0] and not e[0].startswith(STAGE) and e[0] != STRETCH]


def _record(step: Callable[[], int]) -> Tuple[List[Event], int]:
    """The raw records of one unit of work (the profiler's own event tree
    is not built: a stretch holds some hundred thousand records)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        with torch.profiler.record_function(STRETCH):
            images = step()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [(e.name(), e.device_type() == cuda, e.start_ns(), e.end_ns(), e.start_thread_id())
              for e in prof.profiler.kineto_results.events()]
    return events, images


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read(events: List[Event], images: int) -> Dict:
    """Busy and idle seconds of the stretch, the top device operations, and
    the idle seconds by the innermost stage open at each gap's middle."""
    _, _, t0, t1, thread = next(e for e in events if e[0] == STRETCH)
    dev = _device(events)
    busy = _union([(max(t0, a), min(t1, b)) for _, _, a, b, _ in dev if b > t0 and a < t1])
    stages = [(a, b, name[len(STAGE):]) for name, on_dev, a, b, th in events
              if not on_dev and th == thread and name.startswith(STAGE)]
    stages.sort()
    starts = [s[0] for s in stages]
    idle = defaultdict(float)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, name = (a + b) / 2, "outside stages"
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):  # the latest-opened stage still open
            if stages[k][1] > mid:
                name = stages[k][2]
                break
        idle[name] += (b - a) / 1e9
    ops = defaultdict(float)
    for name, _, a, b, _ in dev:
        ops[name] += (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (t1 - t0) / 1e9, "busy_s": sum(b - a for a, b in busy) / 1e9, "images": images,
            "device_ops": top(ops), "idle_gaps": top(idle)}


def profile(step: Callable[[], int], tries: int = 3, log=print) -> Optional[Dict]:
    """A complete profile of one call of ``step`` (the driver's unit of
    work, which returns the images it finished), or None after ``tries``
    incomplete ones.  A unit repeats the same device work, so a stretch is
    checked against the stretch before it."""
    for _ in range(tries):
        before = _device(_record(step)[0])
        events, images = _record(step)
        after = _device(events)
        lost = lost_share(before, after)
        if lost <= LOST_SHARE:
            return read(events, images)
        count_before, count_after = Counter(e[0] for e in before), Counter(e[0] for e in after)
        apart = sorted(count_before | count_after, key=lambda k: -abs(count_after[k] - count_before[k]))[:5]
        log(f"portbench: profile incomplete ({len(after)} device records, {len(before)} in the "
            f"stretch before, {100 * lost:.4f} % of its time lost; most apart: "
            f"{[(k[:80], count_before[k], count_after[k]) for k in apart]}); again")
        time.sleep(0.1)
    return None
