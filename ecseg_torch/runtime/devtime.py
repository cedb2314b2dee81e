"""Timing on the card, shared by ``chip_smoke.py`` and the on-chip studies
(``python -m ecseg_torch.profile_*``, ``quantify_watershed_divergence``).

- :func:`cuda_ms`: the CUDA-event mean of back-to-back calls;
- :func:`device_ms`: the device-only time of a call (its kernels and
  memsets) from ``torch.profiler``, from a pass that recorded every
  operation; a pass that lost records is repeated and ``tries`` such passes
  raise :class:`IncompleteProfile`, so no caller sums a partial pass;
- :func:`device_kernels`: the names of a call's device operations;
- :func:`split`: host wall against device time of a call, with its device
  operations and host syncs;
- :func:`card`: the card's name and power limit as ``nvidia-smi`` gives
  them, printed beside every number.

Every function here needs a card and raises without one, as
``device.resolve_device`` does: nothing is timed on the CPU under a
device's name.  The completeness test (:func:`complete`) and the sync
counter (:func:`count_syncs`) take their inputs as arguments, so that the
tests hold them on the CPU.

On the H100's machine (torch 2.11) ``torch.profiler`` drops the device
records of short windows once the process has spent a while with the card
idle (host work: a 300 s sleep, metaseg's host redo, ``profile_layers``'
host draws, stat_fish's host tail): one-call windows then record nothing.
A pass with a record missing fails :func:`complete`, and :func:`split`
raises :class:`IncompleteProfile` rather than return a partial sum; the
studies run one to a process and profile before their long host work.
``python -m ecseg_torch.runtime.devtime [EXPERIMENT]`` reproduces it
(ROADMAP §C).
"""

from __future__ import annotations

import subprocess
import sys
import time
import warnings
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch

NO_CARD = "no CUDA device is available: timing on the card needs one"
SYNC_WARNING = "called a synchronizing CUDA operation"  # torch.cuda.set_sync_debug_mode's warning


class IncompleteProfile(RuntimeError):
    """Every ``torch.profiler`` pass over a function lost device records."""


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the first card, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    require_card()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up."""
    require_card()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_events(events) -> List:
    """The device operations among profiler events, without the spin kernel
    that opens each window."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name]


def complete(per_call: Counter, per_pass: Counter, reps: int) -> bool:
    """Whether a pass over ``reps`` calls recorded every operation name
    ``reps`` times as often as one profiled call did (each caller's
    function launches the same device operations on every call)."""
    return bool(per_call) and per_pass == Counter({k: reps * v for k, v in per_call.items()})


MAX_RECORDS = 50_000  # device records a profiler window may hold (a pass over fewer calls above it)


def _trace(fn, calls: int) -> List:
    """Device events of ``calls`` calls of ``fn`` in one profiler window.
    The trace often loses the first kernel of its window: a spin kernel
    opens it, and is left out of the sums."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return device_events(prof.events())


def _sum_ms(events, reps: int) -> float:
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps


def complete_pass(fn, reps: int, tries: int = 5, trace: Callable = _trace, log=print) -> Tuple[List, Counter, int]:
    """(device events of the pass, operation names of one call, the calls
    in the pass) from the first complete pass over ``reps`` calls, or over
    fewer when ``reps`` calls would hold more than ``MAX_RECORDS`` records;
    ``fn`` is warmed up by the first one-call window.  ``tries`` incomplete
    passes raise :class:`IncompleteProfile`."""
    for _ in range(tries):
        per_call = Counter(e.name for e in trace(fn, 1))
        calls = max(1, min(reps, MAX_RECORDS // max(1, sum(per_call.values()))))
        ops = trace(fn, calls)
        per_pass = Counter(e.name for e in ops)
        if complete(per_call, per_pass, calls):
            return ops, per_call, calls
        lost = {k: calls * v - per_pass[k] for k, v in per_call.items() if calls * v != per_pass[k]}
        extra = {k: v for k, v in per_pass.items() if k not in per_call}
        log(f"torch.profiler pass incomplete over {calls} calls ({sum(per_pass.values())} records of "
            f"{calls * sum(per_call.values())}): missing {lost}, not in the one-call window {extra}; profiling again", flush=True)
    raise IncompleteProfile(f"{tries} torch.profiler passes lost device records")


def device_ms(fn, reps: int, tries: int = 5, kernel: Optional[str] = None, event_ms: Optional[float] = None,
              trace: Callable = _trace, log=print):
    """Mean device-only time of ``fn`` (the sum of its kernels and memsets)
    from one complete ``torch.profiler`` pass over ``reps`` calls after one
    warm-up (:func:`complete_pass`).  The pass traces the device only.

    With ``kernel`` (a substring of the wrapper's own kernel's name) the
    pass must have recorded that kernel, not only the wrapper's weight
    casts and copies; returns (device ms, that kernel's device ms).  With
    ``event_ms`` (the CUDA-event mean of the same calls) a pass whose
    device sum differs from it by more than 25 % is repeated too, and the
    last one is kept, with a line that gives both numbers."""
    if trace is _trace:
        require_card()
        fn()
        torch.cuda.synchronize()
    done = None
    for _ in range(tries):
        ops, per_call, calls = complete_pass(fn, reps, tries, trace, log)
        total = _sum_ms(ops, calls)
        if kernel is None:
            return total
        own = [e for e in ops if kernel in e.name]
        if not own:
            raise RuntimeError(f"the profiler recorded no kernel named *{kernel}* among {sorted(per_call)}")
        done = (total, _sum_ms(own, calls))
        if event_ms is None or abs(total - event_ms) <= 0.25 * event_ms:
            return done
        log(f"device sum {total:.4f} ms vs CUDA-event mean {event_ms:.4f} ms differ by more than 25 %; profiling again", flush=True)
    log(f"device sum {done[0]:.4f} ms (kernel {done[1]:.4f} ms) and CUDA-event mean {event_ms:.4f} ms still differ after {tries} passes", flush=True)
    return done


def device_kernels(fn) -> List[str]:
    """Names of the device operations of one call of ``fn`` (one
    ``torch.profiler`` pass after a warm-up; a spin kernel opens the window,
    as in :func:`device_ms`)."""
    require_card()
    fn()
    torch.cuda.synchronize()
    return sorted(e.name for e in _trace(fn, 1))


def count_syncs(fn, set_mode: Optional[Callable] = None, get_mode: Optional[Callable] = None):
    """(``fn()``, the host syncs it made): the warnings that
    ``torch.cuda.set_sync_debug_mode("warn")`` raises at each synchronizing
    operation (a device-to-host copy, ``.item()``, ``torch.nonzero``, a
    ``bool`` of a device tensor, ...) while ``fn`` runs; the mode is
    restored after."""
    set_mode = torch.cuda.set_sync_debug_mode if set_mode is None else set_mode
    get_mode = torch.cuda.get_sync_debug_mode if get_mode is None else get_mode
    before = get_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        set_mode("warn")
        try:
            out = fn()
        finally:
            set_mode(before)
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


def wall_ms(fn, reps: int) -> float:
    """The host clock's mean over ``reps`` calls of ``fn`` after a warm-up,
    ended by ``torch.cuda.synchronize()``."""
    require_card()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def split(fn, reps: int, tries: int = 5) -> Dict[str, float]:
    """Host against device time of ``fn``, per call:

    - ``wall_ms``: :func:`wall_ms`;
    - ``device_ms``: the device sum of a complete profiler pass
      (:func:`complete_pass`; raises :class:`IncompleteProfile` rather than
      return a partial sum);
    - ``ops``: the device operations of one call;
    - ``syncs``: the host syncs of one call (:func:`count_syncs`).

    ``wall_ms - device_ms`` is the host's share.  The device sum adds up
    kernels that overlap (cuDNN's FFT convolution runs on several
    streams), so it can exceed the wall."""
    wall = wall_ms(fn, reps)
    ops, per_call, calls = complete_pass(fn, reps, tries)
    _, syncs = count_syncs(fn)
    torch.cuda.synchronize()
    return {"wall_ms": wall, "device_ms": _sum_ms(ops, calls), "ops": sum(per_call.values()), "syncs": syncs}


# --------------------------------------------------------------------------
# python -m ecseg_torch.runtime.devtime: the record-loss reproduction
# --------------------------------------------------------------------------

PROBE_PASSES = 4  # profiler passes per window size and stage
PROBE_WINDOWS = (1, 20, 200)  # calls per pass


GUARD_CYCLES = 200_000_000  # about 100 ms of an H100's clock


def _guarded_trace(fn, calls: int) -> List:
    """:func:`_trace` with spin kernels of about 100 ms before and after the
    calls (the probe's second window form)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(GUARD_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(GUARD_CYCLES)
        torch.cuda.synchronize()
    return device_events(prof.events())


def _probe(tag: str, fn, windows=PROBE_WINDOWS) -> Dict:
    """``PROBE_PASSES`` passes of ``fn`` at each window size, in
    :func:`_trace`'s window and in :func:`_guarded_trace`'s: per window,
    the passes that recorded every operation of ``calls`` calls, and the
    records the others lost against one call in a window of its own."""
    fn()
    torch.cuda.synchronize()
    out = {"stage": tag}
    for form, trace in (("plain", _trace), ("guarded", _guarded_trace)):
        one = Counter(e.name for e in trace(fn, 1))
        res = {"one_call_ops": sum(one.values())}
        for calls in windows:
            whole, lost = 0, Counter()
            for _ in range(PROBE_PASSES):
                got = Counter(e.name for e in trace(fn, calls))
                want = Counter({k: calls * v for k, v in one.items()})
                whole += got == want
                lost.update({k[:80]: v for k, v in (want - got).items()})
                lost.update({k[:80]: -v for k, v in (got - want).items()})
            res[calls] = {"complete": whole, "passes": PROBE_PASSES, "lost": dict(lost)}
        out[form] = res
        print(f"[{tag}, {form} window] one call {res['one_call_ops']} ops; " + "; ".join(
            f"{calls} calls: {res[calls]['complete']}/{PROBE_PASSES} complete" for calls in windows), flush=True)
    return out


EXPERIMENTS = ("stat_fish", "records", "fft_unprofiled", "fft_profiled", "idle")
IDLE_S = 300  # the idle experiment's wait


def main(argv=None) -> int:
    """Reproduce the profiler's record loss, one experiment a process
    (``python -m ecseg_torch.runtime.devtime [EXPERIMENT]``, default
    ``stat_fish``), each with B2's passes at 2048^2 (:func:`_probe`, in
    :func:`_trace`'s window and with 100 ms guards) before and after:

    - ``stat_fish``: a NuSeT segmentation on the main thread, then
      ``stat_fish.main`` on two synthetic 2048^2 FISH images (reader and tail
      threads; NuSeT with confident RPN scores, so the certified watershed
      runs), then ``empty_cache``;
    - ``records``: one profiler window of B2 x 12000 calls (48000 device
      records);
    - ``fft_unprofiled``: a float32 convolution that cuDNN runs as an FFT
      under the parity flags (64^2, 256 -> 128, 100 patches,
      channels-last; about 8300 device operations), 5 calls outside any
      profiler window;
    - ``fft_profiled``: that convolution in a window of its own, once;
    - ``idle``: ``IDLE_S`` seconds of an idle process (``time.sleep``).

    Prints a line a stage and window, and one JSON line (negative ``lost``:
    records the one-call window lost)."""
    import json
    import os
    import tempfile

    import numpy as np

    argv = sys.argv[1:] if argv is None else list(argv)
    if not torch.cuda.is_available():
        print("devtime: no CUDA device is available; aborting without a result", file=sys.stderr, flush=True)
        return 1
    exp = argv[0] if argv else "stat_fish"
    if exp not in EXPERIMENTS:
        print(f"devtime: unknown experiment {exp!r}; one of {EXPERIMENTS}", file=sys.stderr, flush=True)
        return 2
    from ..models.layers import parity_flags
    from ..ops.cc_kernels import label

    smi = card()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; experiment {exp}", flush=True)
    dev = torch.device("cuda")
    mask = torch.from_numpy(np.random.default_rng(0).random((2048, 2048)) < 0.5).to(dev)

    def b2():
        label(mask)

    x = torch.randn(100, 256, 64, 64, device=dev).contiguous(memory_format=torch.channels_last)
    w = torch.randn(128, 256, 3, 3, device=dev)

    def fft_conv():
        with parity_flags():
            torch.nn.functional.conv2d(x, w, padding=1)

    stages = [_probe("B2, fresh process", b2)]
    if exp == "stat_fish":
        from .. import bench_stat_fish
        from ..core import imgio
        from ..models import nuset_infer
        from ..models.demo import demo_nuset_tree
        from ..models.weights import load_nuset_model, save_npz

        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as d:
            os.chdir(d)
            try:
                tree = demo_nuset_tree(torch.Generator().manual_seed(0))
                tree["fg"]["rpn"]["rpn_cls_score"]["bias"][1::2] = 6.0  # every proposal above min_score
                os.makedirs("models")
                save_npz(os.path.join("models", "nuset.npz"), tree)
                folder = os.path.join(d, "images")
                os.makedirs(folder)
                bench_stat_fish.make_images(folder, 2)
                model = load_nuset_model(device=dev, resize_scale=0.3)
                image = imgio.u16_to_u8(imgio.imread_bgr8(os.path.join(folder, "bench_00.tif")))[..., 0]
                nuset_infer.nuclei_segment(image, model, 5000)
                torch.cuda.synchronize()
                stages.append(_probe("B2, after nuclei_segment on the main thread", b2))
                bench_stat_fish.run_once(folder, dev)
                torch.cuda.synchronize()
                stages.append(_probe("B2, after stat_fish.main", b2))
            finally:
                os.chdir(cwd)
        torch.cuda.empty_cache()
        stages.append(_probe("B2, after empty_cache", b2))
    elif exp == "records":
        n = len(_trace(b2, 12000))
        print(f"one window of B2 x 12000 calls: {n} device records", flush=True)
        stages.append(_probe(f"B2, after a window of {n} records", b2))
    elif exp == "fft_unprofiled":
        for _ in range(5):
            fft_conv()
        torch.cuda.synchronize()
        stages.append(_probe("B2, after the FFT convolution outside the profiler", b2))
    elif exp == "idle":
        time.sleep(IDLE_S)
        stages.append(_probe(f"B2, {IDLE_S} s later", b2))
    else:
        n = len(_trace(fft_conv, 1))
        print(f"the FFT convolution in a window of its own: {n} device records", flush=True)
        stages.append(_probe("B2, after the FFT convolution in a window", b2))
        stages.append(_probe("the FFT convolution", fft_conv, windows=(1, 2)))
    print(json.dumps({"probe": "torch.profiler record loss", "experiment": exp, "card": smi, "torch": torch.__version__,
                      "stages": stages}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
