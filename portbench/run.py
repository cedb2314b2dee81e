"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's weights on the card and its inputs from the seed
(under ``TMPDIR``), builds the program's objects and warms up the cell's
shapes; the window then drives the program for ``--seconds`` seconds, to
the end of the pass over the input folder that is running then; the check compares a
sample of the window's answers with the plain reference.  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).

The program runs with its defaults: every ``ECSEG_*`` variable is unset,
except ``ECSEG_TRACE=1`` in a traced run.  Exits 1 and prints no result
without the CUDA devices the cell asks for, and when a module of JAX or
of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Dict, List, Optional, Sequence  # noqa: E402

from portbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ecseg_tpu")
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions"}


def prepare_env(trace: bool) -> None:
    """The program's defaults, and every build cache inside the checkout
    at a fixed path (the program's own kernels build under ``build/``)."""
    for key in [k for k in os.environ if k.startswith("ECSEG_")]:
        del os.environ[key]
    if trace:
        os.environ["ECSEG_TRACE"] = "1"
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(spec.CHECKOUT, "build", "portbench", sub)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Run:
    """What one run knows: its cell, configuration, mix, seed, device and
    working folder, and the modules found for them by name."""

    def __init__(self, bench: Dict, workload: str, seed: int, seconds: float, trace: bool, device: str,
                 roots: Sequence[str], workdir: str, log=None):
        self.bench, self.wl = bench, spec.workload(bench, workload)
        self.roots = list(roots)
        self.cfg = spec.config(bench, self.wl["config"], self.roots)
        self.traffic = spec.load_json(self.roots, "traffic", self.wl["traffic"])
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.workdir = workdir
        self.log = log or (lambda *a, **k: print(*a, file=sys.stderr, flush=True, **k))
        self.weights_module = spec.load_module(self.roots, "weights", self.wl["config"])
        self.reference = spec.load_module(self.roots, "reference", self.wl["config"])
        self.driver_module = spec.load_module(self.roots, "drivers", self.traffic["driver"])


def run_cell(run: Run, t0: float) -> Dict:
    """Set-up, window, profile (traced), check; returns the result line's
    fields.  ``t0``: the process's start on ``time.perf_counter``."""
    import torch

    from ecseg_torch.ops import packing
    from ecseg_torch.runtime import fallbacks
    from ecseg_torch.runtime import trace as program_trace

    from portbench import profiling

    on_card = run.device != "cpu"
    drv = run.driver_module.Driver(run)
    drv.setup()
    tracer = program_trace.tracer()
    tracer.reset()
    packing.reset_fetched()
    fallbacks.reset()
    start = time.perf_counter()
    setup_s = start - t0
    images, ends = 0, [start]
    while ends[-1] - start < run.seconds:  # whole units of work (for a folder, whole passes)
        images += drv.step()
        ends.append(time.perf_counter())
    window_s = ends[-1] - start
    units = sorted(b - a for a, b in zip(ends, ends[1:]))
    run.log(f"portbench: {len(units)} units in {window_s:.3f} s: min {units[0]:.4f} median "
            f"{units[len(units) // 2]:.4f} max {units[-1]:.4f} s; the first {ends[1] - start:.4f} s")
    stages = tracer.times()
    fetched = dict(packing.FETCHED)
    fell_back = fallbacks.counts()
    run.log(f"portbench: {fallbacks.summary()} in the window")
    profile = None
    if run.trace and on_card:
        tracer.enabled = False  # the profiled stretch runs without the stages' syncs
        with profiling.annotated_stages():
            profile = profiling.profile(drv.step, log=run.log)
        tracer.enabled = True
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    drv.close()
    tracer.reset()  # its exit report would print after the result line
    ctx = {"cfg": run.cfg, "setup_s": setup_s, "window_s": window_s, "images": images, "stages": stages,
           "fetch": fetched, "fallbacks": fell_back, "profile": profile,
           "device_name": torch.cuda.get_device_name(0) if on_card else "cpu"}
    ctx.update(drv.facts())
    metrics = {}
    for m in spec.metrics(run.bench, run.wl, run.trace):
        value = spec.load_module(run.roots, "metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = run.cfg["check"]["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in drv.readings()[0].items()}
    device = {"platform": "gpu" if on_card else "cpu", "kind": ctx["device_name"],
              "count": run.wl["chips"], "memory_peak_bytes": peak}
    # an image the program fails on raises, and the run ends without a result
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()), "attempted": images,
              "failed": 0, "metrics": metrics, "device": device}
    if profile is not None:
        device.update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv: Optional[Sequence[str]] = None, device: str = "cuda", roots: Sequence[str] = (spec.PKG,),
         bench_path: Optional[str] = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env(bool(args.trace))
    import torch

    bench = spec.load_benchmark(bench_path)
    wl = spec.workload(bench, args.workload)
    if device != "cpu" and (not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]):
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 1
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        run = Run(bench, args.workload, args.seed, args.seconds, bool(args.trace), device, roots, workdir)
        result = run_cell(run, T0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
