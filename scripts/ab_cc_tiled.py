"""Time the port's B2 (``ecseg_label``) and B3 (``ecseg_flood_border``)
kernels against the three-pass union-find of an older checkout of the
port, in turns on one CUDA card.

    python3 scripts/ab_cc_tiled.py --base DIR [--reps 20] [--profile] [--out FILE]

DIR is a checkout of the repository from before the tiled union-find (its
``ecseg_torch/csrc/cc_flood.cu`` floods from the border through
``ecseg_flood`` with a null seed pointer).  Its ``cc_label.cu`` and
``cc_flood.cu`` are built with this checkout's nvcc flags into a temporary
directory; this checkout's kernels through ``ecseg_torch._build``.  Both
are called through ctypes on preallocated buffers, so the times are the
kernels' own.  The masks are those of ``chip_smoke.py``'s phase 2: random
(p = 0.5), snake and spiral at 2048^2 and 2048x3072, and the tile-edge
masks of ``tests/_masks.py`` (``tile_masks``) at 2048^2, 2047x2049,
33x4097, 1x2048 and 2048x1.  Per mask: B2 at connectivity 1 and 2 and B3,
each timed base, new, new, base (CUDA-event mean over ``--reps``
back-to-back launches after one warm-up), and the two versions' outputs
must be equal byte for byte.  With ``--profile``, each 2048^2 mask's
calls are also traced once by ``torch.profiler`` and each version's
device time is split by kernel name (mean us per call).  Prints one line
per mask and a JSON object last (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

TILE_SIZES = ((2048, 2048), (2047, 2049), (33, 4097), (1, 2048), (2048, 1))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_base(base: str, out_dir: str):
    """(label, flood) ctypes functions of the base checkout's kernels."""
    from ecseg_torch import _build

    csrc = os.path.join(base, "ecseg_torch", "csrc")
    libs = {}
    procs = []
    for src in ("cc_label.cu", "cc_flood.cu"):
        so = os.path.join(out_dir, f"lib{src[:-3]}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", so, os.path.join(csrc, src)]
        procs.append((src, so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for src, so, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the base's {src}:\n{out}{err}")
        libs[src] = ctypes.CDLL(so)
    label = libs["cc_label.cu"].ecseg_label
    label.argtypes = [_P, _P, _I, _I, _I, _P]
    flood = libs["cc_flood.cu"].ecseg_flood
    flood.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
    for fn in (label, flood):
        fn.restype = _I
    return label, flood


def new_kernels():
    from ecseg_torch.ops import cc_kernels as K

    return K._cfunc("ecseg_label"), K._cfunc("ecseg_flood_border")


def masks():
    from _masks import tile_masks
    from chip_smoke import snake, spiral

    rng = np.random.default_rng(0)
    for h, w in ((2048, 2048), (2048, 3072)):
        yield f"random {h}x{w}", rng.random((h, w)) < 0.5
        yield f"snake {h}x{w}", snake(h, w)
        yield f"spiral {h}x{w}", spiral(h, w)
    for h, w in TILE_SIZES:
        for name, m in tile_masks(h, w).items():
            yield f"{name} {h}x{w}", m


def event_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def kernel_us(fn, reps):
    """Mean device us per call of ``fn`` by kernel (and memset) name, from
    one torch.profiler pass over ``reps`` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the trace may lose the first kernel of its window
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
            name = e.name.split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_cc_tiled: no CUDA device is available", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="ab_cc_") as tmp:
        base_label, base_flood = build_base(os.path.abspath(args.base), tmp)
        new_label, new_flood = new_kernels()
        stream = torch.cuda.current_stream().cuda_stream
        rows = []
        for what, m in masks():
            mt = torch.from_numpy(m).cuda()
            h, w = m.shape
            lab = [torch.empty((h, w), dtype=torch.int32, device="cuda") for _ in range(2)]
            out = [torch.empty((h, w), dtype=torch.bool, device="cuda") for _ in range(2)]
            flag = torch.empty(h * w, dtype=torch.uint8, device="cuda")

            def call(fn, *a):
                rc = fn(*a, stream)
                if rc:
                    raise RuntimeError(f"launch failed on {what}: CUDA error {rc}")

            runs = {}
            for conn in (1, 2):
                runs[f"label conn {conn}"] = (
                    lambda c=conn: call(base_label, mt.data_ptr(), lab[0].data_ptr(), h, w, c),
                    lambda c=conn: call(new_label, mt.data_ptr(), lab[1].data_ptr(), h, w, c),
                    lab,
                )
            runs["flood_border"] = (
                lambda: call(base_flood, mt.data_ptr(), None, lab[0].data_ptr(), flag.data_ptr(), out[0].data_ptr(), h, w, 1),
                lambda: call(new_flood, mt.data_ptr(), lab[1].data_ptr(), flag.data_ptr(), out[1].data_ptr(), h, w),
                out,
            )
            row = {"mask": what}
            for key, (base, new, res) in runs.items():
                base()
                new()
                torch.cuda.synchronize()
                if not torch.equal(res[0], res[1]):
                    raise RuntimeError(f"{key} on {what}: the tiled kernel's output differs from the base's")
                t = [event_ms(f, args.reps) for f in (base, new, new, base)]
                row[key] = {"base_ms": (t[0] + t[3]) / 2, "new_ms": (t[1] + t[2]) / 2, "turns": t}
                if args.profile and (h, w) == (2048, 2048):
                    row[key]["base_us_by_kernel"] = kernel_us(base, args.reps)
                    row[key]["new_us_by_kernel"] = kernel_us(new, args.reps)
                    for side in ("base", "new"):
                        parts = ", ".join(f"{n} {us:.1f}" for n, us in row[key][f"{side}_us_by_kernel"].items())
                        print(f"  {what} {key} {side} device us: {parts}", flush=True)
            rows.append(row)
            print(
                f"{what}: " + "; ".join(f"{k} {row[k]['base_ms']:.4f} -> {row[k]['new_ms']:.4f} ms" for k in runs),
                flush=True,
            )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    result = {"card": smi, "reps": args.reps, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
