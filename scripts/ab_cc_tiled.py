"""Time the port's B2 (``ecseg_label``), B3 (``ecseg_flood_border``), B4
(``ecseg_flood``), B5 (``ecseg_label_mc``), B6 (``ecseg_flood_mc``) and B9
(``ecseg_label_flood``) kernels against those of another checkout of the
port, in turns on one CUDA card.

    python3 scripts/ab_cc_tiled.py --base DIR [--reps 20] [--profile] [--out FILE]

DIR is another checkout of the repository (the base).  Its ``cc_label.cu``
and ``cc_flood.cu`` are built with this checkout's nvcc flags into a
temporary directory; this checkout's kernels through
``ecseg_torch._build``.  A base from before the tiled union-find has no
``ecseg_flood_border``: its border flood is ``ecseg_flood`` with a null
seed pointer.  Both versions are called through ctypes on preallocated
buffers, so the times are the kernels' own.  The floods get a flag
buffer of their own on the base side (a base from before the tiled forest
gathers from flags it must not share with its output) and their output as
the flag buffer on this side, as ``ops/cc_kernels.py`` passes it.  The
masks are those of
``chip_smoke.py``'s phase 2: random (p = 0.5), snake and spiral at 2048^2
and 2048x3072, and the tile-edge masks of ``tests/_masks.py``
(``tile_masks``) at 2048^2, 2047x2049, 33x4097, 1x2048 and 2048x1.  Per
mask: B2 at connectivity 1 and 2, B3, B4 at connectivity 1 and 2 from
sparse random seeds (p = 0.001, some off the mask), B9 at connectivity 1
and 2 from the same seeds, and B5 and B6 (the same seeds) on the mask as
a class map (0 and 1); then B5, B6 and B9 (on the odd classes) from
sparse seeds on ``chip_smoke.class_maps`` (uniform, column-striped, snake
and spiral class maps) at 2048^2 and 2048x3072.
Each is timed base, new, new, base (CUDA-event mean over ``--reps``
back-to-back launches after one warm-up), and the two versions' outputs
must be equal byte for byte (B9: labels and flood).  With ``--profile``,
each 2048^2 input's calls are also traced once by ``torch.profiler`` and
each version's device time is split by kernel name, that is by pass (mean
us per call).  Prints one line
per input and a JSON object last (also written to ``--out``).
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


def _bind(fn, argtypes):
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


_LABEL = [_P, _P, _I, _I, _I, _P]
_FLOOD = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
_FLOOD_BORDER = [_P, _P, _P, _P, _I, _I, _P]
_LABEL_MC = [_P, _P, _I, _I, _P]
_FLOOD_MC = [_P, _P, _P, _P, _P, _I, _I, _P]


def build_base(base: str, out_dir: str):
    """{kernel: ctypes function} of the base checkout's kernels; the border
    flood takes (trav, labels, flag, out, h, w, stream) in either form."""
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
    flood = _bind(libs["cc_flood.cu"].ecseg_flood, _FLOOD)
    if hasattr(libs["cc_flood.cu"], "ecseg_flood_border"):
        border = _bind(libs["cc_flood.cu"].ecseg_flood_border, _FLOOD_BORDER)
    else:
        border = lambda trav, lab, flag, out, h, w, stream: flood(trav, None, lab, flag, out, h, w, 1, stream)
    return {
        "label": _bind(libs["cc_label.cu"].ecseg_label, _LABEL),
        "flood_border": border,
        "flood_seeds": flood,
        "label_mc": _bind(libs["cc_label.cu"].ecseg_label_mc, _LABEL_MC),
        "flood_mc": _bind(libs["cc_flood.cu"].ecseg_flood_mc, _FLOOD_MC),
        "label_flood": _bind(libs["cc_flood.cu"].ecseg_label_flood, _FLOOD),
    }


def new_kernels():
    from ecseg_torch.ops import cc_kernels as K

    return {
        "label": K._cfunc("ecseg_label"), "flood_border": K._cfunc("ecseg_flood_border"),
        "flood_seeds": K._cfunc("ecseg_flood"), "label_mc": K._cfunc("ecseg_label_mc"),
        "flood_mc": K._cfunc("ecseg_flood_mc"), "label_flood": K._cfunc("ecseg_label_flood"),
    }


def masks():
    """(name, bool mask or None, uint8 class map)."""
    from _masks import tile_masks
    from chip_smoke import class_maps, snake, spiral

    rng = np.random.default_rng(0)
    for h, w in ((2048, 2048), (2048, 3072)):
        for name, m in (("random", rng.random((h, w)) < 0.5), ("snake", snake(h, w)), ("spiral", spiral(h, w))):
            yield f"{name} {h}x{w}", m, m.astype(np.uint8)
    for h, w in TILE_SIZES:
        for name, m in tile_masks(h, w).items():
            yield f"{name} {h}x{w}", m, m.astype(np.uint8)
    for h, w in ((2048, 2048), (2048, 3072)):
        for name, cls in class_maps(np.random.default_rng(1), h, w).items():
            yield f"{name} class map {h}x{w}", None, cls


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
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
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
        base_k = build_base(os.path.abspath(args.base), tmp)
        new_k = new_kernels()
        stream = torch.cuda.current_stream().cuda_stream
        seed_rng = np.random.default_rng(2)
        rows = []
        for what, m, cls in masks():
            h, w = cls.shape
            ct = torch.from_numpy(cls).cuda()
            lab = [torch.empty((h, w), dtype=torch.int32, device="cuda") for _ in range(2)]
            out = [torch.empty((h, w), dtype=torch.bool, device="cuda") for _ in range(2)]
            flag = torch.empty(h * w, dtype=torch.uint8, device="cuda")

            def call(fn, *a):
                rc = fn(*a, stream)
                if rc:
                    raise RuntimeError(f"launch failed on {what}: CUDA error {rc}")

            def pair(key, *args, res):
                """(base, new, outputs) of kernel ``key``; an argument given
                as a list holds the base's and the new side's values, and
                ``res`` is a tuple of such lists, the outputs to compare."""
                def side(k, fns):
                    return lambda: call(fns[key], *[a[k] if isinstance(a, list) else a for a in args])
                return side(0, base_k), side(1, new_k), res

            seeds = torch.from_numpy(seed_rng.random((h, w)) < 0.001).cuda()
            L = [t.data_ptr() for t in lab]
            O = [t.data_ptr() for t in out]
            F = [flag.data_ptr(), O[1]]  # the flags: a buffer of their own on the base side, the output here
            runs = {}
            if m is not None:
                mt = torch.from_numpy(m).cuda()
                for conn in (1, 2):
                    runs[f"label conn {conn}"] = pair("label", mt.data_ptr(), L, h, w, conn, res=(lab,))
                runs["flood_border"] = pair("flood_border", mt.data_ptr(), L, flag.data_ptr(), O, h, w, res=(out,))
                for conn in (1, 2):
                    runs[f"flood_seeds conn {conn}"] = pair(
                        "flood_seeds", mt.data_ptr(), seeds.data_ptr(), L, flag.data_ptr(), O, h, w, conn, res=(out,)
                    )
                b9_mask = mt
            else:
                b9_mask = ct % 2 == 1  # chip_smoke's B9 input: the odd classes
            runs["label_mc"] = pair("label_mc", ct.data_ptr(), L, h, w, res=(lab,))
            runs["flood_mc"] = pair("flood_mc", ct.data_ptr(), seeds.data_ptr(), L, F, O, h, w, res=(out,))
            for conn in (1, 2):
                runs[f"label_flood conn {conn}"] = pair(
                    "label_flood", b9_mask.data_ptr(), seeds.data_ptr(), L, F, O, h, w, conn, res=(lab, out)
                )
            row = {"mask": what}
            for key, (base, new, res) in runs.items():
                base()
                new()
                torch.cuda.synchronize()
                if not all(torch.equal(r[0], r[1]) for r in res):
                    raise RuntimeError(f"{key} on {what}: the new kernel's output differs from the base's")
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
