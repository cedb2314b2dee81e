"""Time the port's B1 (``ecseg_stitch``), B2 (``ecseg_label``), B3
(``ecseg_flood_border``), B4 (``ecseg_flood``), B5 (``ecseg_label_mc``), B6
(``ecseg_flood_mc``), B8a (``ecseg_count``), B8b (``ecseg_count_patches``)
and B9 (``ecseg_label_flood``) kernels against those of another checkout of
the port, in turns on one CUDA card.

    python3 scripts/ab_cc_tiled.py --base DIR [--reps 20] [--rounds 3] [--profile] [--out FILE]

DIR is another checkout of the repository (the base).  Its ``stitch.cu``,
``cc_label.cu``, ``cc_flood.cu`` and ``cc_count.cu`` are built with this
checkout's nvcc flags into a temporary directory; this checkout's kernels
through ``ecseg_torch._build``.  A base whose B1 and B8b read the per-pixel
source map (no ``csrc/stitch_plan.cuh``) gets that map and, for B8b, a
full (T, H, W) parent array; a newer one the plan's descriptors and the
border-slot scratch, as ``ops/cc_kernels.py`` passes them.  A base whose
B8a unites in device memory (``uf_init`` in ``csrc/cc_label.cuh``) gets an
(H, W) parent array, a newer one the border-slot scratch.  A base from before the tiled union-find has no
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
B8a runs at connectivity 2 (1 too on the random mask) on metaseg's
stitched ecDNA mask (``raw == 3``) and meta_overlay's fish2_nc mask of one
``chip_smoke.synthetic_overlay_rgb`` image through the demo weights, and
on the random, snake and spiral masks, all 2048^2.
B1 runs on random classes at the 2048^2 (100 patches), 2048x3072 and
1024^2 plans; B8b at class 3 on 32 tiles of the 1024^2 plan (the
tile-count path's batch: class 3 on the bright squares of bench's tile
recipe, uniform random classes, sparse classes, all class 3; uint8, and
int32 on the random ones, at connectivity 2, the random ones also at 1)
and on one 2048^2 tile.
Each is timed in ``--rounds`` rounds of base, new, new, base (each turn a
CUDA-event mean over ``--reps`` back-to-back launches after one warm-up),
and reported as the median of each side's turns (a single outlier turn
moved the means); the two versions' outputs must be equal byte for byte
(B9: labels and flood).  With ``--profile``, each 2048^2 input's calls and
every B1, B8a and B8b input's are also traced once by ``torch.profiler`` and
each version's device time is split by kernel name, that is by pass (mean
us per call).  Prints one line per input and a JSON object last (also
written to ``--out``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
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
_COUNT_PATCHES = [_P, _I, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P, _P, _P]
_COUNT = [_P, _P, _I, _I, _I, _P, _P]
STITCH_PLANS = ((2048, 2048), (2048, 3072), (1024, 1024))


def build_base(base: str, out_dir: str):
    """({kernel: ctypes function} of the base checkout's kernels, whether its
    B1 and B8b read the plan's descriptors, whether its B8a needs an (H, W)
    parent array); the border flood takes (trav, labels, flag, out, h, w,
    stream) in either form."""
    from ecseg_torch import _build

    csrc = os.path.join(base, "ecseg_torch", "csrc")
    descriptors = os.path.exists(os.path.join(csrc, "stitch_plan.cuh"))
    with open(os.path.join(csrc, "cc_label.cuh")) as f:
        per_pixel_count = "uf_init" in f.read()
    libs = {}
    procs = []
    for src in ("stitch.cu", "cc_label.cu", "cc_flood.cu", "cc_count.cu"):
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
        "stitch": _bind(libs["stitch.cu"].ecseg_stitch, [_P, _P, _P, _I, _I, _P] if descriptors else [_P, _P, _P, _I, _P]),
        "label": _bind(libs["cc_label.cu"].ecseg_label, _LABEL),
        "flood_border": border,
        "flood_seeds": flood,
        "label_mc": _bind(libs["cc_label.cu"].ecseg_label_mc, _LABEL_MC),
        "flood_mc": _bind(libs["cc_flood.cu"].ecseg_flood_mc, _FLOOD_MC),
        "count": _bind(libs["cc_count.cu"].ecseg_count, _COUNT),
        "count_patches": _bind(libs["cc_count.cu"].ecseg_count_patches, _COUNT_PATCHES),
        "label_flood": _bind(libs["cc_flood.cu"].ecseg_label_flood, _FLOOD),
    }, descriptors, per_pixel_count


def new_kernels():
    from ecseg_torch.ops import cc_kernels as K

    return {
        "stitch": K._cfunc("ecseg_stitch"),
        "label": K._cfunc("ecseg_label"), "flood_border": K._cfunc("ecseg_flood_border"),
        "flood_seeds": K._cfunc("ecseg_flood"), "label_mc": K._cfunc("ecseg_label_mc"),
        "flood_mc": K._cfunc("ecseg_flood_mc"), "count": K._cfunc("ecseg_count"),
        "count_patches": K._cfunc("ecseg_count_patches"),
        "label_flood": K._cfunc("ecseg_label_flood"),
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


def time_pair(key, base, new, res, what, args):
    """One row entry: outputs equal, then ``--rounds`` of base, new, new,
    base; medians of each side's turns (and the split by pass)."""
    base()
    new()
    torch.cuda.synchronize()
    if not all(torch.equal(r[0], r[1]) for r in res):
        raise RuntimeError(f"{key} on {what}: the new kernel's output differs from the base's")
    turns = [event_ms(f, args.reps) for _ in range(args.rounds) for f in (base, new, new, base)]
    entry = {
        "base_ms": statistics.median(turns[0::4] + turns[3::4]),
        "new_ms": statistics.median(turns[1::4] + turns[2::4]),
        "turns": turns,
    }
    return entry


def profile_into(entry, key, what, base, new, args):
    entry["base_us_by_kernel"] = kernel_us(base, args.reps)
    entry["new_us_by_kernel"] = kernel_us(new, args.reps)
    for side in ("base", "new"):
        parts = ", ".join(f"{n} {us:.1f}" for n, us in entry[f"{side}_us_by_kernel"].items())
        print(f"  {what} {key} {side} device us: {parts}", flush=True)


def stitch_count_rows(base_k, descriptors, new_k, stream, args):
    """B1 and B8b rows: the base side gets the per-pixel source map (and,
    for B8b, a full parent array) unless it reads descriptors."""
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import tiling
    from ecseg_torch.ops.tiling import SCW

    def call(fn, *a):
        rc = fn(*a, stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    rng = np.random.default_rng(3)
    rows = []
    for h, w in STITCH_PLANS:
        pos = tuple(map(tuple, tiling.patch_positions(h, w)))
        lp = torch.from_numpy(rng.integers(0, 4, (len(pos), 256, 256)).astype(np.uint8)).cuda()
        desc, src = K._descriptors(pos, lp.device)[0], K._source_map(pos, lp.device)
        out = [torch.empty((h, w), dtype=torch.int32, device="cuda") for _ in range(2)]
        if descriptors:
            base = lambda: call(base_k["stitch"], lp.data_ptr(), desc.data_ptr(), out[0].data_ptr(), h, w)
        else:
            base = lambda: call(base_k["stitch"], lp.data_ptr(), src.data_ptr(), out[0].data_ptr(), h * w)
        new = lambda: call(new_k["stitch"], lp.data_ptr(), desc.data_ptr(), out[1].data_ptr(), h, w)
        what = f"stitch {h}x{w} ({len(pos)} patches)"
        row = {"mask": what, "stitch": time_pair("stitch", base, new, (out,), what, args)}
        if args.profile:
            profile_into(row["stitch"], "stitch", what, base, new, args)
        rows.append(row)
        print(f"{what}: stitch {row['stitch']['base_ms']:.4f} -> {row['stitch']['new_ms']:.4f} ms", flush=True)

    def labels(kind, t, n):
        if kind == "tile recipe":  # bench's tiles, class 3 on their bright squares
            from ecseg_torch.pipelines import tile_count

            patches, _ = tile_count.tile_patches(tile_count.synthetic_tiles(t, 0))
            return np.where(patches[..., 0] == 230, 3, 0).astype(np.uint8)
        if kind == "all class 3":
            return np.full((t, n, 256, 256), 3, np.uint8)
        lp = rng.integers(0, 4, (t, n, 256, 256)).astype(np.uint8)
        if kind == "sparse":
            lp[rng.random(lp.shape) < 0.97] = 0
        return lp

    cases = [(1024, 1024, 32, kind, dtype, conn) for kind, dtype, conn in (
        ("tile recipe", torch.uint8, 2), ("random", torch.uint8, 2), ("random", torch.uint8, 1), ("random", torch.int32, 2),
        ("sparse", torch.uint8, 2), ("all class 3", torch.uint8, 2),
    )] + [(2048, 2048, 1, "random", torch.uint8, 2)]
    for h, w, t, kind, dtype, conn in cases:
        pos = tuple(map(tuple, tiling.patch_positions(h, w)))
        lp = torch.from_numpy(labels(kind, t, len(pos))).to("cuda", dtype)
        desc, src = K._descriptors(pos, lp.device)[0], K._source_map(pos, lp.device)
        # the new kernel's scratch: border slots, then a byte per strip of four tiles
        slots = t * 4 * 32 * (-(-h // 32)) * (-(-w // 32)) + t * (-(-h // 32)) * (-(-w // 128))
        parent = [torch.empty(slots if descriptors else t * h * w, dtype=torch.int32, device="cuda"),
                  torch.empty(slots, dtype=torch.int32, device="cuda")]
        out = [torch.empty((t, 2), dtype=torch.int32, device="cuda") for _ in range(2)]
        wide = int(dtype == torch.int32)

        def side(k, fn, plan):
            return lambda: call(fn, lp.data_ptr(), wide, plan.data_ptr(), t, len(pos) * SCW * SCW, h, w, 3, conn,
                                parent[k].data_ptr(), out[k].data_ptr())

        base = side(0, base_k["count_patches"], desc if descriptors else src)
        new = side(1, new_k["count_patches"], desc)
        what = f"count_patches {t} x {h}x{w} {kind} {str(dtype)[6:]} conn {conn}"
        row = {"mask": what, "count_patches": time_pair("count_patches", base, new, (out,), what, args)}
        if args.profile:
            profile_into(row["count_patches"], "count_patches", what, base, new, args)
        rows.append(row)
        print(f"{what}: count_patches {row['count_patches']['base_ms']:.4f} -> {row['count_patches']['new_ms']:.4f} ms", flush=True)
    return rows


def overlay_masks():
    """metaseg's stitched ecDNA mask (``raw == 3``, B8a's timing input in
    chip_smoke.py) and meta_overlay's fish2_nc mask (red above
    color_sensitivity, off nuclei and chromosomes) of one synthetic FISH
    image (``chip_smoke.synthetic_overlay_rgb``, seed 0) through the demo
    weights, on the card."""
    from chip_smoke import OVERLAY_SENSITIVITY, synthetic_overlay_rgb
    from ecseg_torch.core import imgio
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.ops import tiling
    from ecseg_torch.ops.meta_post import meta_preprocess
    from ecseg_torch.ops.meta_post_gpu import meta_inference_gpu
    from ecseg_torch.pipelines import metaseg

    rgb = synthetic_overlay_rgb(np.random.default_rng(0), 2048, 2048)
    model = demo_metaseg_params(torch.Generator().manual_seed(0)).cuda().eval()
    _, patches, pos = tiling.im2patches_overlap(meta_preprocess(rgb)[..., None])
    raw = metaseg.segment_raw(model, patches, tuple(map(tuple, pos)))
    labels, _ = meta_inference_gpu(raw.clone())
    red = torch.from_numpy(imgio.u16_to_u8(rgb)[..., 0] > OVERLAY_SENSITIVITY).cuda()
    return {"ecDNA mask": raw == 3, "fish2_nc mask": red & (labels != 1) & (labels != 2)}


def count_rows(base_k, per_pixel_count, new_k, stream, args):
    """B8a rows: the base side gets an (H, W) parent array if it unites in
    device memory, else the border-slot scratch, as the new side."""
    from chip_smoke import snake, spiral
    from ecseg_torch.ops import cc_kernels as K

    rng = np.random.default_rng(4)
    cases = [(k, m, 2) for k, m in overlay_masks().items()]
    for name, m in (("random", rng.random((2048, 2048)) < 0.5), ("snake", snake(2048, 2048)), ("spiral", spiral(2048, 2048))):
        mt = torch.from_numpy(m).cuda()
        cases += [(name, mt, 2)] + ([(name, mt, 1)] if name == "random" else [])
    rows = []
    for name, mt, conn in cases:
        h, w = mt.shape
        what = f"count {name} {h}x{w} conn {conn}"
        slots = K._count_scratch(1, h, w, what)
        parent = [torch.empty(h * w if per_pixel_count else slots, dtype=torch.int32, device="cuda"),
                  torch.empty(slots, dtype=torch.int32, device="cuda")]
        out = [torch.empty(2, dtype=torch.int32, device="cuda") for _ in range(2)]

        def side(k, fn):
            def run():
                rc = fn(mt.data_ptr(), parent[k].data_ptr(), h, w, conn, out[k].data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"launch failed: CUDA error {rc}")
            return run

        base, new = side(0, base_k["count"]), side(1, new_k["count"])
        row = {"mask": what, "count": time_pair("count", base, new, (out,), what, args), "px": int(mt.sum())}
        if args.profile:
            profile_into(row["count"], "count", what, base, new, args)
        rows.append(row)
        print(f"{what} ({row['px']} px): count {row['count']['base_ms']:.4f} -> {row['count']['new_ms']:.4f} ms", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_cc_tiled: no CUDA device is available", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="ab_cc_") as tmp:
        base_k, descriptors, per_pixel_count = build_base(os.path.abspath(args.base), tmp)
        new_k = new_kernels()
        stream = torch.cuda.current_stream().cuda_stream
        seed_rng = np.random.default_rng(2)
        rows = count_rows(base_k, per_pixel_count, new_k, stream, args)
        rows += stitch_count_rows(base_k, descriptors, new_k, stream, args)
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
                row[key] = time_pair(key, base, new, res, what, args)
                if args.profile and (h, w) == (2048, 2048):
                    profile_into(row[key], key, what, base, new, args)
            rows.append(row)
            print(
                f"{what}: " + "; ".join(f"{k} {row[k]['base_ms']:.4f} -> {row[k]['new_ms']:.4f} ms" for k in runs),
                flush=True,
            )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    result = {"card": smi, "reps": args.reps, "rounds": args.rounds, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
