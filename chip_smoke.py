"""Smoke test of the PyTorch/CUDA port (ecseg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises; exit code 0 only when all pass):

1. print the card's name and power limit; build the CUDA kernels from
   ``ecseg_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch twin on the card, integer
   bit-equality: B1 stitch at the 2048^2 plan (100 patches) and at 1024^2;
   B2 label (connectivity 1 and 2), B3 border flood and B4 seeded flood on
   random, snake and spiral masks at 2048^2 and at 2048x3072 (which also
   proves the port serves the banded TPU kernels' large-map contract);
3. drive the main path: ``ecseg_torch.pipelines.metaseg.main`` with the
   default device on four synthetic 2048^2 uint16 DAPI images, with crafted
   default-width weights (``models/demo.py``, seeded) read through the
   ``metaseg.npz`` bridge.  Checks: outputs well-formed; each kernel's launch
   counter rose during ``main`` exactly as the per-class chain predicts
   (per image B1 x1, B2 x8, B3 x2, B4 x5); the image with more than 512
   nuclei went through the counted host redo; every image's labels equal the
   host oracle on the same raw canvas; a rerun gives byte-identical labels;
   the card's forward agrees with the CPU forward (TF32 off);
4. time each kernel at the main path's shapes (CUDA events) beside its plain
   twin and its memory bound, and one 100-patch forward at the XL widths;
5. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SIZE = 2048  # the main path's image side, the reference's image size
PER_IMAGE_LAUNCHES = {"stitch": 1, "label": 8, "flood_border": 2, "flood_seeds": 5}
KERNELS = {  # wrapper key -> (B, name, source, pallas_call site, Pallas function)
    "stitch": ("B1", "stitch_labels", "ecseg_torch/csrc/stitch.cu", "ecseg_tpu/ops/cc_pallas.py:1070", "stitch_labels_pallas"),
    "label": ("B2", "label", "ecseg_torch/csrc/cc_label.cu", "ecseg_tpu/ops/cc_pallas.py:1094", "label_pallas"),
    "flood_border": ("B3", "flood_from_border", "ecseg_torch/csrc/cc_flood.cu", "ecseg_tpu/ops/cc_pallas.py:994", "flood_from_border_pallas"),
    "flood_seeds": ("B4", "flood_from_seeds", "ecseg_torch/csrc/cc_flood.cu", "ecseg_tpu/ops/cc_pallas.py:1023", "flood_from_seeds_pallas"),
}


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches after one warm-up."""
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


def snake(h, w, pitch=2):
    m = np.zeros((h, w), bool)
    for i, r in enumerate(range(0, h, pitch)):
        m[r, :] = True
        if r + pitch < h:
            m[r : r + pitch + 1, -1 if i % 2 == 0 else 0] = True
    return m


def spiral(h, w, pitch=2):
    m = np.zeros((h, w), bool)
    top, left, bot, right = 0, 0, h - 1, w - 1
    while top <= bot and left <= right:
        m[top, left : right + 1] = True
        m[top : bot + 1, right] = True
        if bot - top >= pitch:
            m[bot, left : right + 1] = True
        if right - left >= pitch and top + pitch <= bot:
            m[top + pitch : bot + 1, left] = True
        top, left, bot, right = top + pitch, left + pitch, bot - pitch, right - pitch
        if top <= bot and left <= right:
            m[top - pitch + 1 : top + 1, left] = True
    return m


class Errors:
    """Largest |kernel - twin| seen per kernel (0 means bit-equal)."""

    def __init__(self):
        self.max = {k: 0 for k in KERNELS}

    def compare(self, key, got, want, what):
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        self.max[key] = max(self.max[key], err)
        check(got.shape == want.shape and err == 0, f"{KERNELS[key][1]} != plain twin on {what} (max |err| {err})")


def phase_kernels(K, tiling, rng, dev, errors):
    for h, w in [(2048, 2048), (1024, 1024)]:
        pos = tuple(map(tuple, tiling.patch_positions(h, w)))
        lp = torch.from_numpy(rng.integers(0, 4, (len(pos), 256, 256)).astype(np.uint8)).to(dev)
        errors.compare("stitch", K.stitch_labels(lp, pos), K.stitch_plain(lp, pos), f"{h}x{w} ({len(pos)} patches)")
        print(f"B1 stitch {h}x{w} patches={len(pos)}: matches plain; kernel {cuda_ms(lambda: K.stitch_labels(lp, pos), 20):.4f} ms", flush=True)
    for h, w in [(2048, 2048), (2048, 3072)]:
        for name, m in [("random", rng.random((h, w)) < 0.5), ("snake", snake(h, w)), ("spiral", spiral(h, w))]:
            mt = torch.from_numpy(m).to(dev)
            seeds = torch.from_numpy(rng.random((h, w)) < 0.001).to(dev)
            what = f"{name} {h}x{w}"
            for conn in (1, 2):
                t0 = time.perf_counter()
                want = K.label_plain(mt, conn)
                torch.cuda.synchronize()
                plain_ms = 1e3 * (time.perf_counter() - t0)
                errors.compare("label", K.label(mt, conn), want, f"{what} conn {conn}")
                errors.compare("flood_seeds", K.flood_from_seeds(mt, seeds, conn), K.flood_from_seeds_plain(mt, seeds, conn), f"{what} conn {conn}")
                print(f"B2 label {what} conn {conn}: matches plain; kernel {cuda_ms(lambda: K.label(mt, conn), 5):.3f} ms, plain {plain_ms:.1f} ms", flush=True)
            errors.compare("flood_border", K.flood_from_border(mt), K.flood_from_border_plain(mt), what)
            print(f"B3/B4 floods {what}: match plain; B3 kernel {cuda_ms(lambda: K.flood_from_border(mt), 5):.3f} ms", flush=True)


def synthetic_dapi(rng, h, w, crowded):
    """uint16 DAPI-like image: noisy background, nucleus discs, hundreds of
    small bright ecDNA dots; ``crowded`` adds a grid of >512 small nuclei."""
    img = (rng.random((h, w)) * 8000).astype(np.uint16)
    yy, xx = np.ogrid[:h, :w]
    for _ in range(int(rng.integers(6, 12))):
        cy, cx, r = rng.integers(150, h - 150), rng.integers(150, w - 150), rng.integers(50, 120)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 33000
    for _ in range(int(rng.integers(300, 600))):
        y, x = rng.integers(2, h - 8), rng.integers(2, w - 8)
        img[y : y + int(rng.integers(2, 6)), x : x + int(rng.integers(2, 6))] = 60000
    if crowded:  # 27 x 27 = 729 nuclei of 3x3 px on a cleared square
        img[90:300, 90:300] = (rng.random((210, 210)) * 8000).astype(np.uint16)
        for y in range(100, 100 + 27 * 7, 7):
            for x in range(100, 100 + 27 * 7, 7):
                img[y : y + 3, x : x + 3] = 33000
    return img


def phase_main_path(args, rng, dev, errors, results):
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.models.weights import params_to_numpy, save_npz
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import meta_post_gpu as mpg
    from ecseg_torch.ops import tiling
    from ecseg_torch.ops.cc import count_cc
    from ecseg_torch.ops.meta_post import meta_inference
    from ecseg_torch.pipelines import metaseg
    from ecseg_torch.runtime import fallbacks, trace

    tracer = trace.tracer()
    tracer.enabled = True
    work = tempfile.mkdtemp(prefix="ecseg_smoke_")
    cwd = os.getcwd()
    try:
        os.chdir(work)  # load_model reads models/metaseg.npz from here
        model = demo_metaseg_params(torch.Generator().manual_seed(args.seed))
        save_npz(os.path.join(work, "models", "metaseg.npz"), params_to_numpy(model))
        folder = os.path.join(work, "imgs")
        os.makedirs(folder)
        names = [f"img{k}.tif" for k in range(4)]
        for k, name in enumerate(names):
            imgio.write_tiff(os.path.join(folder, name), synthetic_dapi(rng, SIZE, SIZE, crowded=k == 2))
        cfg = Config(raw={"metaseg": {"inpath": folder}})

        fallbacks.reset()
        tracer.reset()
        K.reset_launches()
        t0 = time.perf_counter()
        check(metaseg.main(config=cfg) == 0, "metaseg.main did not return 0")
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        stages = tracer.times()
        tracer.enabled = False
        print(f"main path: {len(names)} images of {SIZE}x{SIZE} in {wall:.3f} s; launches {launches}", flush=True)
        for key, n in PER_IMAGE_LAUNCHES.items():
            check(launches[key] == n * len(names), f"{key} launched {launches[key]} times, expected {n * len(names)}")
        check(fallbacks.counts() == {fallbacks.META_POST_OK: 1}, f"fallbacks {fallbacks.counts()} != one host redo")
        for name, ts in sorted(stages.items()):
            print(f"  stage {name:22s} n={len(ts)} total {sum(ts):.4f} s; per run ms: " + " ".join(f"{1e3 * t:.2f}" for t in ts), flush=True)

        with open(os.path.join(folder, "ec_quantification.csv")) as f:
            lines = f.read().splitlines()
        check(lines[0] == "image name,# of ec" and len(lines) == 5, f"CSV rows: {lines}")
        counts = {ln.rsplit(",", 1)[0]: int(ln.rsplit(",", 1)[1]) for ln in lines[1:]}
        check(sorted(counts) == names, f"CSV names {sorted(counts)}")

        model = metaseg.load_model(device=dev)
        oks = {}
        for name in names:
            out = np.load(os.path.join(folder, "labels", name[:-4] + ".npy"))
            check(out.dtype == np.int64 and out.shape == (SIZE, SIZE), f"{name}: npy {out.dtype} {out.shape}")
            check(set(np.unique(out)) <= {0, 1, 2, 3}, f"{name}: labels outside 0..3")
            patches, pos = metaseg._prepare_image(os.path.join(folder, name), save_dapi=False)
            raw = metaseg.segment_raw(model, patches, pos)
            _, ok = mpg.meta_inference_gpu(raw)
            oks[name] = bool(ok)
            want = meta_inference(raw.cpu().numpy().astype(np.int64))
            check(np.array_equal(out, want), f"{name}: labels != host oracle on the raw canvas")
            check(counts[name] == count_cc(want == 3)[0], f"{name}: ec count")
        check(oks == {n: n != "img2.tif" for n in names}, f"device ok flags {oks}")
        print(f"main path outputs equal the host oracle; ok flags {oks}; ec counts {counts}", flush=True)

        # byte-identical rerun of one image
        again = os.path.join(work, "again")
        os.makedirs(again)
        shutil.copy(os.path.join(folder, names[0]), again)
        runs = []
        for _ in range(2):
            check(metaseg.main(config=Config(raw={"metaseg": {"inpath": again}})) == 0, "rerun failed")
            with open(os.path.join(again, "labels", "img0.npy"), "rb") as f:
                runs.append(f.read())
        with open(os.path.join(folder, "labels", "img0.npy"), "rb") as f:
            runs.append(f.read())
        check(runs[0] == runs[1] == runs[2], "labels/*.npy bytes differ between runs")

        # the card's forward against the CPU forward: TF32 off, one tolerance
        patches, pos = metaseg._prepare_image(os.path.join(folder, names[0]), save_dapi=False)
        x = torch.from_numpy(patches[:2])
        with torch.no_grad():
            p_gpu = model(x.to(dev)).cpu()
            p_cpu = model.cpu()(x)
        model.to(dev)
        fwd_err = float((p_gpu - p_cpu).abs().max())
        check(torch.isfinite(p_gpu).all() and fwd_err < 2e-5, f"card vs CPU forward max |diff| {fwd_err}")
        print(f"forward card vs CPU on 2 patches: max |diff| {fwd_err:.3g} (< 2e-5)", flush=True)

        results["launches"] = launches
        results["stages"] = stages
        results["main_wall_s"] = wall
        # the main path's own inputs for the kernel timings (image 0)
        with torch.no_grad():
            lp = tiling.patch_labels(model(torch.from_numpy(patches).to(dev)))
        results["inputs"] = (lp, pos, K.stitch_labels(lp, pos))
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def phase_timings(K, dev, errors, results):
    lp, pos, raw = results.pop("inputs")
    hw = raw.numel()
    nuc = raw == 1
    bg = ~nuc
    fg = raw != 0
    seeds = raw == 3
    # bytes each function must move: inputs read once, output written once;
    # the stitch reads only the patch bytes that land on the canvas.
    # No single PyTorch call computes any of the four (library_ms null).
    landed = int((K._source_map(pos, dev) >= 0).sum())
    cases = {
        "stitch": (lambda: K.stitch_labels(lp, pos), lambda: K.stitch_plain(lp, pos), landed + 4 * hw),
        "label": (lambda: K.label(nuc, 2), lambda: K.label_plain(nuc, 2), hw + 4 * hw),
        "flood_border": (lambda: K.flood_from_border(bg), lambda: K.flood_from_border_plain(bg), 2 * hw),
        "flood_seeds": (lambda: K.flood_from_seeds(fg, seeds, 2), lambda: K.flood_from_seeds_plain(fg, seeds, 2), 3 * hw),
    }
    rows = []
    for key, (kern, plain, nbytes) in cases.items():
        errors.compare(key, kern(), plain(), "the main path's image-0 input")
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        b, name, source, site, fn = KERNELS[key]
        rows.append({
            "name": name, "b": b, "route": "cuda", "source": source, "replaces": site,
            "pallas_function": fn, "launches": results["launches"][key],
            "max_abs_err": errors.max[key], "matches_plain": errors.max[key] == 0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": None,
        })
        print(f"{b} {name} at main-path shapes: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {rows[-1]['bound_ms']:.4f} ms", flush=True)
    return rows


def phase_xl_forward(rng, dev):
    from ecseg_torch.models.metaseg_unet import BOTTLENECK_XL, ENC_WIDTHS_XL, MetasegUNet

    model = MetasegUNet(ENC_WIDTHS_XL, BOTTLENECK_XL, generator=torch.Generator().manual_seed(1)).to(dev).eval()
    x = torch.from_numpy((rng.random((100, 256, 256, 1)) * 255).astype(np.uint8)).to(dev)
    with torch.no_grad():
        ms = cuda_ms(lambda: model(x), 2)
        probs = model(x)
    check(bool(torch.isfinite(probs).all()) and probs.shape == (100, 256, 256, 4), "XL forward output")
    print(f"XL forward (widths {ENC_WIDTHS_XL}/{BOTTLENECK_XL}), 100 patches: {ms:.1f} ms", flush=True)
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from ecseg_torch import _build
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import tiling

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built the CUDA kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    errors = Errors()
    results = {}
    phase_kernels(K, tiling, rng, dev, errors)
    phase_main_path(args, rng, dev, errors, results)
    rows = phase_timings(K, dev, errors, results)
    xl_ms = phase_xl_forward(rng, dev)
    print(json.dumps({"stages_s": results["stages"], "main_wall_s": results["main_wall_s"], "xl_forward_100_ms": xl_ms, "card": smi}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
