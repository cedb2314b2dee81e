"""Smoke test of the PyTorch/CUDA port (ecseg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises; exit code 0 only when all pass):

1. print the card's name and power limit; build the CUDA kernels from
   ``ecseg_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch twin on the card, integer
   bit-equality: B1 stitch at the 2048^2 plan (100 patches) and at 1024^2;
   B2 label (connectivity 1 and 2), B3 border flood and B4 seeded flood on
   random, snake and spiral masks at 2048^2 and at 2048x3072 (which also
   proves the port serves the banded TPU kernels' large-map contract); B5
   multiclass label, B6 multiclass flood and B9 label+flood (connectivity 1
   and 2, on the map's odd classes) on a uniformly random 4-class map, a
   column-striped class map, and a class-1 snake and spiral on class 2, at
   the same two sizes;
3. drive the main path: ``ecseg_torch.pipelines.metaseg.main`` with the
   default device on four synthetic 2048^2 uint16 DAPI images, with crafted
   default-width weights (``models/demo.py``, seeded) read through the
   ``metaseg.npz`` bridge, in the default post-processing form.  Checks:
   outputs well-formed; each kernel's launch counter rose during ``main``
   exactly as the form predicts (``PER_IMAGE_LAUNCHES``); the image with
   more than 512 nuclei went through the counted host redo; every image's
   labels equal the host oracle on the same raw canvas; a rerun gives
   byte-identical labels; the card's forward agrees with the CPU forward
   (TF32 off).  Then ``main`` again under ``ECSEG_MC_LABEL=0`` and under
   ``ECSEG_MC_MERGE=1`` on an ordinary image and the crowded one: the same
   launch-count and host-redo checks, and labels and CSV rows byte-equal to
   the default form's;
4. time each kernel at the main path's shapes beside its plain twin and its
   memory bound: the CUDA-event mean over back-to-back calls (``ms``) and
   the device-only time from one ``torch.profiler`` pass (``device_ms``);
   and one 100-patch forward at the XL widths;
5. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
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
# post-processing form -> the environment that selects it (the JAX
# package's variables) and the kernel launches of one image through ``main``
FORM_VARS = ("ECSEG_MC_LABEL", "ECSEG_MC_MERGE")
FORM_ENV = {
    "default": {},
    "per_class": {"ECSEG_MC_LABEL": "0"},
    "fused_merge": {"ECSEG_MC_MERGE": "1"},
}
PER_IMAGE_LAUNCHES = {
    "default": {"stitch": 1, "label": 3, "flood_border": 2, "flood_seeds": 2, "label_mc": 2, "flood_mc": 1, "label_flood": 0},
    "per_class": {"stitch": 1, "label": 8, "flood_border": 2, "flood_seeds": 5, "label_mc": 0, "flood_mc": 0, "label_flood": 0},
    "fused_merge": {"stitch": 1, "label": 1, "flood_border": 2, "flood_seeds": 0, "label_mc": 2, "flood_mc": 1, "label_flood": 2},
}
KERNELS = {  # wrapper key -> (B, name, source, pallas_call site, Pallas function)
    "stitch": ("B1", "stitch_labels", "ecseg_torch/csrc/stitch.cu", "ecseg_tpu/ops/cc_pallas.py:1070", "stitch_labels_pallas"),
    "label": ("B2", "label", "ecseg_torch/csrc/cc_label.cu", "ecseg_tpu/ops/cc_pallas.py:1094", "label_pallas"),
    "flood_border": ("B3", "flood_from_border", "ecseg_torch/csrc/cc_flood.cu", "ecseg_tpu/ops/cc_pallas.py:994", "flood_from_border_pallas"),
    "flood_seeds": ("B4", "flood_from_seeds", "ecseg_torch/csrc/cc_flood.cu", "ecseg_tpu/ops/cc_pallas.py:1023", "flood_from_seeds_pallas"),
    "label_mc": ("B5", "label_multiclass", "ecseg_torch/csrc/cc_label.cu", "ecseg_tpu/ops/cc_pallas.py:610", "label_multiclass_pallas"),
    "flood_mc": ("B6", "flood_multiclass", "ecseg_torch/csrc/cc_flood.cu", "ecseg_tpu/ops/cc_pallas.py:753", "flood_multiclass_pallas"),
    "label_flood": ("B9", "label_and_flood", "ecseg_torch/csrc/cc_flood.cu", "ecseg_tpu/ops/cc_pallas.py:869", "label_and_flood_pallas"),
}
# the form whose ``main`` run gives each kernel's ``launches`` (B9 runs only
# under ECSEG_MC_MERGE=1)
LAUNCHES_FROM = {key: "fused_merge" if key == "label_flood" else "default" for key in KERNELS}


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


def device_ms(fn, reps: int, tries: int = 5) -> float:
    """Mean device-only time of ``fn`` (the sum of its kernels and memsets)
    from one ``torch.profiler`` pass over ``reps`` calls after one warm-up.
    Each wrapper launches each of its device operations once per call, so a
    complete pass records every operation name exactly ``reps`` times.  A
    pass that lost records is repeated, and ``tries`` incomplete passes
    raise.  The pass traces the device only."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        per_name = Counter(e.name for e in ops)
        if per_name and set(per_name.values()) == {reps}:
            return sum(e.time_range.elapsed_us() for e in ops) / 1e3 / reps
        print(f"torch.profiler pass incomplete ({dict(per_name)} over {reps} calls); profiling again", flush=True)
    raise RuntimeError(f"chip_smoke check failed: {tries} torch.profiler passes lost device records")


@contextlib.contextmanager
def post_form(form: str):
    """Set the environment of one post-processing form; restore it after."""
    saved = {k: os.environ.pop(k, None) for k in FORM_VARS}
    os.environ.update(FORM_ENV[form])
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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
        """``got``/``want``: a tensor, or a tuple of tensors (B9)."""
        if isinstance(got, tuple):
            for g, w_ in zip(got, want, strict=True):
                self.compare(key, g, w_, what)
            return
        check(got.shape == want.shape, f"{KERNELS[key][1]} shape {tuple(got.shape)} != plain twin's {tuple(want.shape)} on {what}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        self.max[key] = max(self.max[key], err)
        check(err == 0, f"{KERNELS[key][1]} != plain twin on {what} (max |err| {err})")


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


def class_maps(rng, h, w):
    """uint8 class maps (0..3) for B5/B6/B9."""
    uniform = rng.integers(0, 4, (h, w)).astype(np.uint8)
    stripes = rng.integers(0, 4, (h, w)).astype(np.uint8)
    stripes[:, ::2] = 3  # maximal fragmentation of same-class runs
    return {
        "uniform": uniform,
        "stripes": stripes,
        "snake": np.where(snake(h, w), 1, 2).astype(np.uint8),
        "spiral": np.where(spiral(h, w), 1, 2).astype(np.uint8),
    }


def phase_multiclass_kernels(K, rng, dev, errors, sizes=((2048, 2048), (2048, 3072))):
    for h, w in sizes:
        for name, cls in class_maps(rng, h, w).items():
            ct = torch.from_numpy(cls).to(dev)
            seeds = torch.from_numpy(rng.random((h, w)) < 0.001).to(dev)  # some on class 0
            odd = ct % 2 == 1  # B9's mask: classes 1 and 3
            what = f"{name} class map {h}x{w}"
            errors.compare("label_mc", K.label_multiclass(ct), K.label_multiclass_plain(ct), what)
            errors.compare("flood_mc", K.flood_multiclass(ct, seeds), K.flood_multiclass_plain(ct, seeds), what)
            for conn in (1, 2):
                errors.compare("label_flood", K.label_and_flood(odd, seeds, conn), K.label_and_flood_plain(odd, seeds, conn), f"{what} conn {conn}")
            print(
                f"B5/B6/B9 {what}: match plain; B5 {cuda_ms(lambda: K.label_multiclass(ct), 5):.3f} ms, "
                f"B6 {cuda_ms(lambda: K.flood_multiclass(ct, seeds), 5):.3f} ms, "
                f"B9 conn 2 {cuda_ms(lambda: K.label_and_flood(odd, seeds, 2), 5):.3f} ms",
                flush=True,
            )


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


def run_main(folder, form, n_images):
    """``main`` on ``folder`` in one post-processing form, with every launch
    counter, the fallback counts and the stage tracer set to 0 just before
    and read just after; checks the launches and the one host redo (each
    folder holds the crowded image).  Returns (launches, stages, wall s)."""
    from ecseg_torch.core.config import Config
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.pipelines import metaseg
    from ecseg_torch.runtime import fallbacks, trace

    tracer = trace.tracer()
    with post_form(form):
        fallbacks.reset()
        tracer.reset()
        K.reset_launches()
        t0 = time.perf_counter()
        check(metaseg.main(config=Config(raw={"metaseg": {"inpath": folder}})) == 0, f"metaseg.main ({form}) did not return 0")
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        stages = tracer.times()
    print(f"main path, {form} form: {n_images} images of {SIZE}x{SIZE} in {wall:.3f} s; launches {launches}", flush=True)
    for key, n in PER_IMAGE_LAUNCHES[form].items():
        check(launches[key] == n * n_images, f"{form} form: {key} launched {launches[key]} times, expected {n * n_images}")
    check(fallbacks.counts() == {fallbacks.META_POST_OK: 1}, f"{form} form: fallbacks {fallbacks.counts()} != one host redo")
    for name, ts in sorted(stages.items()):
        print(f"  stage {name:22s} n={len(ts)} total {sum(ts):.4f} s; per run ms: " + " ".join(f"{1e3 * t:.2f}" for t in ts), flush=True)
    return launches, stages, wall


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


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
    from ecseg_torch.runtime import trace

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

        launches, stages, wall = run_main(folder, "default", len(names))
        results["launches"] = {"default": launches}
        results["stages"] = {"default": stages}
        results["main_wall_s"] = {"default": wall}

        with open(os.path.join(folder, "ec_quantification.csv")) as f:
            lines = f.read().splitlines()
        check(lines[0] == "image name,# of ec" and len(lines) == 5, f"CSV rows: {lines}")
        counts = {ln.rsplit(",", 1)[0]: int(ln.rsplit(",", 1)[1]) for ln in lines[1:]}
        check(sorted(counts) == names, f"CSV names {sorted(counts)}")

        model = metaseg.load_model(device=dev)
        oks = {}
        with post_form("default"):
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
        with post_form("default"):
            for _ in range(2):
                check(metaseg.main(config=Config(raw={"metaseg": {"inpath": again}})) == 0, "rerun failed")
                runs.append(read_bytes(os.path.join(again, "labels", "img0.npy")))
        runs.append(read_bytes(os.path.join(folder, "labels", "img0.npy")))
        check(runs[0] == runs[1] == runs[2], "labels/*.npy bytes differ between runs")

        # the other two forms on an ordinary image and the crowded one: the
        # same labels and CSV rows as the default form, byte for byte
        pair = ["img0.tif", "img2.tif"]
        for form in ("per_class", "fused_merge"):
            sub = os.path.join(work, form)
            os.makedirs(sub)
            for name in pair:
                shutil.copy(os.path.join(folder, name), sub)
            launches_f, stages_f, wall_f = run_main(sub, form, len(pair))
            results["launches"][form] = launches_f
            results["stages"][form] = stages_f
            results["main_wall_s"][form] = wall_f
            with open(os.path.join(sub, "ec_quantification.csv")) as f:
                rows = f.read().splitlines()
            want_rows = [lines[0]] + [ln for ln in lines[1:] if ln.rsplit(",", 1)[0] in pair]
            check(rows == want_rows, f"{form} form: CSV rows {rows} != default form's {want_rows}")
            for name in pair:
                npy = os.path.join("labels", name[:-4] + ".npy")
                check(read_bytes(os.path.join(sub, npy)) == read_bytes(os.path.join(folder, npy)), f"{form} form: {npy} bytes != default form's")
            print(f"{form} form: labels and CSV rows byte-equal to the default form's on {pair}", flush=True)
        tracer.enabled = False

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

        # the main path's own inputs for the kernel timings (image 0)
        with torch.no_grad():
            lp = tiling.patch_labels(model(torch.from_numpy(patches).to(dev)))
        results["inputs"] = (lp, pos, K.stitch_labels(lp, pos))
    finally:
        tracer.enabled = False
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def phase_timings(K, dev, errors, results):
    lp, pos, raw = results.pop("inputs")
    hw = raw.numel()
    nuc = raw == 1
    bg = ~nuc
    fg = raw != 0
    seeds = raw == 3
    cls8 = raw.to(torch.uint8)
    # bytes each function must move: inputs read once, outputs written once;
    # the stitch reads only the patch bytes that land on the canvas.
    # No single PyTorch call computes any of them (library_ms null).
    landed = int((K._source_map(pos, dev) >= 0).sum())
    cases = {
        "stitch": (lambda: K.stitch_labels(lp, pos), lambda: K.stitch_plain(lp, pos), landed + 4 * hw),
        "label": (lambda: K.label(nuc, 2), lambda: K.label_plain(nuc, 2), hw + 4 * hw),
        "flood_border": (lambda: K.flood_from_border(bg), lambda: K.flood_from_border_plain(bg), 2 * hw),
        "flood_seeds": (lambda: K.flood_from_seeds(fg, seeds, 2), lambda: K.flood_from_seeds_plain(fg, seeds, 2), 3 * hw),
        "label_mc": (lambda: K.label_multiclass(cls8), lambda: K.label_multiclass_plain(cls8), hw + 4 * hw),
        "flood_mc": (lambda: K.flood_multiclass(cls8, seeds), lambda: K.flood_multiclass_plain(cls8, seeds), 3 * hw),
        "label_flood": (lambda: K.label_and_flood(fg, nuc, 2), lambda: K.label_and_flood_plain(fg, nuc, 2), 2 * hw + 5 * hw),
    }
    rows = []
    for key, (kern, plain, nbytes) in cases.items():
        errors.compare(key, kern(), plain(), "the main path's image-0 input")
        ms = cuda_ms(kern, 20)
        dev_ms = device_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        b, name, source, site, fn = KERNELS[key]
        launches = results["launches"][LAUNCHES_FROM[key]][key]
        check(launches > 0, f"{b} {name} was not launched by main ({LAUNCHES_FROM[key]} form)")
        rows.append({
            "name": name, "b": b, "route": "cuda", "source": source, "replaces": site,
            "pallas_function": fn, "launches": launches, "launches_form": LAUNCHES_FROM[key],
            "max_abs_err": errors.max[key], "matches_plain": errors.max[key] == 0,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": None,
        })
        print(f"{b} {name} at main-path shapes: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.3f} ms, bound {rows[-1]['bound_ms']:.4f} ms", flush=True)
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
    # its own generator, so the main path's images do not depend on it
    phase_multiclass_kernels(K, np.random.default_rng(args.seed + 1), dev, errors)
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
