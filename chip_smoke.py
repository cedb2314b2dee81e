"""Smoke test of the PyTorch/CUDA port (ecseg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises; exit code 0 only when all pass):

1. print the card's name and power limit; build the CUDA kernels from
   ``ecseg_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch twin on the card, integer
   bit-equality: B1 stitch at the 2048^2 plan (100 patches) and at 1024^2;
   B2 label (connectivity 1 and 2), B3 border flood and B4 seeded flood on
   random, snake and spiral masks at 2048^2 and at 2048x3072 (which also
   proves the port serves the banded TPU kernels' large-map contract), with
   B2's and B3's times beside those of the three-pass form they replaced;
   B2 (connectivity 1 and 2) and B3 (on each mask and its complement) on
   the tile-edge masks of ``tests/_masks.py`` (``tile_masks``: checkerboard,
   diagonals through tile corners, staircase, frames on the 32 and 64 grids,
   a giant background with holes, full, empty) at 2048^2 and at the ragged
   sizes 2047x2049, 33x4097, 1x2048 and 2048x1; B5
   multiclass label, B6 multiclass flood and B9 label+flood (connectivity 1
   and 2, on the map's odd classes) on a uniformly random 4-class map, a
   column-striped class map, and a class-1 snake and spiral on class 2, at
   the same two sizes; B8a count on the random, snake and spiral masks at
   both sizes (connectivity 1 and 2); B8b stitch+count at the 1024^2 (two
   tiles in one launch) and 2048^2 plans for class_id 0-3, also against
   ``stitch_plain`` + ``==`` + the B8a twin; B10 fused decoder tail on 8
   patches at both widths (c1/c2 64/32 and 128/64), bit-equal on
   integer-valued float32 (the CUDA-core form) and bf16 (the tensor-core
   form), >= 99.99 % label agreement on random bf16; B11 transpose conv at
   the decoder's shapes for 100 patches (half-width up2-up4, XL up1-up4),
   bit-equal on integer-valued float32 and bf16, within one bf16 rounding
   on random bf16;
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
5. drive the tile-count path (``ecseg_torch.pipelines.tile_count.run``,
   bench.py's per-tile bf16 ecDNA count) with the default device at the
   default widths (32 tiles) and the XL widths (8 tiles), unfused and
   fused-tail.  Checks: every tile's count > 10; counts and pixels equal
   across the variants and to the twin composition on the same patch
   labels; the launches of one run are one B8b (and one B10 when fused),
   nothing else; the card's bf16 probabilities within 2e-3 of the CPU
   float32 forward on 2 patches.  Then the path's ms per tile, and B8a,
   B8b, B10 (beside the cuDNN chain it replaces, at both widths) and B11
   (beside cuDNN's transpose conv + ReLU at every decoder level) timed as
   in 4, with bounds from bytes and operations, achieved TFLOP/s and the
   share of the bound; each timed row's profiler pass must show the
   wrapper's own kernel by name, and a pass whose device sum differs from
   the CUDA-event mean by more than 25 % is repeated; B8a, B8b and B10
   bit-equal to their twins on the timed inputs, B10 on the whole level-1
   concat of both widths' paths (800 and 200 patches);
6. print ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
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
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (the timed B10/B11 rows are bf16)
SIZE = 2048  # the main path's image side, the reference's image size
# post-processing form -> the environment that selects it (the JAX
# package's variables) and the kernel launches of one image through ``main``
FORM_VARS = ("ECSEG_MC_LABEL", "ECSEG_MC_MERGE")
FORM_ENV = {
    "default": {},
    "per_class": {"ECSEG_MC_LABEL": "0"},
    "fused_merge": {"ECSEG_MC_MERGE": "1"},
}
# the tile-count path's kernels (and B11) never run on the metaseg path
_NOT_ON_METASEG = {"count": 0, "count_patches": 0, "fused_tail": 0, "convt": 0}
PER_IMAGE_LAUNCHES = {
    "default": {"stitch": 1, "label": 3, "flood_border": 2, "flood_seeds": 2, "label_mc": 2, "flood_mc": 1, "label_flood": 0, **_NOT_ON_METASEG},
    "per_class": {"stitch": 1, "label": 8, "flood_border": 2, "flood_seeds": 5, "label_mc": 0, "flood_mc": 0, "label_flood": 0, **_NOT_ON_METASEG},
    "fused_merge": {"stitch": 1, "label": 1, "flood_border": 2, "flood_seeds": 0, "label_mc": 2, "flood_mc": 1, "label_flood": 2, **_NOT_ON_METASEG},
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
TILE_KERNELS = {  # the tile-count path's kernels and B11, as KERNELS
    "count": ("B8a", "count_components", "ecseg_torch/csrc/cc_count.cu", "ecseg_tpu/ops/cc_pallas.py:346", "count_cc_pallas"),
    "count_patches": ("B8b", "count_from_patches", "ecseg_torch/csrc/cc_count.cu", "ecseg_tpu/ops/cc_pallas.py:401", "count_cc_from_patches"),
    "fused_tail": ("B10", "fused_dec1_head", "ecseg_torch/csrc/fused_tail.cu", "ecseg_tpu/ops/fused_tail.py:195", "fused_dec1_head"),
    "convt": ("B11", "conv2d_transpose_packed", "ecseg_torch/csrc/convt.cu", "ecseg_tpu/ops/convt_pallas.py:157", "conv2d_transpose_packed"),
}
ALL_KERNELS = {**KERNELS, **TILE_KERNELS}
# the device kernel each timed tile-path row must show in its profiler pass
# (the bf16 forms of B10 and B11; B8's counting pass)
KERNEL_NAMES = {"count": "count_tiles", "count_patches": "count_tiles", "fused_tail": "fused_tail_mma", "convt": "convt_mma"}
TAIL_WIDTHS = {"default": (64, 32), "xl": (128, 64)}  # B10's (c1, c2) per arch
CONVT_SHAPES = {  # B11 at the decoder's transpose convs, 100 patches
    "half up4": (100, 16, 16, 512, 256),
    "half up3": (100, 32, 32, 256, 128),
    "half up2": (100, 64, 64, 128, 64),
    "xl up4": (100, 16, 16, 1024, 512),
    "xl up3": (100, 32, 32, 512, 256),
    "xl up2": (100, 64, 64, 256, 128),
    "xl up1": (100, 128, 128, 128, 64),
}
CONVT_TIMED = "xl up1"  # the shape of B11's timing row
COUNT_SIZES = ((2048, 2048), (2048, 3072))  # B8a's stress masks
TILE_SIZES = ((2048, 2048), (2047, 2049), (33, 4097), (1, 2048), (2048, 1))  # B2/B3 on the tile-edge masks
# B2's and B3's kernel ms on phase 2's masks in the three-pass form that the
# tiled union-find replaced (this script before the change, on an NVIDIA
# H100 80GB HBM3 at 700.00 W): (kernel, mask, connectivity) -> ms
THREE_PASS_MS = {
    ("label", "random 2048x2048", 1): 0.206, ("label", "random 2048x2048", 2): 1.248,
    ("label", "snake 2048x2048", 1): 1.139, ("label", "snake 2048x2048", 2): 1.320,
    ("label", "spiral 2048x2048", 1): 0.912, ("label", "spiral 2048x2048", 2): 1.035,
    ("label", "random 2048x3072", 1): 0.315, ("label", "random 2048x3072", 2): 1.831,
    ("label", "snake 2048x3072", 1): 1.591, ("label", "snake 2048x3072", 2): 1.886,
    ("label", "spiral 2048x3072", 1): 1.160, ("label", "spiral 2048x3072", 2): 1.587,
    ("flood_border", "random 2048x2048", 1): 0.238, ("flood_border", "snake 2048x2048", 1): 1.143,
    ("flood_border", "spiral 2048x2048", 1): 0.931, ("flood_border", "random 2048x3072", 1): 0.359,
    ("flood_border", "snake 2048x3072", 1): 1.326, ("flood_border", "spiral 2048x3072", 1): 1.024,
}
REDESIGNED = {"label", "flood_border"}  # the kernels on the tiled union-find
COUNT_PLANS = ((1024, 1024, 2), (2048, 2048, 1))  # B8b's (h, w, tiles)
FORWARD_TOL = 2e-3  # bf16 card vs float32 CPU probabilities, tile-count weights (the CPU test's PROB_ATOL)
TAIL_AGREEMENT = 0.9999  # B10 vs its twin on random bf16: labels that must agree


def tile_path_launches(fused_tail: bool):
    """Kernel launches of one ``tile_count.run``: one B8b over all tiles,
    one B10 when fused, nothing else."""
    want = {key: 0 for key in ALL_KERNELS}
    want["count_patches"] = 1
    want["fused_tail"] = int(fused_tail)
    return want


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


def device_ms(fn, reps: int, tries: int = 5, kernel: str | None = None, event_ms: float | None = None):
    """Mean device-only time of ``fn`` (the sum of its kernels and memsets)
    from one ``torch.profiler`` pass over ``reps`` calls after one warm-up.
    Each wrapper launches the same device operations on every call, so a
    complete pass records every operation name ``reps`` times as often as
    one profiled call does.  A pass that lost records is repeated, and
    ``tries`` incomplete passes raise.  The pass traces the device only.

    With ``kernel`` (a substring of the wrapper's own kernel's name) the
    pass must have recorded that kernel, not only the wrapper's weight
    casts and copies; returns (device ms, that kernel's device ms).  With
    ``event_ms`` (the CUDA-event mean of the same calls) a pass whose
    device sum differs from it by more than 25 % is repeated too, and the
    last one is kept, with a line that gives both numbers."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    def names(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the trace often loses the first kernel of its window: let that
            # be a spin kernel, which is left out of the sums
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = [
            e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name
        ]
        return ops, Counter(e.name for e in ops)

    fn()
    torch.cuda.synchronize()
    done = None
    for _ in range(tries):
        per_call = names(1)[1]
        ops, per_name = names(reps)
        if not (per_call and per_name == Counter({k: reps * v for k, v in per_call.items()})):
            print(f"torch.profiler pass incomplete ({dict(per_name)} over {reps} calls, {dict(per_call)} in one); profiling again", flush=True)
            continue
        total = sum(e.time_range.elapsed_us() for e in ops) / 1e3 / reps
        if kernel is None:
            return total
        own = [e for e in ops if kernel in e.name]
        check(own, f"the profiler recorded no kernel named *{kernel}* among {sorted(per_name)}")
        done = (total, sum(e.time_range.elapsed_us() for e in own) / 1e3 / reps)
        if event_ms is None or abs(total - event_ms) <= 0.25 * event_ms:
            return done
        print(f"device sum {total:.4f} ms vs CUDA-event mean {event_ms:.4f} ms differ by more than 25 %; profiling again", flush=True)
    if done is not None:
        print(f"device sum {done[0]:.4f} ms (kernel {done[1]:.4f} ms) and CUDA-event mean {event_ms:.4f} ms still differ after {tries} passes", flush=True)
        return done
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
        self.max = {k: 0 for k in ALL_KERNELS}

    def note(self, key, err):
        self.max[key] = max(self.max[key], err)

    def compare(self, key, got, want, what):
        """``got``/``want``: a tensor, or a tuple of tensors (B8, B9)."""
        if isinstance(got, tuple):
            for g, w_ in zip(got, want, strict=True):
                self.compare(key, g, w_, what)
            return
        check(got.shape == want.shape, f"{ALL_KERNELS[key][1]} shape {tuple(got.shape)} != plain twin's {tuple(want.shape)} on {what}")
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        self.note(key, err)
        check(err == 0, f"{ALL_KERNELS[key][1]} != plain twin on {what} (max |err| {err})")


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
                print(
                    f"B2 label {what} conn {conn}: matches plain; kernel {cuda_ms(lambda: K.label(mt, conn), 5):.3f} ms "
                    f"(three-pass {THREE_PASS_MS['label', what, conn]:.3f} ms), plain {plain_ms:.1f} ms",
                    flush=True,
                )
            errors.compare("flood_border", K.flood_from_border(mt), K.flood_from_border_plain(mt), what)
            print(
                f"B3/B4 floods {what}: match plain; B3 kernel {cuda_ms(lambda: K.flood_from_border(mt), 5):.3f} ms "
                f"(three-pass {THREE_PASS_MS['flood_border', what, 1]:.3f} ms)",
                flush=True,
            )


def phase_tile_masks(K, dev, errors):
    """B2 (connectivity 1 and 2) and B3 (on each mask and its complement)
    bit-equal to their twins on the tile-edge masks at every ``TILE_SIZES``
    size; times at 2048^2."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _masks import tile_masks

    for h, w in TILE_SIZES:
        for name, m in tile_masks(h, w).items():
            mt = torch.from_numpy(m).to(dev)
            what = f"tile mask {name} {h}x{w}"
            for conn in (1, 2):
                errors.compare("label", K.label(mt, conn), K.label_plain(mt, conn), f"{what} conn {conn}")
            for t, side in ((mt, ""), (~mt, " complement")):
                errors.compare("flood_border", K.flood_from_border(t), K.flood_from_border_plain(t), what + side)
            if (h, w) == TILE_SIZES[0]:
                inv = ~mt
                print(
                    f"B2/B3 {what}: match plain; B2 conn 1 {cuda_ms(lambda: K.label(mt, 1), 5):.4f} ms, "
                    f"conn 2 {cuda_ms(lambda: K.label(mt, 2), 5):.4f} ms; B3 {cuda_ms(lambda: K.flood_from_border(mt), 5):.4f} ms, "
                    f"complement {cuda_ms(lambda: K.flood_from_border(inv), 5):.4f} ms",
                    flush=True,
                )
        print(f"B2/B3 tile-edge masks {h}x{w}: all match plain", flush=True)


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
    results["ec_mask"] = raw == 3  # B8a's timing input (tile phase)
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
        if key in REDESIGNED:
            rows[-1]["redesigned"] = "tiled union-find in shared memory"
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


def phase_count_kernels(K, tiling, rng, dev, errors):
    """B8a on the stress masks; B8b on random class labels at the 1024^2
    (two tiles, one launch) and 2048^2 plans, against its twin and against
    ``stitch_plain`` + ``==`` + the B8a twin (at class 0 the pixels no copy
    writes are background, as in the Pallas kernel)."""
    for h, w in COUNT_SIZES:
        for name, m in [("random", rng.random((h, w)) < 0.5), ("snake", snake(h, w)), ("spiral", spiral(h, w))]:
            mt = torch.from_numpy(m).to(dev)
            for conn in (1, 2):
                errors.compare("count", K.count_components(mt, conn), K.count_components_plain(mt, conn), f"{name} {h}x{w} conn {conn}")
            print(f"B8a count {name} {h}x{w}: matches plain; conn 2 {cuda_ms(lambda: K.count_components(mt, 2), 5):.3f} ms", flush=True)
    for h, w, t in COUNT_PLANS:
        pos = tuple(map(tuple, tiling.patch_positions(h, w)))
        lp = torch.from_numpy(rng.integers(0, 4, (t, len(pos), 256, 256)).astype(np.uint8)).to(dev)
        written = K.stitch_plain(torch.ones_like(lp[0]), pos) != 0
        for cls in range(4):
            what = f"{h}x{w} ({t} x {len(pos)} patches) class {cls}"
            got = K.count_from_patches(lp, pos, cls)
            errors.compare("count_patches", got, K.count_from_patches_plain(lp, pos, cls), what)
            for i in range(t):
                mask = K.stitch_plain(lp[i], pos) == cls
                if cls == 0:
                    mask &= written
                errors.compare("count_patches", (got[0][i], got[1][i]), K.count_components_plain(mask, 2), what + " (stitch_plain + ==)")
        errors.compare("count_patches", K.count_from_patches(lp.int(), pos, 3), K.count_from_patches_plain(lp, pos, 3), f"{h}x{w} int32 labels")
        print(f"B8b stitch+count {h}x{w}, {t} tile(s): matches plain for class 0-3; {cuda_ms(lambda: K.count_from_patches(lp, pos, 3), 5):.3f} ms", flush=True)


def _tail_inputs(rng, c1, c2, n, integer, dtype, dev):
    if integer:
        mk = lambda *s: torch.from_numpy(rng.integers(-2, 3, s).astype(np.float32))
        x = torch.from_numpy(rng.integers(0, 3, (n, 256, 256, c1)).astype(np.float32))
    else:
        mk = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.2).astype(np.float32))
        x = torch.from_numpy((rng.random((n, 256, 256, c1)) * 0.5).astype(np.float32))
    ws = [mk(3, 3, c1, c2), mk(c2), mk(3, 3, c2, c2), mk(c2), mk(1, 1, c2, 4), mk(4)]
    return [x.to(dev, dtype)] + [t.to(dev, dtype) for t in ws]


def phase_tail_kernels(rng, dev, errors, results):
    """B10 on 8 patches at both widths; B11 at the decoder's shapes.  Each
    bit-equal to its twin on integer-valued float32 (the CUDA-core form)
    and bf16 (the tensor-core form; integer sums are exact, so every
    rounding lands where the twin's does), then on random bf16."""
    from ecseg_torch.ops.convt import conv2d_transpose_packed, conv2d_transpose_packed_plain
    from ecseg_torch.ops.fused_tail import fused_dec1_head, fused_dec1_head_plain

    results["tail_agreement"] = {}
    for arch, (c1, c2) in TAIL_WIDTHS.items():
        for dtype in (torch.float32, torch.bfloat16):
            args = _tail_inputs(rng, c1, c2, 8, True, dtype, dev)
            errors.compare("fused_tail", fused_dec1_head(*args), fused_dec1_head_plain(*args), f"integer {dtype} c1/c2 {c1}/{c2}")
        args = _tail_inputs(rng, c1, c2, 8, False, torch.bfloat16, dev)
        got, want = fused_dec1_head(*args), fused_dec1_head_plain(*args)
        errors.note("fused_tail", int((got.long() - want.long()).abs().max()))
        agree = float((got == want).double().mean())
        results["tail_agreement"][arch] = agree
        check(agree >= TAIL_AGREEMENT, f"B10 bf16 c1/c2 {c1}/{c2}: label agreement {agree} < {TAIL_AGREEMENT}")
        print(f"B10 fused tail c1/c2 {c1}/{c2}, 8 patches: integer float32 and bf16 equal plain; random bf16 label agreement {agree:.6f}", flush=True)
    for level, (n, h, w, cin, cout) in CONVT_SHAPES.items():
        x = torch.from_numpy(rng.integers(-2, 3, (n, h, w, cin)).astype(np.float32)).to(dev)
        k = torch.from_numpy(rng.integers(-2, 3, (3, 3, cin, cout)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.integers(-2, 3, (cout,)).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            xd, kd = x.to(dtype), k.to(dtype)
            errors.compare("convt", conv2d_transpose_packed(xd, kd, b), conv2d_transpose_packed_plain(xd, kd, b), f"integer {dtype} {level}")
        # bf16: one rounding each after float32 sums in another order, so
        # at most one bf16 ulp (2**-7 relative) apart, plus sum-order noise
        xb = torch.randn(x.shape, device=dev).bfloat16()
        kb = (torch.randn(k.shape, device=dev) / (3 * cin**0.5)).bfloat16()
        got = conv2d_transpose_packed(xb, kb, b).float()
        want = conv2d_transpose_packed_plain(xb, kb, b).float()
        err = (got - want).abs()
        errors.note("convt", float(err.max()))
        check(bool((err <= 2**-7 * want.abs() + 1e-5 * want.abs().max()).all()), f"B11 bf16 {level}: max |err| {float(err.max())}")
        print(f"B11 convt {level} {(n, h, w, cin, cout)}: integer float32 and bf16 equal plain, random bf16 max |err| {float(err.max()):.3g}", flush=True)


def phase_tile_count(K, dev, results):
    """The tile-count path through ``tile_count.run`` at both widths, both
    variants, with the default device; then its checks and ms per tile.
    Leaves the default width's inputs for the timing rows."""
    from ecseg_torch.pipelines import tile_count as tc

    runs = {}
    for arch in tc.ARCHS:
        for fused in (False, True):
            variant = "fused_tail" if fused else "unfused"
            K.reset_launches()
            t0 = time.perf_counter()
            counts, px = tc.run(arch, fused_tail=fused)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(K.LAUNCHES)
            print(f"tile-count path {arch} {variant}: {len(counts)} tiles in {wall:.3f} s (tiles made on the host included); launches {launches}; counts {counts.tolist()}", flush=True)
            check(launches == tile_path_launches(fused), f"tile-count {arch} {variant}: launches {launches}")
            check(bool((counts > 10).all()), f"tile-count {arch} {variant}: a tile's count is <= 10 ({counts.tolist()})")
            runs[(arch, variant)] = (counts, px, launches)
        for k in (0, 1):
            check(np.array_equal(runs[(arch, "unfused")][k], runs[(arch, "fused_tail")][k]), f"tile-count {arch}: the variants differ")
    results["tile_launches"] = {f"{a} {v}": r[2] for (a, v), r in runs.items()}
    per_tile = {}
    for arch in tc.ARCHS:
        n = tc.ARCHS[arch][2]
        model = tc.realistic_model(arch, torch.Generator().manual_seed(0)).to(dev)
        patches_np, positions = tc.tile_patches(tc.synthetic_tiles(n, 0))
        patches = torch.from_numpy(patches_np).to(dev)
        per_tile[arch] = {}
        for fused in (False, True):
            variant = "fused_tail" if fused else "unfused"
            labels = tc.patch_labels(model, patches, fused)
            c, p = K.count_from_patches_plain(labels, positions, tc.EC_CLASS, 2)
            counts, px, _ = runs[(arch, variant)]
            check(np.array_equal(c.cpu().numpy(), counts) and np.array_equal(p.cpu().numpy(), px), f"tile-count {arch} {variant}: run != twin composition on its labels")
            per_tile[arch][variant] = cuda_ms(lambda: tc.count_tiles(model, patches, positions, fused), 2) / n
            if not fused:
                unfused_labels = labels
        print(f"tile-count path {arch}: run == twin composition; ms per tile {per_tile[arch]}", flush=True)
        cpu_model = copy.deepcopy(model).float().cpu()
        x2 = patches[0, :2]
        with torch.no_grad():
            err = float((model(x2).cpu() - cpu_model(x2.cpu())).abs().max())
        check(err < FORWARD_TOL, f"tile-count {arch}: bf16 card vs float32 CPU forward max |diff| {err}")
        print(f"tile-count {arch}: bf16 card vs float32 CPU forward on 2 patches max |diff| {err:.4g} (< {FORWARD_TOL})", flush=True)
        with torch.no_grad():
            x_cat = model.forward_cat1(patches.reshape(-1, 256, 256, 1))
        results.setdefault("tile_inputs", {})[arch] = (model, unfused_labels, positions, x_cat)
        del model, patches, labels, unfused_labels, x_cat
    results["tile_ms_per_tile"] = per_tile
    return per_tile


def _timed_row(key, kern, plain, nbytes, flops, peak, launches, reps, errors, exact=True, **extra):
    """One timing row; with ``exact`` the kernel is first held bit-equal to
    its twin on the timed input."""
    if exact:
        errors.compare(key, kern(), plain(), extra["input"])
    ms = cuda_ms(kern, reps)
    dev_ms, kernel_ms = device_ms(kern, reps, kernel=KERNEL_NAMES[key], event_ms=ms)
    plain_ms = cuda_ms(plain, 1)
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / peak if flops else 0.0
    b, name, source, site, fn = TILE_KERNELS[key]
    row = {
        "name": name, "b": b, "route": "cuda", "source": source, "replaces": site, "pallas_function": fn,
        "launches": launches, "max_abs_err": errors.max[key], "ms": ms, "device_ms": dev_ms,
        "kernel_device_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "library_ms": None, **extra,
    }
    row["bound_share"] = row["bound_ms"] / ms
    row["tflops"] = flops / ms / 1e9 if flops else None
    print(
        f"{b} {name}: kernel {ms:.4f} ms (device {dev_ms:.4f} ms, of which {KERNEL_NAMES[key]} {kernel_ms:.4f} ms), "
        f"plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, {100 * row['bound_share']:.1f} % of it), "
        + (f"{row['tflops']:.1f} TFLOP/s, " if flops else "") + f"launches {launches}",
        flush=True,
    )
    return row


def tile_rows(K, dev, errors, results):
    """Timing rows of B8a, B8b, B10, B11 beside their twins and bounds."""
    from ecseg_torch.models.layers import TFConvTranspose2d
    from ecseg_torch.ops import tiling
    from ecseg_torch.ops.convt import conv2d_transpose_packed, conv2d_transpose_packed_plain
    from ecseg_torch.ops.fused_tail import fused_dec1_head, fused_dec1_head_plain
    from ecseg_torch.pipelines import tile_count as tc

    inputs = results.pop("tile_inputs")
    model, labels, positions, x_cat = inputs["default"]
    launches = results["tile_launches"]
    rows = []
    ec = results.pop("ec_mask")
    rows.append(_timed_row(
        "count", lambda: K.count_components(ec, 2), lambda: K.count_components_plain(ec, 2), ec.numel() + 8, 0, None, 0, 20, errors,
        path=None, input="metaseg image 0's ecDNA mask (2048^2); on no path (the JAX package calls it only from its oversize fallback and tests)",
    ))
    t = labels.shape[0]
    landed = int((K._source_map(positions, dev) >= 0).sum())
    rows.append(_timed_row(
        "count_patches", lambda: K.count_from_patches(labels, positions, 3), lambda: K.count_from_patches_plain(labels, positions, 3),
        t * landed + 8 * t, 0, None, launches["default unfused"]["count_patches"], 20, errors,
        path="tile_count default unfused", input=f"{t} tiles x 25 patch labels (uint8) of the default path",
    ))
    def tail_cost(x, w):
        n, c1, c2 = x.shape[0], x.shape[3], w[0].shape[3]
        flops = 2 * 256 * 256 * (9 * c1 * c2 + 9 * c2 * c2 + 4 * c2) * n
        return x.numel() * x.element_size() + 4 * n * 256 * 256 + sum(a.numel() * a.element_size() for a in w), flops

    def chain(model, x):  # the unfused cuDNN chain B10 replaces, in bf16
        L = model.layers
        with model._flags():
            y = torch.relu(L["dec1_1"].forward_bias_after(x.permute(0, 3, 1, 2)))
            y = torch.relu(L["dec1_2"].forward_bias_after(y))
            return tiling.patch_labels(torch.softmax(L["head"].forward_bias_after(y).float(), 1).permute(0, 2, 3, 1))

    xl = {}  # B10 at the XL widths, beside the default row
    for arch in ("xl", "default"):
        m, _, _, x = inputs[arch]
        w = tc.dec1_head_weights(m)
        check(torch.equal(chain(m, x[:25]).int(), fused_dec1_head(x[:25], *w)), f"B10 != the cuDNN chain on the {arch} path's input")
        if arch == "xl":  # the default width's whole input is compared in its row
            errors.compare("fused_tail", fused_dec1_head(x, *w), fused_dec1_head_plain(x, *w), f"the xl path's {x.shape[0]}-patch level-1 concat")
            nbytes, flops = tail_cost(x, w)
            xl = {"ms": cuda_ms(lambda: fused_dec1_head(x, *w), 3), "chain_ms": cuda_ms(lambda: chain(m, x), 3),
                  "bound_ms": max(1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS), "patches": x.shape[0]}
            xl.update(tflops=flops / xl["ms"] / 1e9, bound_share=xl["bound_ms"] / xl["ms"], below_chain=xl["ms"] < xl["chain_ms"])
            print(f"B10 at the XL widths ({x.shape[0]} patches, c1/c2 {x.shape[3]}/{w[0].shape[3]}): {xl}", flush=True)
    del inputs["xl"], m, x
    nbytes, flops = tail_cost(x_cat, w)
    rows.append(_timed_row(
        "fused_tail", lambda: fused_dec1_head(x_cat, *w), lambda: fused_dec1_head_plain(x_cat, *w), nbytes, flops, BF16_FLOPS,
        launches["default fused_tail"]["fused_tail"], 3, errors, path="tile_count default fused_tail",
        input=f"{x_cat.shape[0]} patches of the default path's level-1 concat (bf16, c1/c2 {x_cat.shape[3]}/{w[0].shape[3]})",
        chain_ms=cuda_ms(lambda: chain(model, x_cat), 3), xl=xl, bf16_label_agreement=results["tail_agreement"],
    ))
    rows[-1]["below_chain"] = rows[-1]["ms"] < rows[-1]["chain_ms"]
    del inputs, x_cat, labels, model
    torch.cuda.empty_cache()
    levels = {}  # B11 and cuDNN's transpose conv + ReLU (bf16) at every decoder level
    for level, (n, h, wd, cin, cout) in CONVT_SHAPES.items():
        x = torch.randn((n, h, wd, cin), device=dev).bfloat16()
        k = (torch.randn((3, 3, cin, cout), device=dev) / (3 * cin**0.5)).bfloat16()
        b = torch.randn(cout, device=dev)
        layer = TFConvTranspose2d(cin, cout).to(dev, torch.bfloat16)
        with torch.no_grad():
            layer.weight.copy_(k.permute(2, 3, 0, 1))
            layer.bias.copy_(b)
        xn = x.permute(0, 3, 1, 2)
        with torch.no_grad():
            library_ms = cuda_ms(lambda: torch.relu(layer(xn)), 5)
        nbytes = 2 * (x.numel() + k.numel() + 4 * n * h * wd * cout)
        flops = 2 * n * h * wd * cin * cout * 9
        if level != CONVT_TIMED:
            ms = cuda_ms(lambda: conv2d_transpose_packed(x, k, b), 5)
            bound = max(1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / BF16_FLOPS)
            levels[level] = {"shape": (n, h, wd, cin, cout), "ms": ms, "library_ms": library_ms, "bound_ms": bound,
                             "bound_share": bound / ms, "tflops": flops / ms / 1e9}
            print(f"B11 at {level} {(n, h, wd, cin, cout)}: {levels[level]}", flush=True)
            continue
        rows.append(_timed_row(
            "convt", lambda: conv2d_transpose_packed(x, k, b), lambda: conv2d_transpose_packed_plain(x, k, b),
            nbytes, flops, BF16_FLOPS, 0, 5, errors, exact=False, path=None,
            input=f"{CONVT_TIMED} {(n, h, wd, cin, cout)} bf16; on no path (the U-Net's transpose convs stay on cuDNN, as the JAX package's stay on XLA)",
            library_ms=library_ms,
        ))
        levels[level] = {k_: rows[-1][k_] for k_ in ("ms", "library_ms", "bound_ms", "bound_share", "tflops")}
        levels[level]["shape"] = (n, h, wd, cin, cout)
        del x, k, layer, xn
    rows[-1]["levels"] = levels
    tail = rows[-2]
    print(f"B11 library (TFConvTranspose2d + ReLU, cuDNN bf16) at {CONVT_TIMED}: {rows[-1]['library_ms']:.4f} ms; "
          f"B10 chain (cuDNN bf16): {tail['chain_ms']:.3f} ms, B10 {tail['ms']:.3f} ms, below the chain: {tail['ms'] < tail['chain_ms']}", flush=True)
    return rows


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
    phase_tile_masks(K, dev, errors)  # draws no numbers from rng
    # its own generator, so the main path's images do not depend on it
    phase_multiclass_kernels(K, np.random.default_rng(args.seed + 1), dev, errors)
    # their own generators, so the main path's images do not depend on them
    phase_count_kernels(K, tiling, np.random.default_rng(args.seed + 2), dev, errors)
    phase_tail_kernels(np.random.default_rng(args.seed + 3), dev, errors, results)
    phase_main_path(args, rng, dev, errors, results)
    rows = phase_timings(K, dev, errors, results)
    xl_ms = phase_xl_forward(rng, dev)
    per_tile = phase_tile_count(K, dev, results)
    rows += tile_rows(K, dev, errors, results)
    print(json.dumps({"tile_count_ms_per_tile": per_tile, "card": smi}))
    print(json.dumps({"stages_s": results["stages"], "main_wall_s": results["main_wall_s"], "xl_forward_100_ms": xl_ms, "card": smi}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
