"""Smoke test of the PyTorch/CUDA port (ecseg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises; exit code 0 only when all pass):

1. print the card's name and power limit; build the CUDA kernels from
   ``ecseg_torch/csrc`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch twin on the card, integer
   bit-equality: B1 stitch (random bytes 0-255) at the 2048^2 plan (100
   patches), 2048x3072, 1024^2, 462x874, 306^2 and 256^2 (the two-corner
   plan);
   B2 label (connectivity 1 and 2), B3 border flood and B4 seeded flood on
   random, snake and spiral masks at 2048^2 and at 2048x3072 (which also
   proves the port serves the banded TPU kernels' large-map contract), with
   B2's, B3's and B4's times beside those of the three-pass form they
   replaced; B2 (connectivity 1 and 2), B3 (on each mask and its
   complement) and B4 (connectivity 1 and 2, from sparse and dense seeds,
   seeds on tile corners and edges, and seeds only off the mask) on the
   tile-edge masks of ``tests/_masks.py`` (``tile_masks``: checkerboard,
   diagonals through tile corners, staircase, frames on the 32 and 64
   grids, a giant background with holes, full, empty), B9 label+flood
   (labels and flood) on the same masks with the same seeds and
   connectivities, and B5 and B6 (with each seed pattern; ``off_mask``
   seeds only class 0) on its tile-edge class maps (``tile_class_maps``:
   each mask as two classes, classes on alternate tiles, stripes), at
   2048^2 and at the ragged sizes 2047x2049, 33x4097, 1x2048 and 2048x1;
   B5 multiclass label, B6 multiclass flood and B9 label+flood
   (connectivity 1 and 2, on the map's odd classes) on a uniformly random
   4-class map, a column-striped class map, and a class-1 snake and spiral
   on class 2, at the same two sizes (B5, B6 and B9 beside their
   three-pass times); B8a count on the
   random, snake and spiral masks at
   both sizes and on the tile-edge masks at every size (connectivity 1 and
   2); B8b stitch+count on 1, 2 and 32
   tiles of the 1024^2 plan in one launch and on one 2048^2 tile, for
   class_id 0-3 at connectivity 1 and 2, uint8 and int32 labels (one and
   two tiles also against ``stitch_plain`` + ``==`` + the B8a twin), and
   on the tile-edge masks written into 1024^2 patch stacks; B10 fused decoder tail on 8
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
   exactly as the form predicts (``PER_IMAGE_LAUNCHES``: the post's
   kernels and the forward's H1, ``FORWARD_LAUNCHES``); the image with
   more than 512 nuclei went through the counted host redo; every image's
   labels equal the host oracle on the same raw canvas; a rerun gives
   byte-identical labels; the card's forward agrees with the CPU forward
   (TF32 off); the forward's 3x3 convs ran on H1, the hand-written float32
   conv (18 launches a 100-patch model call, no fallback; ``segment_folder`` on the
   four images again with them on cuDNN: at most ``CONV3X3_LABEL_PX``
   label pixels differ, ecDNA counts equal, a second H1 run byte-equal);
   the labels crossed to the host as one 2-bit blob a canvas
   (``metaseg.post_blob``), the crowded image's raw map besides, counted in
   ``ops/packing.FETCHED`` (bytes an image, copies, copy ms), and image 0's
   blob copy + decode is timed beside the copy of its int64 canvas; every
   ``main`` run of metaseg checks those bytes.  ``main`` groups the images of a geometry by default (2 + 2
   at 2048^2, 100 patches an image, the crowded image in the second group:
   the forwards one an image, B1 and the post per canvas); ``main`` again per
   image (``ECSEG_METASEG_GROUP=1``) and as 3 + 1
   (``ECSEG_METASEG_GROUP=3 ECSEG_METASEG_PATCH_BUDGET=300``): the same
   launches and host redo, the forwards per group, labels, PNGs and CSV
   rows byte-equal to the default run's, ms per image of each.  Then
   ``main`` under ``ECSEG_DEVICE_PIPELINE=0`` on an ordinary image and the
   crowded one (forward and B1 on the card, the host oracle after: only B1
   and the forward's H1 launched, no redo counted, the same bytes).  Then ``main`` again under
   ``ECSEG_MC_LABEL=0`` and under
   ``ECSEG_MC_MERGE=1`` on an ordinary image and the crowded one: the same
   launch-count and host-redo checks, and labels and CSV rows byte-equal to
   the default form's.  Then the command line as a user runs it:
   ``python3 -m ecseg_torch.pipelines.metaseg`` in a directory with a
   ``config.yaml`` (read without PyYAML) and ``models/metaseg.npz``, on a
   folder with a copy of ``example_ecSeg/input.tif`` (LZW, predictor 2) and
   a synthetic 2048^2 image this script writes as LZW (no cv2): exit code
   0, two CSV rows, labels equal to the host oracle and byte-equal to an
   in-process ``main``, and the host decode times of both files.  Then
   ``make metaseg && make meta_overlay`` as a user runs them: the two
   command lines on a folder of three 2048^2 RGB uint16 LZW TIFFs (written
   by the port's encoder, ``imgio.write_tiff_lzw``; blue a
   synthetic DAPI image, red and green seeded FISH dots and blobs; one
   image's FISH below color_sensitivity) and one grayscale TIFF, and
   ``meta_overlay.main`` in-process on a copy (launch counters set to 0
   just before, read just after: ``OVERLAY_LAUNCHES`` per RGB image, B2
   and B8a).  Checks: exit codes 0, three CSV rows byte-equal to the
   in-process run's and to the host oracle's, the ``red/``/``green/``
   PNGs decode to 255 - the channel, B8a equal to its twin on every
   image's ec, fish_nc and fish2_nc masks, ``overlay_stats`` equal to the
   host oracle with seeded chromosome blobs; ``meta_overlay.main`` under
   ``ECSEG_DEVICE_PIPELINE=0`` (the host statistics, the oracle's branch):
   no kernel launched, CSV and PNG bytes equal to the device run's; the
   stage times per image.
   Then ``python3 -m ecseg_torch.pipelines.fish_distance`` (host only) on
   a synthetic stat_fish output folder, its CSV byte-equal to an
   in-process host computation;
4. time each kernel at the main path's shapes beside its plain twin and its
   memory bound: the CUDA-event mean over back-to-back calls (``ms``) and
   the device-only time from one ``torch.profiler`` pass (``device_ms``);
   B7, whose contract B2 and B4 serve, as B2 on a 2048x3072 mask;
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
   share of the bound (B8a on metaseg image 0's ecDNA mask and on the
   overlay's fish2_nc mask, its launches from the meta_overlay run); each
   timed row's profiler pass must show the
   wrapper's own kernel by name, and a pass whose device sum differs from
   the CUDA-event mean by more than 25 % is repeated; B8a, B8b and B10
   bit-equal to their twins on the timed inputs, B10 on the whole level-1
   concat of both widths' paths (800 and 200 patches); H1 at three XL
   layers of 100 patches (``CONV3X3_SHAPES``: enc1_2, dec2_1 with its two
   halves, bott_2) beside its twin, its FMA bound and cuDNN under
   ``parity_flags`` (NCHW, as the forward ran before it), bit-equal to the
   twin on integer inputs, within 1e-5 of cuDNN's largest output on normal
   ones, byte-equal on a second call and over 50 + 50 patches, its
   ``launches`` those of the default form's ``main`` run; then ``make
   bench`` as the port runs it (``phase_bench``): ``python3 -m
   ecseg_torch.bench`` with its default flags as a subprocess (three JSON
   lines, the scored tiles/s line last and the only one on stdout, every
   value > 0, ``forward_mfu`` in (0, 1]); in-process at one chunk and one
   pass (launch counters set to 0 just before each measure, read just
   after), the full-pipeline program cut after each stage (``fwd``,
   ``stitch``, ``meta``, ``full``: per canvas the launches of
   ``bench_stage_launches``, a cut of one metaseg image's) and the
   fused-tail tile program (``tile_path_launches``); the full program's
   counts on 2 tiles equal to the same program through the kernels' plain
   twins on the card; ``python3 -m ecseg_torch.bench_stat_fish 3`` (exit
   code 0, one JSON line);
6. after every profiler timing (once the card has idled through long host
   work, as in stat_fish's tail, ``torch.profiler`` drops the device records
   of short windows: ``runtime/devtime.py``): ``make stat_fish`` as a user runs
   it (``phase_stat_fish``): ``python3 -m ecseg_torch.pipelines.stat_fish``
   and ``stat_fish.main`` in-process (launch counters set to 0 just before,
   read just after: four B2 an image, one B3 a watershed with markers and
   ``NUSET_FORWARD_LAUNCHES``, H1 at each of the two U-Net passes' 18
   ReLU'd 3x3 convs and 4 transpose convs; ``nuset_conv3x3_check``: image
   0's passes on H1 against cuDNN (masks, proposal counts), a whole pass of
   seeded Glorot weights, logits and RPN feature within ``NUSET_PASS_REL``
   of cuDNN's, and H1 against its twin and cuDNN at NuSeT's own planes and
   two of its transpose convs, ``NUSET_CONV3X3_SHAPES`` and
   ``NUSET_CONVT_SHAPES``)
   on three 2048^2 RGB uint16 LZW TIFFs (``imgio.write_tiff_lzw``; half the nuclei with an
   amplified red probe, drawn from seed + 8, for interseg) with the demo
   NuSeT at its published widths (RPN scores raised so that markers are
   placed).
   Checks: CSV and ``.npy`` bytes and TIFF pixels equal across the two
   runs; the in-process run's device->host bytes (``ops/packing.FETCHED``)
   equal its packed layouts: both NuSeT masks, the cleanup's mask and the
   matched filter's two center maps 1 bit a pixel an image, and a watershed
   contour with its certificate per B3 launch; on image 0 and a 900x700 crop of it the device watershed (where
   its certificate is clean), cleanup and matched filter equal the host
   chains on the same NuSeT outputs, and B2 and B3 equal their twins on
   those masks (608^2, 256x208, 2027^2); on both, the ungated watershed
   modes (``ECSEG_FAST_WATERSHED=on`` and ``check``, at the JAX package's
   padded geometry) on the card equal the CPU twins' with the same tie
   count, B3 launched once (``on``) or twice (``check``) a watershed with
   markers, and each mode's ms; ``stat_fish.main`` in-process under
   ``ECSEG_FAST_WATERSHED=host`` on a copy of the inputs: CSV and ``.npy``
   bytes and TIFF pixels equal to the default run's, no B3 launch; and
   under ``ECSEG_DEVICE_PIPELINE=0`` (the host watershed, cleanup and
   matched filter: the branch pair whose artifacts the JAX repo's
   ``scripts/parity_tpu.py`` compares) on another copy: the same bytes, no
   kernel launched; the
   certified watershed with hand-placed proposals equals the host flood
   when clean.  Times: the
   stage table, images/s, the XLA-side ops, one profiler pass (device busy
   share), B2 and B3 at stat_fish's geometries.  Then ``make interseg``
   (``phase_interseg``): ``python3 -m ecseg_torch.pipelines.interseg`` and
   ``interseg.main`` in-process on the stat_fish command line's folder
   (``FISH_color: red``, a centromeric probe, the demo ecSeg-i/ecSeg-c
   trees in ``interseg_models/*.npz``).  Checks: the two CSVs byte-equal;
   per image, the batched card labels equal per-row card labels
   (probabilities within 1e-5) and the CPU's on the same crops; the
   classifiers on the card, ecSeg-c run; per-image stage times.  Then the
   multi-device paths (``phase_multidevice``) on every card, or on one card
   on a logical mesh of it listed twice (printed), reusing the folders of
   the phases above: ``metaseg.main(devices=...)`` on the main path's four
   images in the default form and under ``ECSEG_DEVICE_PIPELINE=0``,
   ``meta_overlay``, ``stat_fish`` and ``interseg`` ``main(devices=...)``,
   each byte-equal to its single-card run with the same launches (``=0``:
   none but H1's, ``FORWARD_LAUNCHES`` per entry per batch of
   ``METASEG_SHARDED_BATCH`` patches) and one host redo (the default
   form); every fan-out under
   PyTorch's default cuDNN flags, which read the same after it, with
   ``allow_tf32`` False at each float32 convolution in the workers; then
   ``train_step_on_mesh`` on a (data 2, model 2) mesh of four entries at
   the default widths (batch 16, 256^2): three float32 steps' losses and
   the first step's gradients against the single card's ``train_step``
   (phase_train's bound) and one bf16 step; ms per image (per step) of
   each path, mesh against one card.  Then the
   int8 U-Net (``phase_quant``, ``models/quant.py``) at the default widths
   with the main path's demo weights on image 0's 100 patches: int8
   kernels, scales and two layers' int32 accumulators equal on the card
   and the CPU, labels on 2 patches against the CPU's, labels against the
   float32 forward's (>= 0.95), a 100-patch forward's ms in int8, bf16 and
   float32, the weights' bytes.  Then the
   imported-Keras executor (``phase_keras_import``) from in-memory configs
   and weights: the metaseg U-Net as a Keras Functional graph, its
   stitched labels over image 0's patches byte-equal to ``MetasegUNet``'s,
   and ecSeg-i as a Keras Sequential against ``EcsegI``.  Then the
   ``.h5`` entry points (``phase_keras_h5``): a full-width
   ``models/metaseg.h5`` and ``interseg_models/{interseg,ecseg_c}.h5``
   written by ``core/hdf5.write_keras_h5`` (TF-Keras 2's legacy layout) and
   read by the port's own HDF5 reader, ``python3 -m
   ecseg_torch.pipelines.metaseg`` on the main path's four images (labels
   and CSV byte-equal to the in-process run, the ``.npz`` run and the host
   oracle; B1-B6 launched as the default form) and ``python3 -m
   ecseg_torch.pipelines.interseg`` (the ``.npz`` run's CSV bytes); the
   reader's host seconds and each command's wall.  Then the reference's
   TensorFlow formats (``phase_tf_models``): the demo NuSeT at its
   published widths written as the reference's TF1 checkpoint pair
   (``write_tf_bundle``) and converted by ``python3 -m
   ecseg_torch.convert_tf1_ckpt`` (``models/nuset.npz`` equal to the tree),
   stat_fish's command line from it on the stat_fish phase's images (every
   output byte-equal to that phase's command line) and in-process (four B2
   an image, one B3 a watershed with markers); the demo ecSeg-i and
   ecSeg-c written as SavedModels (``write_keras_savedmodel``), converted
   by ``python3 -m ecseg_torch.convert_savedmodel`` and run by interseg's
   command line (the ``.h5`` run's CSV bytes); the bytes written and each
   command's wall.  Then the
   metaseg trainer (``phase_train``) at the default widths on 256^2 crops
   of the main path's images and labels: card against CPU (each gradient
   tensor held to the CPU's float64 gradient; a TF32 backward outside the
   bound), determinism, remat, resume through a checkpoint, no hand kernel
   launched, ``python3 -m ecseg_torch.pipelines.train_metaseg`` in float32
   and with ``--bf16 --remat``, the float32 export served back through
   ``python3 -m ecseg_torch.pipelines.metaseg`` (B1-B6 launches, labels
   equal to the host oracle); ms a step, TFLOP/s and peak memory in
   float32, bf16 and both with remat, and the host's crop and copy time.
   Then the JAX repo's two model scripts (``phase_compare_archs``):
   ``python3 -m ecseg_torch.compare_archs --steps 30 --n-train 2
   --n-eval 1`` (two JSON lines, default then XL, with the script's keys;
   IoUs and accuracy in [0, 1]; finite losses, the last below the first;
   XL's ms a step), ``python3 -m ecseg_torch.roofline_forward`` for both
   widths (closing lines equal to the sums of ``layers()``), and
   ``compare_archs.evaluate`` in-process on one 1024^2 field (one B1
   launch and the forward's H1, nothing else; labels equal with ``stitch_plain`` and with
   the CPU forward).
   Then the on-chip studies (``phase_studies``): ``python3 -m
   ecseg_torch.<study>`` for the six of ``STUDIES`` at once (and
   ``profile_meta_post`` under ``ECSEG_MC_MERGE=1``), at small sizes: exit
   codes 0, each JSON line naming this card with a timed row a
   block, the kernels each must launch (``profile_layers`` none), and
   ``quantify_watershed_divergence``'s lines on 2 cases equal to its run on
   the CPU.  Last, README's end-to-end demo through the port (``phase_demo``): in an
   empty directory with the repository's ``config.yaml``, ``python3 -m
   ecseg_torch.make_demo_weights`` and the five task command lines in
   README's order (stat_fish under ``ECSEG_TRACE=1 ECSEG_TRACE_DIR``):
   exit codes 0, the rows the CPU test pins, a Chrome trace with B2's
   kernels; stat_fish again under ``ECSEG_STAT_FISH_TAIL_WORKERS=3
   ECSEG_TIF_LZW=1 ECSEG_NO_NATIVE=1`` (the default run's CSV and ``.npy``
   bytes, LZW TIFFs of the same pixels); the five tasks in-process on a
   copy (launch counters set to 0 just before each, read just after:
   ``DEMO_LAUNCHES``), byte-equal to the command lines; each command's
   wall;
7. print ``{"grouped": ..., "host_post": ..., "quant": ...}``, ``{"tf_models": ...}``, ``{"train": ...}``, ``{"compare_archs": ...}``, ``{"multidevice": ...}``, ``{"bench": ...}``, ``{"demo": ...}``, ``{"studies": ...}``,
   ``{"kernels": [...]}`` (B2's and B3's rows with their stat_fish
   launches and times) and, last, ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ecseg_torch.peaks import H100, PEAKS
from ecseg_torch.runtime.devtime import card, cuda_ms, device_kernels, device_ms

HBM_BYTES_PER_S = PEAKS[H100]["hbm_bytes_per_s"]
BF16_FLOPS = PEAKS[H100]["bfloat16"]  # dense tensor-core peak (the timed B10/B11 rows are bf16)
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
# an image's float32 forward on the card (one model call of its patches):
# H1 at each 3x3 conv, 18 at four levels; the CPU forward launches none
FORWARD_LAUNCHES = {"conv3x3": 18}


def metaseg_forward_launches(patches: int):
    """``FORWARD_LAUNCHES`` of a float32 metaseg model call of ``patches``
    on the card: its 4 transpose convs on H1 too at a few patches
    (``layers.transpose_on_kernel``)."""
    from ecseg_torch.models import layers

    return {"conv3x3": FORWARD_LAUNCHES["conv3x3"] + 4 * (patches <= layers.ZERO_SPREAD_MAX_IMAGES)}

PER_IMAGE_LAUNCHES = {
    "default": {"stitch": 1, "label": 3, "flood_border": 2, "flood_seeds": 2, "label_mc": 2, "flood_mc": 1, "label_flood": 0, **_NOT_ON_METASEG, **FORWARD_LAUNCHES},
    "per_class": {"stitch": 1, "label": 8, "flood_border": 2, "flood_seeds": 5, "label_mc": 0, "flood_mc": 0, "label_flood": 0, **_NOT_ON_METASEG, **FORWARD_LAUNCHES},
    "fused_merge": {"stitch": 1, "label": 1, "flood_border": 2, "flood_seeds": 0, "label_mc": 2, "flood_mc": 1, "label_flood": 2, **_NOT_ON_METASEG, **FORWARD_LAUNCHES},
}
# ECSEG_DEVICE_PIPELINE=0: the forward and B1 on the card, the host oracle after
HOST_POST_LAUNCHES = {key: int(key == "stitch") for key in PER_IMAGE_LAUNCHES["default"]} | FORWARD_LAUNCHES
# main's grouping runs beside the default (2 + 2 at 2048^2): (name, environment, forwards of 4 images)
# (the first default run pays cuDNN's set-up, so "2 + 2" times the default again)
GROUP_RUNS = (
    ("per image", {"ECSEG_METASEG_GROUP": "1"}, 4),
    ("2 + 2", {}, 2),
    ("3 + 1", {"ECSEG_METASEG_GROUP": "3", "ECSEG_METASEG_PATCH_BUDGET": "300"}, 2),
)
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
FORWARD_KERNELS = {  # the float32 forward's hand kernel, as KERNELS (it replaces cuDNN: no Pallas kernel)
    "conv3x3": ("H1", "conv3x3_relu", "ecseg_torch/csrc/conv3x3_f32.cu", None, None),
}
ALL_KERNELS = {**KERNELS, **TILE_KERNELS, **FORWARD_KERNELS}
# the kernel launches of one RGB image through ``meta_overlay.main``: B2 on
# ec, fish_nc and chrom (8-connected) and in the two HSR size filters
# (4-connected), B8a on ec, fish_nc and fish2_nc
OVERLAY_LAUNCHES = {key: {"label": 5, "count": 3}.get(key, 0) for key in ALL_KERNELS}
OVERLAY_SENSITIVITY = 85  # the meta_overlay phase's color_sensitivity (the repository's config.yaml)
# the device kernel each timed tile-path row must show in its profiler pass
# (the bf16 forms of B10 and B11; B8's counting pass)
KERNEL_NAMES = {"count": "count_mask_tiles", "count_patches": "count_patch_tiles", "fused_tail": "fused_tail_mma", "convt": "convt_mma"}
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
F32_FLOPS = PEAKS[H100]["float32"]  # CUDA-core float32 peak (the H1 rows)
CONV3X3_SHAPES = {  # H1 at three of the XL forward's 3x3 convs, 100 patches: (n, h, w, skip cin, upsampled cin, cout)
    "xl enc1_2": (100, 256, 256, 64, 0, 64),
    "xl dec2_1": (100, 128, 128, 128, 128, 128),
    "xl bott_2": (100, 16, 16, 1024, 0, 1024),
}
CONV3X3_LABEL_PX = 12  # label pixels a whole forward may differ from the cuDNN forward's (the benchmark's check limit)
COUNT_SIZES = ((2048, 2048), (2048, 3072))  # B8a's stress masks
BANDED_SHAPE = (2048, 3072)  # B7's timing map: over the JAX package's fast-memory limit, so it labels it in bands
TILE_SIZES = ((2048, 2048), (2047, 2049), (33, 4097), (1, 2048), (2048, 1))  # B2-B6, B9 on the tile-edge maps
# B2's to B6's and B9's ms on phase 2's masks and class maps in the three-pass form
# that the tiled union-find replaced (B2, B3: this script before the
# change; on an NVIDIA H100 80GB HBM3 at 700.00 W): (kernel, input,
# connectivity) -> ms
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
    # B4 (sparse seeds, p = 0.001), B5, B6 and B9 (sparse seeds; B9 on the
    # odd classes): the kernels alone, on preallocated buffers
    # (scripts/ab_cc_tiled.py's base side, same card and limit)
    ("flood_seeds", "random 2048x2048", 1): 0.234, ("flood_seeds", "random 2048x2048", 2): 1.258,
    ("flood_seeds", "snake 2048x2048", 1): 1.154, ("flood_seeds", "snake 2048x2048", 2): 1.341,
    ("flood_seeds", "spiral 2048x2048", 1): 0.943, ("flood_seeds", "spiral 2048x2048", 2): 1.045,
    ("flood_seeds", "random 2048x3072", 1): 0.358, ("flood_seeds", "random 2048x3072", 2): 1.879,
    ("flood_seeds", "snake 2048x3072", 1): 1.503, ("flood_seeds", "snake 2048x3072", 2): 1.850,
    ("flood_seeds", "spiral 2048x3072", 1): 1.069, ("flood_seeds", "spiral 2048x3072", 2): 1.526,
    ("label_mc", "uniform class map 2048x2048", 2): 0.295, ("label_mc", "stripes class map 2048x2048", 2): 1.606,
    ("label_mc", "snake class map 2048x2048", 2): 1.490, ("label_mc", "spiral class map 2048x2048", 2): 1.191,
    ("label_mc", "uniform class map 2048x3072", 2): 0.440, ("label_mc", "stripes class map 2048x3072", 2): 2.273,
    ("label_mc", "snake class map 2048x3072", 2): 2.163, ("label_mc", "spiral class map 2048x3072", 2): 1.774,
    ("flood_mc", "uniform class map 2048x2048", 2): 0.330,
    ("label_flood", "uniform class map 2048x2048", 1): 0.237, ("label_flood", "uniform class map 2048x2048", 2): 1.280,
    ("flood_mc", "stripes class map 2048x2048", 2): 1.677,
    ("label_flood", "stripes class map 2048x2048", 1): 0.834, ("label_flood", "stripes class map 2048x2048", 2): 2.195,
    ("flood_mc", "snake class map 2048x2048", 2): 1.513,
    ("label_flood", "snake class map 2048x2048", 1): 1.142, ("label_flood", "snake class map 2048x2048", 2): 1.332,
    ("flood_mc", "spiral class map 2048x2048", 2): 1.209,
    ("label_flood", "spiral class map 2048x2048", 1): 0.847, ("label_flood", "spiral class map 2048x2048", 2): 1.013,
    ("flood_mc", "uniform class map 2048x3072", 2): 0.507,
    ("label_flood", "uniform class map 2048x3072", 1): 0.362, ("label_flood", "uniform class map 2048x3072", 2): 1.886,
    ("flood_mc", "stripes class map 2048x3072", 2): 2.381,
    ("label_flood", "stripes class map 2048x3072", 1): 1.223, ("label_flood", "stripes class map 2048x3072", 2): 3.139,
    ("flood_mc", "snake class map 2048x3072", 2): 2.136,
    ("label_flood", "snake class map 2048x3072", 1): 1.433, ("label_flood", "snake class map 2048x3072", 2): 1.818,
    ("flood_mc", "spiral class map 2048x3072", 2): 1.717,
    ("label_flood", "spiral class map 2048x3072", 1): 1.028, ("label_flood", "spiral class map 2048x3072", 2): 1.442,
}
REDESIGNED = {  # kernel -> its redesign
    **{k: "tiled union-find in shared memory" for k in ("label", "flood_border", "flood_seeds", "label_mc", "flood_mc", "label_flood")},
    "stitch": "quads of four pixels read through the plan's row/column descriptors, no source map",
    "count_patches": "tiled union-find over the tiles' border slots, counted as pieces minus links, no per-pixel array",
    "count": "tiled union-find over the tiles' border slots, counted as pieces minus links, no per-pixel array",
}
STITCH_PLANS = ((2048, 2048), (2048, 3072), (1024, 1024), (462, 874), (306, 306), (256, 256))  # B1's equality plans
COUNT_PLANS = ((1024, 1024, 1), (1024, 1024, 2), (1024, 1024, 32), (2048, 2048, 1))  # B8b's (h, w, tiles)
FORWARD_TOL = 2e-3  # bf16 card vs float32 CPU probabilities, tile-count weights (the CPU test's PROB_ATOL)
TAIL_AGREEMENT = 0.9999  # B10 vs its twin on random bf16: labels that must agree
STAT_FISH_IMAGES = 3  # 2048^2 RGB uint16 LZW TIFFs
STAT_FISH_T = 5000  # nuclei_size_T of the repository's config.yaml
STAT_FISH_LABELS_PER_IMAGE = 4  # B2: clean_image's three labelings and remove_small_objects' one
# an image's two NuSeT passes on the card: H1 at each ReLU'd 3x3 conv and
# each transpose conv, 22 a pass (``final`` and the RPN's conv stay on
# cuDNN); the CPU's launch none
NUSET_FORWARD_LAUNCHES = {"conv3x3": 44}
NUSET_CONV3X3_MASK_PX = CONV3X3_LABEL_PX  # NuSeT mask pixels an image's passes may differ from the cuDNN passes'
NUSET_GLOROT_SEED = 27  # the seeded Glorot U-Net whose whole pass H1 is held to against cuDNN
NUSET_PASS_REL = 1e-4  # its logits and RPN feature: float32 sums in two orders through 22 convs, of the largest value
NUSET_CONV3X3_SHAPES = {  # H1 at NuSeT's 608^2 pass, one image: (h, w, skip cin, upsampled cin, cout)
    "nuset conv1-1": (608, 608, 1, 0, 64),
    "nuset conv2-3": (152, 152, 128, 128, 128),
    "nuset conv5-2": (38, 38, 1024, 0, 1024),
}
NUSET_CONVT_SHAPES = {  # its transpose convs on H1 as 3x3 convs of the zero-spread input: (h, w, cin, cout, relu)
    "nuset deconv4": (38, 38, 1024, 512, True),
    "nuset deconv1": (304, 304, 128, 64, False),
}
STAT_FISH_SMALL = (900, 700)  # an input whose NuSeT width (208) is not a multiple of 32
STAT_FISH_STAGES = ("nuclei_segment", "back_wait", "watershed", "cleanup", "min_cut", "matched_filter", "region_stats",
                    "tail_visuals", "tail_writes", "decode_wait", "tail_wait")
NUSET_STAGES = ("prep", "forward", "fg_norm", "proposals")  # models/nuset_infer's stages


def tile_path_launches(fused_tail: bool):
    """Kernel launches of one ``tile_count.run``: one B8b over all tiles,
    one B10 when fused, nothing else."""
    want = {key: 0 for key in ALL_KERNELS}
    want["count_patches"] = 1
    want["fused_tail"] = int(fused_tail)
    return want


BENCH_TWIN_TILES = 2  # tiles of the full program held against its run through the plain twins
BENCH_STAT_FISH_IMAGES = 3
BENCH_TIMEOUT_S = 600  # each bench command line
PLAIN_TWINS = {"stitch_labels": "stitch_plain"}  # wrapper -> its twin in cc_kernels, where not wrapper + "_plain"


def bench_stage_launches(stage: str):
    """Kernel launches of one canvas through ``ecseg_torch.bench``'s full
    program cut after ``stage`` (one of ``bench.STAGES``): none through the
    forward (bf16: no H1), B1 through the stitch, one metaseg image's post
    (``PER_IMAGE_LAUNCHES["default"]``) without the count's B2 through
    ``meta``, all of it at ``full``."""
    per = PER_IMAGE_LAUNCHES["default"] | dict.fromkeys(FORWARD_LAUNCHES, 0)
    if stage in ("fwd", "stitch"):
        return {key: int(stage == "stitch" and key == "stitch") for key in per}
    if stage == "meta":
        per["label"] -= 1
    return per


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError("chip_smoke check failed: " + msg)


@contextlib.contextmanager
def environ(values):
    """Set the variables of ``values`` (None: unset); restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def post_form(form: str):
    """The environment of one post-processing form, restored after."""
    return environ({**dict.fromkeys(FORM_VARS), **FORM_ENV[form]})


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
    for h, w in STITCH_PLANS:
        pos = tuple(map(tuple, tiling.patch_positions(h, w)))
        lp = torch.from_numpy(rng.integers(0, 256, (len(pos), 256, 256)).astype(np.uint8)).to(dev)
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
                f"(three-pass {THREE_PASS_MS['flood_border', what, 1]:.3f} ms); B4 conn 1 "
                f"{cuda_ms(lambda: K.flood_from_seeds(mt, seeds, 1), 5):.3f} ms (three-pass "
                f"{THREE_PASS_MS['flood_seeds', what, 1]:.3f} ms), conn 2 {cuda_ms(lambda: K.flood_from_seeds(mt, seeds, 2), 5):.3f} ms "
                f"(three-pass {THREE_PASS_MS['flood_seeds', what, 2]:.3f} ms)",
                flush=True,
            )


def label_counts(labels):
    """B8a's twin on a mask that ``label_plain`` has labelled: (components,
    foreground pixels), the roots and the labelled pixels, as 0-d int32."""
    lab = labels.reshape(-1)
    idx = torch.arange(lab.numel(), device=lab.device)
    return (lab == idx).sum().to(torch.int32), (lab >= 0).sum().to(torch.int32)


def phase_tile_masks(K, dev, errors):
    """B2 and B8a (connectivity 1 and 2), B3 (on each mask and its
    complement), B4 and B9 (connectivity 1 and 2, each seed pattern of
    ``tests/_masks.py``: sparse, dense, on tile corners, on tile edges, only
    off the mask) bit-equal to their twins on the tile-edge masks, and B5 and B6 (each
    seed pattern of the class map's nonzero pixels) on the tile-edge class
    maps (``tile_class_maps``), at every ``TILE_SIZES`` size; times at
    2048^2."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _masks import seed_patterns, tile_class_maps, tile_masks

    for h, w in TILE_SIZES:
        for name, m in tile_masks(h, w).items():
            mt = torch.from_numpy(m).to(dev)
            what = f"tile mask {name} {h}x{w}"
            want_labels = {conn: K.label_plain(mt, conn) for conn in (1, 2)}
            for conn in (1, 2):
                errors.compare("label", K.label(mt, conn), want_labels[conn], f"{what} conn {conn}")
                errors.compare("count", K.count_components(mt, conn), label_counts(want_labels[conn]), f"{what} conn {conn}")
            for t, side in ((mt, ""), (~mt, " complement")):
                errors.compare("flood_border", K.flood_from_border(t), K.flood_from_border_plain(t), what + side)
            seeds = {p: torch.from_numpy(s).to(dev) for p, s in seed_patterns(m).items()}
            for p, st in seeds.items():
                for conn in (1, 2):
                    want = K.flood_from_seeds_plain(mt, st, conn)
                    errors.compare("flood_seeds", K.flood_from_seeds(mt, st, conn), want, f"{what} {p} seeds conn {conn}")
                    # B9's twin is (label_plain, flood_from_seeds_plain), both computed above
                    errors.compare("label_flood", K.label_and_flood(mt, st, conn), (want_labels[conn], want), f"{what} {p} seeds conn {conn}")
            if (h, w) == TILE_SIZES[0]:
                inv, sparse, dense = ~mt, seeds["sparse"], seeds["dense"]
                print(
                    f"B2/B3/B4/B8a/B9 {what}: match plain; B8a conn 2 {cuda_ms(lambda: K.count_components(mt, 2), 5):.4f} ms; "
                    f"B2 conn 1 {cuda_ms(lambda: K.label(mt, 1), 5):.4f} ms, "
                    f"conn 2 {cuda_ms(lambda: K.label(mt, 2), 5):.4f} ms; B3 {cuda_ms(lambda: K.flood_from_border(mt), 5):.4f} ms, "
                    f"complement {cuda_ms(lambda: K.flood_from_border(inv), 5):.4f} ms; B4 conn 2 sparse seeds "
                    f"{cuda_ms(lambda: K.flood_from_seeds(mt, sparse, 2), 5):.4f} ms, dense {cuda_ms(lambda: K.flood_from_seeds(mt, dense, 2), 5):.4f} ms; "
                    f"B9 conn 2 sparse {cuda_ms(lambda: K.label_and_flood(mt, sparse, 2), 5):.4f} ms, "
                    f"dense {cuda_ms(lambda: K.label_and_flood(mt, dense, 2), 5):.4f} ms",
                    flush=True,
                )
        for name, cls in tile_class_maps(h, w).items():
            ct = torch.from_numpy(cls).to(dev)
            what = f"tile class map {name} {h}x{w}"
            errors.compare("label_mc", K.label_multiclass(ct), K.label_multiclass_plain(ct), what)
            seeds = {p: torch.from_numpy(s).to(dev) for p, s in seed_patterns(cls > 0).items()}
            for p, st in seeds.items():
                errors.compare("flood_mc", K.flood_multiclass(ct, st), K.flood_multiclass_plain(ct, st), f"{what} {p} seeds")
            if (h, w) == TILE_SIZES[0]:
                sparse, dense = seeds["sparse"], seeds["dense"]
                print(
                    f"B5/B6 {what}: match plain; B5 {cuda_ms(lambda: K.label_multiclass(ct), 5):.4f} ms; B6 sparse seeds "
                    f"{cuda_ms(lambda: K.flood_multiclass(ct, sparse), 5):.4f} ms, dense {cuda_ms(lambda: K.flood_multiclass(ct, dense), 5):.4f} ms",
                    flush=True,
                )
        print(f"B2-B6/B8a/B9 tile-edge masks and class maps {h}x{w}: all match plain", flush=True)


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
                f"B5/B6/B9 {what}: match plain; B5 {cuda_ms(lambda: K.label_multiclass(ct), 5):.3f} ms "
                f"(three-pass {THREE_PASS_MS['label_mc', what, 2]:.3f} ms), "
                f"B6 {cuda_ms(lambda: K.flood_multiclass(ct, seeds), 5):.3f} ms "
                f"(three-pass {THREE_PASS_MS['flood_mc', what, 2]:.3f} ms), "
                f"B9 conn 1 {cuda_ms(lambda: K.label_and_flood(odd, seeds, 1), 5):.3f} ms "
                f"(three-pass {THREE_PASS_MS['label_flood', what, 1]:.3f} ms), "
                f"conn 2 {cuda_ms(lambda: K.label_and_flood(odd, seeds, 2), 5):.3f} ms "
                f"(three-pass {THREE_PASS_MS['label_flood', what, 2]:.3f} ms)",
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


def lzw_strip(data: bytes) -> bytes:
    """TIFF LZW of one strip: 9- to 12-bit codes, most significant bit
    first, each code's width that of the table the decoder will hold (one
    entry behind, hence libtiff's early change), the table cleared at 4094
    entries."""
    codes, widths = [256], [9]
    table, nxt, w = {}, 258, -1
    for c in data:
        if w < 0:
            w = c
            continue
        code = table.get((w << 8) | c)
        if code is not None:
            w = code
            continue
        codes.append(w)
        widths.append(nxt.bit_length())
        table[(w << 8) | c] = nxt
        nxt += 1
        if nxt == 4094:
            codes.append(256)
            widths.append(12)
            table, nxt = {}, 258
        w = c
    if w >= 0:
        codes.append(w)
        widths.append(nxt.bit_length())
        nxt += 1  # the decoder adds an entry on reading it
    codes.append(257)
    widths.append(min(nxt.bit_length(), 12))
    out, acc, nbits = bytearray(), 0, 0
    for code, width in zip(codes, widths):
        acc, nbits = (acc << width) | code, nbits + width
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:
        out.append((acc << (8 - nbits)) & 0xFF)
    return bytes(out)


def lzw_tiff_bytes(img: np.ndarray, byte_order: str = "<", rows_per_strip: int = 8) -> bytes:
    """A strip TIFF of a uint8/uint16 gray or RGB image, LZW with the
    horizontal predictor, as libtiff writes the reference's default TIFFs;
    ``byte_order`` "<" (II) or ">" (MM).  Independent of the port's writer
    (``imgio.write_tiff_lzw``), so the files it makes hold the port's
    decoder to a second encoder on the card (the command-line and
    fish_distance phases)."""
    h, w = img.shape[:2]
    spp = 1 if img.ndim == 2 else img.shape[2]
    diff = img.copy()
    diff[:, 1:] -= img[:, :-1]  # wraps, as the predictor's differences do
    raw = diff.astype(img.dtype.newbyteorder(byte_order))
    strips = [lzw_strip(raw[r : r + rows_per_strip].tobytes()) for r in range(0, h, rows_per_strip)]
    blob = bytearray(8)
    offsets = []
    for s in strips:
        offsets.append(len(blob))
        blob += s + b"\0" * (len(s) % 2)

    def entry(tag, typ, vals):
        data = struct.pack(byte_order + ("H" if typ == 3 else "I") * len(vals), *vals)
        if len(data) > 4:
            field = struct.pack(byte_order + "I", len(blob))
            blob.extend(data)
        else:
            field = data.ljust(4, b"\0")
        return struct.pack(byte_order + "HHI", tag, typ, len(vals)) + field

    entries = [
        entry(256, 4, [w]), entry(257, 4, [h]), entry(258, 3, [8 * img.dtype.itemsize] * spp), entry(259, 3, [5]),
        entry(262, 3, [1 if spp == 1 else 2]), entry(273, 4, offsets), entry(277, 3, [spp]),
        entry(278, 4, [rows_per_strip]), entry(279, 4, [len(s) for s in strips]), entry(284, 3, [1]), entry(317, 3, [2]),
    ]
    ifd = len(blob)
    blob += struct.pack(byte_order + "H", len(entries)) + b"".join(entries) + b"\0\0\0\0"
    blob[:8] = (b"II" if byte_order == "<" else b"MM") + struct.pack(byte_order + "HI", 42, ifd)
    return bytes(blob)


def run_main(folder, form, n_images, env=None, per_image=None, redos=1, tag=None, devices=None):
    """``main`` on ``folder`` in one post-processing form (and ``env``'s
    other variables), on the card (``devices``: on that mesh), with every
    launch counter, the fallback counts and the stage tracer set to 0 just
    before and read just after; checks the launches (``per_image``, by
    default the form's ``PER_IMAGE_LAUNCHES``, times ``n_images``) and the
    host redos (one: each folder holds the crowded image).  Returns
    (launches, stages, wall s)."""
    from ecseg_torch.core.config import Config
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import packing
    from ecseg_torch.pipelines import metaseg
    from ecseg_torch.runtime import fallbacks, trace

    per_image = PER_IMAGE_LAUNCHES[form] if per_image is None else per_image
    tag = tag or f"{form} form"
    tracer = trace.tracer()
    with post_form(form), environ(env or {}):
        fallbacks.reset()
        tracer.reset()
        K.reset_launches()
        packing.reset_fetched()
        t0 = time.perf_counter()
        where = {"devices": devices} if devices is not None else {"device": "cuda"}
        check(metaseg.main(config=Config(raw={"metaseg": {"inpath": folder}}), **where) == 0, f"metaseg.main ({tag}) did not return 0")
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        stages = tracer.times()
        fetched = dict(packing.FETCHED)
    print(f"main path, {tag}: {n_images} images of {SIZE}x{SIZE} in {wall:.3f} s; launches {launches}", flush=True)
    for key, n in per_image.items():
        check(launches[key] == n * n_images, f"{tag}: {key} launched {launches[key]} times, expected {n * n_images}")
    want = {fallbacks.META_POST_OK: redos} if redos else {}
    check(fallbacks.counts() == want, f"{tag}: fallbacks {fallbacks.counts()} != {want}")
    # the labels cross as one 2-bit blob a canvas, the raw int32 map only
    # for a host redo; the host-post path fetches no packed result
    device_post = (env or {}).get("ECSEG_DEVICE_PIPELINE") != "0"
    want_bytes = n_images * metaseg_blob_bytes(SIZE, SIZE) + redos * SIZE * SIZE * 4 if device_post else 0
    check(fetched["bytes"] == want_bytes, f"{tag}: {fetched['bytes']} bytes fetched, expected {want_bytes}")
    print(f"main path, {tag}: device->host {fetched['bytes'] / n_images:.0f} B an image in {fetched['copies']} copies, "
          f"copy {1e3 * fetched['seconds'] / n_images:.3f} ms an image", flush=True)
    for name, ts in sorted(stages.items()):
        print(f"  stage {name:22s} n={len(ts)} total {sum(ts):.4f} s; per run ms: " + " ".join(f"{1e3 * t:.2f}" for t in ts), flush=True)
    return launches, stages, wall


def metaseg_blob_bytes(h, w):
    """One canvas's packed result: a header row and the labels 2 bits a
    pixel, (h + 1) * ceil(w / 4) bytes."""
    return (h + 1) * -(-w // 4)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def check_same_outputs(sub, ref, names, counts, tag):
    """``labels/*.npy`` and ``labels/*.png`` of ``names`` in ``sub``
    byte-equal to ``ref``'s, and ``sub``'s CSV rows ``counts``' in ``sub``'s
    listing order (the input order main keeps)."""
    from ecseg_torch.core import imgio

    for name in names:
        for ext in (".npy", ".png"):
            f = os.path.join("labels", name[:-4] + ext)
            check(read_bytes(os.path.join(sub, f)) == read_bytes(os.path.join(ref, f)), f"{tag}: {f} bytes != the default run's")
    order = [os.path.basename(p) for p in imgio.get_imgs(sub)]
    want = ["image name,# of ec"] + [f"{n},{counts[n]}" for n in order]
    with open(os.path.join(sub, "ec_quantification.csv")) as f:
        rows = f.read().splitlines()
    check(rows == want, f"{tag}: CSV rows {rows} != {want}")


FETCH_REPS = 10  # host-clock repetitions of a timed copy (the median is kept)


def host_median_ms(fn, reps=FETCH_REPS):
    """The median host ms of ``fn()`` over ``reps`` calls, each started on
    an idle card."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def metaseg_transfers(model, folder, name, fetched, n_images):
    """The main path's device->host bytes and copies an image (``fetched``:
    the default run's ``packing.FETCHED``), and on ``name``'s canvas the
    median ms of the blob's copy + host decode (the path's fetch) beside the
    copy of the same labels as the int64 canvas (the unpacked form)."""
    from ecseg_torch.ops import meta_post_gpu as mpg
    from ecseg_torch.ops import packing
    from ecseg_torch.pipelines import metaseg

    patches, pos = metaseg._prepare_image(os.path.join(folder, name), save_dapi=False)
    raw = metaseg.segment_raw(model, patches, pos)
    blob = metaseg.post_blob(raw)
    labels = mpg.meta_inference_gpu(raw)[0].long()
    ok, packed_labels, _ = metaseg.decode_post_blob(packing.fetch(blob), raw.shape[1])
    check(ok and np.array_equal(packed_labels, labels.cpu().numpy()), f"{name}: the blob's labels != the int64 canvas")
    out = {"images": n_images, "bytes_per_image": fetched["bytes"] / n_images, "copies": fetched["copies"],
           "copy_ms_per_image": 1e3 * fetched["seconds"] / n_images, "blob_bytes": blob.numel(),
           "fetch_ms": host_median_ms(lambda: metaseg.decode_post_blob(packing.fetch(blob), raw.shape[1])),
           "int64_bytes": labels.numel() * 8, "int64_fetch_ms": host_median_ms(lambda: labels.cpu())}
    print(f"metaseg transfers: {out['bytes_per_image']:.0f} B an image device->host in {out['copies']} copies for {n_images} images "
          f"(one {out['blob_bytes']} B blob a canvas, the crowded image's raw map for its redo); blob copy + decode "
          f"{out['fetch_ms']:.3f} ms against {out['int64_fetch_ms']:.3f} ms for the int64 canvas ({out['int64_bytes']} B)", flush=True)
    return out


def phase_main_path(args, rng, dev, errors, results):
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.models.weights import params_to_numpy, save_npz
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import meta_post_gpu as mpg
    from ecseg_torch.ops import packing, tiling
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
        fetched = dict(packing.FETCHED)  # run_main's counts of this run
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
        results["transfers"] = {"metaseg": metaseg_transfers(model, folder, names[0], fetched, len(names))}
        # the images and the labels metaseg wrote for them: phase_train's data
        keep = tempfile.mkdtemp(prefix="ecseg_train_data_")
        os.makedirs(os.path.join(keep, "labels"))
        for name in names:
            shutil.copy(os.path.join(folder, name), keep)
            shutil.copy(os.path.join(folder, "labels", name[:-4] + ".npy"), os.path.join(keep, "labels"))
        results["train_folder"] = keep
        # the folder with the default run's outputs and the weights: phase_multidevice's input and reference
        keep = tempfile.mkdtemp(prefix="ecseg_multidevice_metaseg_")
        shutil.copytree(os.path.join(work, "models"), os.path.join(keep, "models"))
        shutil.copytree(folder, os.path.join(keep, "imgs"))
        results["multidevice_metaseg"] = keep
        # the images and the .npz run's labels/*.npy and CSV: phase_keras_h5's input and reference
        keep = os.path.join(tempfile.mkdtemp(prefix="ecseg_keras_h5_metaseg_"), "npz_run")
        os.makedirs(os.path.join(keep, "labels"))
        for name in names:
            shutil.copy(os.path.join(folder, name), keep)
            shutil.copy(os.path.join(folder, "labels", name[:-4] + ".npy"), os.path.join(keep, "labels"))
        shutil.copy(os.path.join(folder, "ec_quantification.csv"), keep)
        results["keras_h5_metaseg"] = keep
        print(f"main path outputs equal the host oracle; ok flags {oks}; ec counts {counts}", flush=True)

        # byte-identical rerun of one image
        again = os.path.join(work, "again")
        os.makedirs(again)
        shutil.copy(os.path.join(folder, names[0]), again)
        runs = []
        with post_form("default"):
            for _ in range(2):
                check(metaseg.main(config=Config(raw={"metaseg": {"inpath": again}}), device="cuda") == 0, "rerun failed")
                runs.append(read_bytes(os.path.join(again, "labels", "img0.npy")))
        runs.append(read_bytes(os.path.join(folder, "labels", "img0.npy")))
        check(runs[0] == runs[1] == runs[2], "labels/*.npy bytes differ between runs")

        # the dispatch: main groups the images of a geometry (at 2048^2, 100
        # patches an image, two a forward: 2 + 2, the crowded image in the
        # second group); per image and 3 + 1 give the same bytes and launches
        check(len(stages["metaseg.forward"]) == 2, f"default run: {len(stages['metaseg.forward'])} forwards, expected 2 groups")
        results["grouped"] = {"2 + 2 (first run)": {"wall_s": wall, "ms_per_image": 1e3 * wall / len(names), "forwards": 2}}
        for k, (run, env, forwards) in enumerate(GROUP_RUNS):
            sub = os.path.join(work, f"group{k}")
            os.makedirs(sub)
            for name in names:
                shutil.copy(os.path.join(folder, name), sub)
            torch.cuda.reset_peak_memory_stats()
            _, stages_g, wall_g = run_main(sub, "default", len(names), env=env, tag=f"grouping {run}")
            peak, reserved = (f() / 2**30 for f in (torch.cuda.max_memory_allocated, torch.cuda.max_memory_reserved))
            check(len(stages_g["metaseg.forward"]) == forwards, f"grouping {run}: {len(stages_g['metaseg.forward'])} forwards, expected {forwards}")
            check_same_outputs(sub, folder, names, counts, f"grouping {run}")
            results["grouped"][run] = {"wall_s": wall_g, "ms_per_image": 1e3 * wall_g / len(names), "forwards": forwards,
                                       "forward_ms": [1e3 * t for t in stages_g["metaseg.forward"]], "peak_gib": peak, "reserved_gib": reserved}
        print(f"grouped dispatch: labels, PNGs and CSV rows byte-equal across {sorted(results['grouped'])}; "
              + "; ".join(f"{run}: {r['ms_per_image']:.1f} ms an image, peak {r.get('peak_gib', float('nan')):.2f} GiB"
                          for run, r in results["grouped"].items()), flush=True)

        # ECSEG_DEVICE_PIPELINE=0: the forward and B1 on the card, the host
        # oracle after them, on an ordinary image and the crowded one
        pair = ["img0.tif", "img2.tif"]
        sub = os.path.join(work, "host_post")
        os.makedirs(sub)
        for name in pair:
            shutil.copy(os.path.join(folder, name), sub)
        _, stages_h, wall_h = run_main(sub, "default", len(pair), env={"ECSEG_DEVICE_PIPELINE": "0"}, per_image=HOST_POST_LAUNCHES,
                                       redos=0, tag="ECSEG_DEVICE_PIPELINE=0")
        check_same_outputs(sub, folder, pair, counts, "ECSEG_DEVICE_PIPELINE=0")
        results["host_post"] = {"images": pair, "wall_s": wall_h, "stages": stages_h}
        print(f"ECSEG_DEVICE_PIPELINE=0: only B1 and the forward's H1 launched; labels, PNGs and CSV rows byte-equal to the device run's on {pair}", flush=True)

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
        results["conv3x3_forward"] = conv3x3_forward_check(model, [os.path.join(folder, n) for n in names])
        print(f"forward card vs CPU on 2 patches: max |diff| {fwd_err:.3g} (< 2e-5)", flush=True)

        # the main path's own inputs for the kernel timings (image 0)
        with torch.no_grad():
            lp = tiling.patch_labels(model(torch.from_numpy(patches).to(dev)))
        results["inputs"] = (lp, pos, K.stitch_labels(lp, pos))
        results["metaseg_patches"] = (patches, pos)  # image 0's, for phase_keras_import
    finally:
        tracer.enabled = False
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        # the allocator's cache from the grouped forwards (up to 300 patches)
        # held most of the card and left the later phases' command lines
        # out of memory
        torch.cuda.empty_cache()


def phase_command_line(args, rng, dev, results):
    """``python3 -m ecseg_torch.pipelines.metaseg`` as a user runs it: a
    subprocess on the default device, in a directory holding a
    ``config.yaml`` (read by the port's own YAML reader) whose
    ``metaseg.inpath`` names a folder with a copy of the repository's
    ``example_ecSeg/input.tif`` (LZW, predictor 2) and one synthetic 2048^2
    image that this phase writes as LZW itself (no cv2 here), and
    ``models/metaseg.npz`` from the demo weights.  Checks: exit code 0; two
    CSV rows; every ``labels/*.npy`` equal to the host oracle on the raw
    canvas and byte-equal to an in-process ``main`` on a copy of the
    folder.  Prints the host decode times of both files."""
    import importlib.util

    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.models.weights import params_to_numpy, save_npz
    from ecseg_torch.ops.meta_post import meta_inference
    from ecseg_torch.pipelines import metaseg

    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="ecseg_cli_")
    cwd = os.getcwd()
    try:
        save_npz(os.path.join(work, "models", "metaseg.npz"), params_to_numpy(demo_metaseg_params(torch.Generator().manual_seed(args.seed))))
        names = ["input.tif", "synth2048.tif"]
        img = synthetic_dapi(rng, SIZE, SIZE, crowded=False)
        t0 = time.perf_counter()
        lzw = lzw_tiff_bytes(img)
        encode_s = time.perf_counter() - t0
        for sub in ("imgs", "inproc"):
            os.makedirs(os.path.join(work, sub))
            shutil.copy(os.path.join(root, "example_ecSeg", "input.tif"), os.path.join(work, sub, names[0]))
            with open(os.path.join(work, sub, names[1]), "wb") as f:
                f.write(lzw)
        decode_s = {}
        for name in names:
            path = os.path.join(work, "imgs", name)
            with open(path, "rb") as f:
                tags = imgio._tiff_header(f.read())[1]
            check(tags[259] == (5,) and tags[317] == (2,), f"{name}: not LZW with the predictor ({tags.get(259)}, {tags.get(317)})")
            imgio.imread_rgb(path)  # builds the host decoder once
            t0 = time.perf_counter()
            got = imgio.imread_rgb(path)
            decode_s[name] = time.perf_counter() - t0
            check(got.dtype == np.uint16 and got.shape == ((700, 900) if name == names[0] else (SIZE, SIZE)), f"{name}: decoded {got.dtype} {got.shape}")
        check(np.array_equal(got, img), "the 2048^2 LZW file does not decode to the image written")
        with open(os.path.join(work, "config.yaml"), "w") as f:
            f.write("# metaseg only, as in the repository's config.yaml\nmetaseg:\n  inpath: ./imgs\n")
        missing = {m: importlib.util.find_spec(m) is None for m in ("yaml", "cv2")}
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ecseg_torch.pipelines.metaseg"], cwd=work, env=env, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m ecseg_torch.pipelines.metaseg exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(os.path.join(work, "imgs", "ec_quantification.csv")) as f:
            rows = f.read().splitlines()
        check(rows[0] == "image name,# of ec" and sorted(r.rsplit(",", 1)[0] for r in rows[1:]) == names, f"command line's CSV rows {rows}")
        os.chdir(work)
        model = metaseg.load_model(device=dev)
        with post_form("default"):
            check(metaseg.main(config=Config(raw={"metaseg": {"inpath": os.path.join(work, "inproc")}}), device="cuda") == 0, "in-process main failed")
            for name in names:
                npy = os.path.join("labels", name[:-4] + ".npy")
                out = np.load(os.path.join(work, "imgs", npy))
                patches, pos = metaseg._prepare_image(os.path.join(work, "imgs", name), save_dapi=False)
                raw = metaseg.segment_raw(model, patches, pos)
                check(np.array_equal(out, meta_inference(raw.cpu().numpy().astype(np.int64))), f"command line: {name} labels != host oracle")
                check(read_bytes(os.path.join(work, "imgs", npy)) == read_bytes(os.path.join(work, "inproc", npy)), f"command line: {npy} bytes != in-process run's")
        check(read_bytes(os.path.join(work, "imgs", "ec_quantification.csv")) == read_bytes(os.path.join(work, "inproc", "ec_quantification.csv")), "command line: CSV bytes != in-process run's")
        results["command_line"] = {
            "wall_s": cli_s, "decode_s": decode_s, "lzw_bytes": {names[1]: len(lzw)}, "encode_s": encode_s,
            "not_installed": missing, "csv_rows": rows[1:],
        }
        print(
            f"command line: python -m ecseg_torch.pipelines.metaseg on {names} in {cli_s:.2f} s (process start and "
            f"kernel build included), rc 0; not installed here: {missing}; labels equal the host oracle and an "
            f"in-process run's bytes; host decode input.tif (900x700 uint16 LZW) {1e3 * decode_s[names[0]]:.2f} ms, "
            f"2048^2 uint16 LZW ({len(lzw)} bytes) {1e3 * decode_s[names[1]]:.2f} ms", flush=True,
        )
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)


def synthetic_overlay_rgb(rng, h, w, dim=False):
    """uint16 RGB input of meta_overlay: blue is ``synthetic_dapi``; green
    and red are seeded FISH signal on black: 3x3 dots (9 px, under the HSR
    size filter's 20) on the ecDNA dots, some in both channels, on the
    nuclei (which the statistics mask out) and on the background, and 6x6
    blobs (36 px) that the filter keeps.  With ``dim`` every FISH pixel is
    20000 (78 after the 8-bit conversion, below color_sensitivity 85)."""
    blue = synthetic_dapi(rng, h, w, crowded=False)
    red, green = np.zeros((h, w), np.uint16), np.zeros((h, w), np.uint16)
    level = 20000 if dim else 50000
    ec, nuc = np.argwhere(blue == 60000), np.argwhere(blue == 33000)
    anywhere = np.stack([rng.integers(0, h, 4000), rng.integers(0, w, 4000)], 1)

    def dots(channels, points, n, size):
        for y, x in points[rng.integers(0, len(points), n)]:
            for ch in channels:
                ch[y : y + size, x : x + size] = level

    dots([green], ec, 60, 3)
    dots([red], ec, 60, 3)
    dots([red, green], ec, 30, 3)
    dots([green], nuc, 40, 3)
    dots([red], nuc, 40, 3)
    dots([green], anywhere, 150, 3)
    dots([red], anywhere, 150, 3)
    dots([green], anywhere, 20, 6)
    dots([red], anywhere, 20, 6)
    dots([red, green], anywhere, 10, 6)
    return np.stack([red, green, blue], axis=-1)


def overlay_host_row(name, red, green, nuclei, chrom, ec):
    """One fish_quantification.csv row from the port's host oracles (the
    reference's dataflow, meta_overlay.py:68-83, on scipy): the branch
    ``meta_overlay.main`` takes under ``ECSEG_DEVICE_PIPELINE=0``."""
    from ecseg_torch.pipelines.meta_overlay import host_stats, image_row

    return image_row(name, host_stats(red, green, nuclei, chrom, ec), nuclei.size)


def read_png_gray(path):
    """Pixels of an 8-bit grayscale PNG (colour type 0, no interlace) whose
    rows all use filter 0, as ``imgio.write_png_gray`` writes them; anything
    else fails the check."""
    import zlib

    buf = read_bytes(path)
    check(buf[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos : pos + 4])
        tag, data = buf[pos + 4 : pos + 8], buf[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = ihdr
    check((depth, ctype, interlace) == (8, 0, 0), f"{path}: PNG header {ihdr}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    check(not rows[:, 0].any(), f"{path}: a row filter other than 0")
    return rows[:, 1:]


def phase_meta_overlay(args, rng, dev, errors, results):
    """``make metaseg && make meta_overlay`` as a user runs them: in a
    directory with a ``config.yaml`` holding both sections and the demo
    weights, on a folder of three 2048^2 RGB uint16 LZW TIFFs (blue a
    ``synthetic_dapi`` image, red and green seeded FISH signal; the third
    image's FISH all below color_sensitivity) and one grayscale TIFF,
    ``python3 -m ecseg_torch.pipelines.metaseg`` and then ``python3 -m
    ecseg_torch.pipelines.meta_overlay`` (with ``ECSEG_TRACE=1``), then
    ``meta_overlay.main`` in-process on a copy of the folder with every
    launch counter set to 0 just before and read just after.  Checks: exit
    codes 0; three CSV rows (the grayscale image skipped), byte-equal to the
    in-process run's and to the host oracle's on the same ``labels/*.npy``
    and thresholded channels; each ``red/`` and ``green/`` PNG decodes to
    255 - the channel; ``OVERLAY_LAUNCHES`` per RGB image; B8a bit-equal to
    its twin on every image's ec, fish_nc and fish2_nc masks; and
    ``overlay_stats`` on the card equal to the host oracle on image 0 with
    seeded chromosome blobs in place of its (empty) chromosome class."""
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.models.weights import params_to_numpy, save_npz
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops.overlay_gpu import overlay_stats
    from ecseg_torch.pipelines import meta_overlay
    from ecseg_torch.pipelines.metaseg import write_csv
    from ecseg_torch.runtime import trace

    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="ecseg_overlay_")
    try:
        save_npz(os.path.join(work, "models", "metaseg.npz"), params_to_numpy(demo_metaseg_params(torch.Generator().manual_seed(args.seed))))
        imgs = os.path.join(work, "imgs")
        os.makedirs(imgs)
        names = [f"fish{k}.tif" for k in range(3)]
        rgbs = [synthetic_overlay_rgb(rng, SIZE, SIZE, dim=k == 2) for k in range(3)]
        t0 = time.perf_counter()
        for n, img in zip(names, rgbs):
            imgio.write_tiff_lzw(os.path.join(imgs, n), img)
        encode_s = time.perf_counter() - t0
        imgio.write_tiff(os.path.join(imgs, "gray.tif"), synthetic_dapi(rng, SIZE, SIZE, crowded=False))
        t0 = time.perf_counter()
        got = imgio.imread_rgb(os.path.join(imgs, names[0]))
        decode_s = time.perf_counter() - t0
        check(got.dtype == np.uint16 and np.array_equal(got, rgbs[0]), "the RGB LZW file does not decode to the image written")
        with open(os.path.join(work, "config.yaml"), "w") as f:
            f.write(f"metaseg:\n  inpath: ./imgs\nmeta_overlay:\n  inpath: ./imgs\n  color_sensitivity: {OVERLAY_SENSITIVITY}\n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        cli_s = {}
        procs = {}
        for task, extra in (("metaseg", {}), ("meta_overlay", {"ECSEG_TRACE": "1"})):
            t0 = time.perf_counter()
            procs[task] = subprocess.run([sys.executable, "-m", f"ecseg_torch.pipelines.{task}"], cwd=work, env=dict(env, **extra),
                                         capture_output=True, text=True, timeout=600)
            cli_s[task] = time.perf_counter() - t0
            check(procs[task].returncode == 0, f"python -m ecseg_torch.pipelines.{task} exited {procs[task].returncode}:\n{procs[task].stdout[-2000:]}\n{procs[task].stderr[-4000:]}")
            if task == "metaseg":
                with open(os.path.join(imgs, "ec_quantification.csv")) as f:
                    check(len(f.read().splitlines()) == 5, "metaseg's CSV does not hold four rows")
                inproc, host_dir = os.path.join(work, "inproc"), os.path.join(work, "host_stats")
                shutil.copytree(imgs, inproc)  # metaseg's outputs, before meta_overlay's
                shutil.copytree(imgs, host_dir)
        out = procs["meta_overlay"].stdout
        check("isn't an RGB image" in out, "meta_overlay did not skip the grayscale image")
        print("meta_overlay command line's stage table:\n" + out[out.find("[ecseg trace]"):].strip(), flush=True)

        tracer = trace.tracer()
        tracer.enabled = True
        tracer.reset()
        K.reset_launches()
        t0 = time.perf_counter()
        rc = meta_overlay.main(config=Config(raw={"meta_overlay": {"inpath": inproc, "color_sensitivity": OVERLAY_SENSITIVITY}}), device="cuda")
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        stages = tracer.times()
        tracer.enabled = False
        check(rc == 0, f"in-process meta_overlay.main returned {rc}")
        for key, n in OVERLAY_LAUNCHES.items():
            check(launches[key] == n * len(names), f"meta_overlay: {key} launched {launches[key]} times, expected {n * len(names)}")
        csv_path = lambda d: os.path.join(d, "fish_quantification.csv")
        lines = read_bytes(csv_path(imgs)).decode().splitlines()
        check(len(lines) == 4, f"fish_quantification.csv rows: {lines}")
        check(read_bytes(csv_path(imgs)) == read_bytes(csv_path(inproc)), "meta_overlay command line: CSV bytes != in-process run's")

        # ECSEG_DEVICE_PIPELINE=0: the host statistics, no kernel
        K.reset_launches()
        t0 = time.perf_counter()
        with environ({"ECSEG_DEVICE_PIPELINE": "0"}):
            rc = meta_overlay.main(config=Config(raw={"meta_overlay": {"inpath": host_dir, "color_sensitivity": OVERLAY_SENSITIVITY}}), device="cuda")
        host_wall = time.perf_counter() - t0
        check(rc == 0 and not any(K.LAUNCHES.values()), f"meta_overlay under ECSEG_DEVICE_PIPELINE=0: rc {rc}, launches {dict(K.LAUNCHES)}")
        check(read_bytes(csv_path(host_dir)) == read_bytes(csv_path(inproc)), "meta_overlay under ECSEG_DEVICE_PIPELINE=0: CSV bytes != the device run's")
        for sub in ("red", "green"):
            for f in sorted(os.listdir(os.path.join(inproc, sub))):
                check(read_bytes(os.path.join(host_dir, sub, f)) == read_bytes(os.path.join(inproc, sub, f)), f"meta_overlay under ECSEG_DEVICE_PIPELINE=0: {sub}/{f} bytes differ")
        print(f"meta_overlay under ECSEG_DEVICE_PIPELINE=0: no kernel launched, CSV and PNG bytes equal the device run's, {host_wall:.3f} s", flush=True)

        # the host oracle on the same label maps and thresholded channels
        rows, fish2_nc = [], None
        for path in imgio.get_imgs(imgs):
            name = os.path.basename(path)
            if name not in names:
                continue
            u8 = imgio.u16_to_u8(rgbs[names.index(name)])
            for ch, sub in ((0, "red"), (1, "green")):
                check(np.array_equal(read_png_gray(os.path.join(imgs, sub, name + ".png")), 255 - u8[..., ch]), f"{sub}/{name}.png != 255 - the channel")
            red, green = u8[..., 0] > OVERLAY_SENSITIVITY, u8[..., 1] > OVERLAY_SENSITIVITY
            seg = np.load(os.path.join(imgs, "labels", name[:-4] + ".npy"))
            nuclei, chrom, ec = seg == 1, seg == 2, seg == 3
            rows.append(overlay_host_row(name, red, green, nuclei, chrom, ec))
            fish_nc = green & ~nuclei & ~chrom
            masks = {"ec": ec, "fish_nc": fish_nc, "fish2_nc": red & ~nuclei & ~chrom}
            for mname, m in masks.items():
                mt = torch.from_numpy(m).to(dev)
                for conn in (1, 2):
                    errors.compare("count", K.count_components(mt, conn), K.count_components_plain(mt, conn), f"{name}'s {mname} mask conn {conn}")
            if name == names[0]:
                fish2_nc = torch.from_numpy(masks["fish2_nc"]).to(dev)
                blobs = np.zeros_like(chrom)
                for y, x in rng.integers(0, SIZE - 40, (300, 2)):
                    blobs[y : y + int(rng.integers(5, 40)), x : x + int(rng.integers(5, 40))] = True
                blobs &= ~ec
                want = overlay_host_row(name, red, green, nuclei, blobs, ec)
                stats = overlay_stats(red, green, nuclei, blobs, ec, device=dev)
                got = meta_overlay.image_row(name, stats, SIZE * SIZE)
                check(got == want, f"overlay_stats with chromosome blobs: {got} != host oracle {want}")
                check(want[-1] > 0 and want[-2] > 0, f"the chromosome blobs hold no FISH blob of 20 px or more: {want}")
        oracle = os.path.join(work, "oracle.csv")
        write_csv(oracle, [c for c, _ in meta_overlay.COLUMNS], rows)
        check(read_bytes(oracle) == read_bytes(csv_path(imgs)), f"meta_overlay CSV != host oracle's:\n{read_bytes(csv_path(imgs)).decode()}\n{read_bytes(oracle).decode()}")
        dim_row = next(ln for ln in lines[1:] if ln.startswith(names[2] + ","))
        check(dim_row.count('"(0, 0.0)"') == 2, f"the dim image's FISH counts are not (0, 0.0): {dim_row}")
        results["overlay_launches"] = launches
        results["multidevice_overlay"] = shutil.move(inproc, tempfile.mkdtemp(prefix="ecseg_multidevice_overlay_"))
        results["overlay_fish2_nc"] = fish2_nc
        results["overlay"] = {
            "images": len(names), "wall_s": wall, "stages_s": stages, "cli_s": cli_s, "encode_s": encode_s,
            "decode_s": decode_s, "launches": {k: v for k, v in launches.items() if v}, "csv_rows": lines[1:],
            "host_stats_wall_s": host_wall,
        }
        print(
            f"meta_overlay: command lines metaseg {cli_s['metaseg']:.2f} s, meta_overlay {cli_s['meta_overlay']:.2f} s (process start "
            f"included); in-process main on {len(names)} RGB images + 1 grayscale in {wall:.3f} s; launches {results['overlay']['launches']}; "
            f"CSV equals the host oracle and the command line's; PNGs decode to 255 - channel; RGB LZW decode {1e3 * decode_s:.1f} ms, "
            f"3 encodes (imgio.write_tiff_lzw) {encode_s:.2f} s", flush=True,
        )
        for name, ts in sorted(stages.items()):
            print(f"  stage {name:24s} n={len(ts)} total {sum(ts):.4f} s; per image ms: " + " ".join(f"{1e3 * t:.2f}" for t in ts), flush=True)
        print("fish_quantification.csv:\n" + "\n".join(lines), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def synthetic_cells(rng, h, w, n_cells):
    """A stat_fish-like segmentation (int64 discs, 0 background) and an RGB
    uint8 LSQ image with two red, three green and four blue probe pixels in
    each cell (tests/test_fish_distance.py's generator at another size, with
    few enough red blobs that most cells pass max_centromeric_spots 3)."""
    seg = np.zeros((h, w), np.int64)
    lsq = np.zeros((h, w, 3), np.uint8)
    yy, xx = np.ogrid[:h, :w]
    for lab in range(1, n_cells + 1):
        cy, cx, r = rng.integers(20, h - 20), rng.integers(20, w - 20), int(rng.integers(10, 18))
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2 <= r * r) & (seg == 0)
        seg[disk] = lab
        ys, xs = np.nonzero(disk)
        for ch, k in ((0, 2), (1, 3), (2, 4)):
            take = rng.choice(len(ys), size=min(k, len(ys)), replace=False) if len(ys) else []
            lsq[ys[take], xs[take], ch] = 200
    return seg, lsq


def phase_fish_distance(rng, results):
    """``python3 -m ecseg_torch.pipelines.fish_distance`` (host only, no
    kernel) on a synthetic stat_fish output folder: two images, each with
    ``annotated/<name>/<name>__segmentation_min_cut.npy`` and an LZW RGB
    ``<name>_lsq.tif``.  Checks: exit code 0 and CSV bytes equal to an
    in-process host computation (``folder_distances`` + ``write_csv``)."""
    from ecseg_torch.core import imgio
    from ecseg_torch.pipelines import fish_distance
    from ecseg_torch.pipelines.metaseg import write_csv

    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="ecseg_fishdist_")
    try:
        folder = os.path.join(work, "interseg")
        os.makedirs(folder)
        for k in range(2):
            name = f"cells{k}"
            seg, lsq = synthetic_cells(rng, 512, 512, 40)
            imgio.write_tiff(os.path.join(folder, f"{name}.tif"), lsq)
            ann = os.path.join(folder, "annotated", name)
            os.makedirs(ann)
            np.save(os.path.join(ann, f"{name}__segmentation_min_cut.npy"), seg)
            with open(os.path.join(ann, f"{name}_lsq.tif"), "wb") as f:
                f.write(lzw_tiff_bytes(lsq))
        with open(os.path.join(work, "config.yaml"), "w") as f:
            f.write("fish_distance_calculation:\n  inpath: ./interseg\n  centromere_probe_color: green\n"
                    "  fish_probe_color: red\n  max_centromeric_spots: 3\n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ecseg_torch.pipelines.fish_distance"], cwd=work, env=env,
                              capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m ecseg_torch.pipelines.fish_distance exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        distances = fish_distance.folder_distances(folder, 1, 0, 3)
        want = os.path.join(work, "want.csv")
        write_csv(want, ["normalized_distance"], [(d,) for d in distances])
        got = read_bytes(os.path.join(folder, "centromere_distances.csv"))
        check(got == read_bytes(want), "fish_distance command line: CSV bytes != the in-process host computation's")
        check(len(distances) > 10 and all(np.isfinite(distances)), f"fish_distance: {len(distances)} distances, finite {np.isfinite(distances).all()}")
        results["fish_distance"] = {"cli_s": cli_s, "rows": len(distances)}
        print(f"fish_distance command line: {len(distances)} distances in {cli_s:.2f} s (process start included), CSV equals the host computation", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def synthetic_interphase_rgb(rng, h, w, amp_rng=None):
    """uint16 RGB input of stat_fish: blue nuclei (discs of radius 40-60 px
    on noise, every third with a touching twin whose centre lies 2.1 radii
    away, which NuSeT's mask joins and the min-cut splits), red and green
    foci of 3-5 px inside the nuclei and a few outside, on noise.  With
    ``amp_rng`` (its own generator, so ``rng``'s draws stay as they were)
    the red probe is amplified as interseg's classes look: every second
    nucleus gets 15-40 more red foci (ecDNA-like) and every sixth a bright
    red blob of half its radius (HSR-like); the others stay below
    interseg's target-brightness gate."""
    red, green, blue = ((rng.random((h, w)) * level).astype(np.uint16) for level in (4000, 4000, 6000))
    yy, xx = np.ogrid[:h, :w]
    nuclei = []
    for k in range(h * w // 90000):
        r = int(rng.integers(40, 60))
        cy, cx = int(rng.integers(r + 30, h - r - 30)), int(rng.integers(r + 30, w - 3 * r - 30))
        for x in (cx, cx + int(2.1 * r)) if k % 3 == 0 else (cx,):
            blue[(yy - cy) ** 2 + (xx - x) ** 2 <= r * r] = 40000 + int(rng.integers(0, 8000))
            nuclei.append((cy, x, r))
    for ch in (red, green):
        for cy, cx, r in nuclei:
            for _ in range(int(rng.integers(1, 4))):
                y, x, s = cy + int(rng.integers(-r // 2, r // 2)), cx + int(rng.integers(-r // 2, r // 2)), int(rng.integers(3, 6))
                ch[y : y + s, x : x + s] = 50000 + int(rng.integers(0, 15000))
        for y, x in zip(rng.integers(0, h - 5, 20), rng.integers(0, w - 5, 20)):
            ch[y : y + 4, x : x + 4] = 52000
    if amp_rng is not None:
        for k, (cy, cx, r) in enumerate(nuclei):
            if k % 6 == 5:
                red[(yy - cy) ** 2 + (xx - cx) ** 2 <= (r // 2) ** 2] = 50000 + int(amp_rng.integers(0, 10000))
            elif k % 2 == 1:
                for _ in range(int(amp_rng.integers(15, 41))):
                    y, x, s = cy + int(amp_rng.integers(-r // 2, r // 2)), cx + int(amp_rng.integers(-r // 2, r // 2)), int(amp_rng.integers(3, 6))
                    red[y : y + s, x : x + s] = 45000 + int(amp_rng.integers(0, 20000))
    return np.stack([red, green, blue], axis=-1)


def confident_nuset_tree(seed):
    """The demo NuSeT tree (``models/demo.py``) with a class-1 bias of 6 on
    every anchor of its RPN's score head: every proposal scores about
    0.9975, above min_score 0.95, so the watershed runs with markers (the
    seeded RPN alone scores about 0.5 and places none)."""
    from ecseg_torch.models.demo import demo_nuset_tree

    tree = demo_nuset_tree(torch.Generator().manual_seed(seed))
    tree["fg"]["rpn"]["rpn_cls_score"]["bias"][1::2] = 6.0
    return tree


def touching_nuclei_case(rng, h, w, n):
    """A NuSeT-geometry mask of n discs, many touching, and one proposal
    (x1, y1, x2, y2) around each, scored 0.97: the watershed with
    hand-placed markers."""
    yy, xx = np.ogrid[:h, :w]
    mask = np.zeros((h, w), bool)
    props = []
    for _ in range(n):
        r = int(rng.integers(8, 18))
        cy, cx = int(rng.integers(30, h - 30)), int(rng.integers(30, w - 30))
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        props.append([cx - r, cy - r, cx + r, cy + r])
    return mask.astype(np.float32), np.full(n, 0.97, np.float32), np.array(props, np.float32)


def stat_fish_transfers(fetched, n_images, fast_passes, nms_kept, redone):
    """stat_fish's device->host bytes and copies an image in the default
    (``auto``) run, checked against its packed layouts: per image the two
    NuSeT passes' masks and the cleanup's mask 1 bit a pixel, the matched
    filter's two center maps 1 bit a pixel, the NMS's suppression matrix
    with its row of candidate flags 1 bit a pair, and the kept proposals
    with their scores (``nms_kept`` over the run, 5 float32 each); per
    certified watershed with markers (one B3 launch each) its contour and
    4-byte certificate, and per watershed ``redone`` on the host its two
    int32 flood inputs."""
    from ecseg_torch.models import nuset_infer as ni
    from ecseg_torch.ops import boxes

    side = int(round(SIZE * 0.3)) // 16 * 16  # NuSeT's side at scale_ratio 0.3
    out_h, out_w = ni.output_shape((side, side), 0.3)
    nuset_mask, full_mask = side * -(-side // 8), out_h * -(-out_w // 8)
    n = min(boxes.PRE_NMS_TOP_N, (side // ni.STRIDE) ** 2 * len(ni.SCALES) * len(ni.RATIOS))
    nms = (n + 1) * -(-n // 8)
    want = (n_images * (2 * nuset_mask + 3 * full_mask + nms) + 20 * nms_kept + fast_passes * (nuset_mask + 4)
            + redone * 2 * side * side * 4)
    copies = 6 * n_images + fast_passes + redone
    check(fetched["bytes"] == want and fetched["copies"] == copies,
          f"stat_fish: {fetched} fetched, expected {want} bytes in {copies} copies")
    out = {"images": n_images, "bytes_per_image": fetched["bytes"] / n_images, "copies": fetched["copies"],
           "copy_ms_per_image": 1e3 * fetched["seconds"] / n_images, "nuset_mask_bytes": nuset_mask, "full_mask_bytes": full_mask}
    print(f"stat_fish transfers: {out['bytes_per_image']:.0f} B an image device->host in {out['copies']} copies for {n_images} images, "
          f"copy {out['copy_ms_per_image']:.3f} ms an image", flush=True)
    return out


def phase_stat_fish(args, rng, dev, errors, results):
    """``make stat_fish`` as a user runs it, then its stages against the
    port's host chains.  In a directory with a ``config.yaml`` (stat_fish:
    scale 1, use_min_cut True, nuclei_size_T 5000) and ``models/nuset.npz``
    (``confident_nuset_tree``), on a folder of three 2048^2 RGB uint16 LZW
    TIFFs (``synthetic_interphase_rgb``): ``python3 -m
    ecseg_torch.pipelines.stat_fish`` (``ECSEG_TRACE=1``), then
    ``stat_fish.main`` in-process on a copy of the inputs with every launch
    counter set to 0 just before and read just after.  Checks: exit code 0;
    the CSV and every ``.npy`` byte-equal across the two runs and the TIFFs
    pixel-equal; per image four B2 launches and at most one B3 (one per
    watershed with markers), at least one B3 in all, nothing else; then on
    image 0 and on a 900x700 crop of it (NuSeT width 208, not a multiple of
    32), stage by stage on the same NuSeT outputs: the device watershed
    equal to the host priority flood where its certificate is clean, the
    device cleanup equal to the host chain, the device matched filter equal
    to the host one; B2 (connectivity 1 and 2) and B3 equal to their twins
    on the masks of those stages; and the certified watershed with
    hand-placed proposals on a 608^2 touching-nuclei mask (with its
    certificate counts).  Times: the stage table of both runs, images/s,
    the XLA-side ops' CUDA-event or wall times on image 0, one
    ``torch.profiler`` pass over image 0's segmentation (the device's busy
    share), and B2's and B3's times at stat_fish's geometries."""
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config, load_stat_fish_params
    from ecseg_torch.models import nuset_infer as ni
    from ecseg_torch.models.weights import load_nuset_model, save_npz
    from ecseg_torch.ops import boxes
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import matched_filter as mf
    from ecseg_torch.ops.edt_gpu import edt_sq
    from ecseg_torch.ops.morphology_gpu import binary_fill_holes, clean_image
    from ecseg_torch.ops import packing
    from ecseg_torch.ops.normalization import foreground_norm
    from ecseg_torch.ops.resize import resize_linear_matmul
    from ecseg_torch.ops.watershed import nuset_marker_watershed, nuset_place_markers
    from ecseg_torch.ops.watershed_gpu import lex_flood, nuset_fast_pass, nuset_marker_watershed_auto, nuset_marker_watershed_fast
    from ecseg_torch.pipelines import stat_fish
    from ecseg_torch.runtime import fallbacks, trace

    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="ecseg_stat_fish_")
    phase_t0 = time.perf_counter()
    marks = {}  # seconds into the phase at the end of each part
    try:
        save_npz(os.path.join(work, "models", "nuset.npz"), confident_nuset_tree(args.seed))
        imgs, inproc = os.path.join(work, "imgs"), os.path.join(work, "inproc")
        os.makedirs(imgs)
        names = [f"cells{k}.tif" for k in range(STAT_FISH_IMAGES)]
        amp_rng = np.random.default_rng(args.seed + 8)  # the red amplification interseg classifies
        rgbs = [synthetic_interphase_rgb(rng, SIZE, SIZE, amp_rng) for _ in names]
        t0 = time.perf_counter()
        for n, img in zip(names, rgbs):
            imgio.write_tiff_lzw(os.path.join(imgs, n), img)
        encode_s = time.perf_counter() - t0
        shutil.copytree(imgs, inproc)
        with open(os.path.join(work, "config.yaml"), "w") as f:
            f.write(f"stat_fish:\n  inpath: ./imgs\n  scale: 1\n  use_min_cut: True\n  nuclei_size_T: {STAT_FISH_T}\n")
        env = dict(os.environ, ECSEG_TRACE="1", PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ecseg_torch.pipelines.stat_fish"], cwd=work, env=env,
                              capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m ecseg_torch.pipelines.stat_fish exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        check(proc.stdout.count("Processing image:") == len(names), "the stat_fish command line did not process every image")
        print("stat_fish command line's stage table:\n" + proc.stdout[proc.stdout.find("[ecseg] fallbacks"):].strip(), flush=True)
        marks["inputs and command line"] = time.perf_counter() - phase_t0

        # in-process, from the same working directory (models/nuset.npz)
        cwd = os.getcwd()
        os.chdir(work)
        tracer = trace.tracer()
        tracer.enabled = True
        tracer.reset()
        fallbacks.reset()
        K.reset_launches()
        packing.reset_fetched()
        ni.reset_counts()
        try:
            t0 = time.perf_counter()
            rc = stat_fish.main(config=Config(raw={"stat_fish": {"inpath": inproc, "scale": 1, "use_min_cut": True, "nuclei_size_T": STAT_FISH_T}}), device="cuda")
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launches = dict(K.LAUNCHES)
        fetched = dict(packing.FETCHED)
        stages = tracer.times()
        tracer.enabled = False
        falls = fallbacks.counts()
        check(rc == 0, f"in-process stat_fish.main returned {rc}")
        check(launches["label"] == STAT_FISH_LABELS_PER_IMAGE * len(names), f"stat_fish: B2 launched {launches['label']} times, expected {STAT_FISH_LABELS_PER_IMAGE * len(names)}")
        check(1 <= launches["flood_border"] <= len(names), f"stat_fish: B3 launched {launches['flood_border']} times (one per watershed with markers)")
        check(launches["conv3x3"] == NUSET_FORWARD_LAUNCHES["conv3x3"] * len(names), f"stat_fish: H1 launched {launches['conv3x3']} times, "
              f"expected {NUSET_FORWARD_LAUNCHES['conv3x3'] * len(names)}")
        check(all(n == 0 for k, n in launches.items() if k not in ("label", "flood_border", "conv3x3")), f"stat_fish launched other kernels: {launches}")
        nuset_counts = dict(ni.COUNTS)
        check(0 < nuset_counts["nms_candidates"] <= 6000 * len(names) and 0 < nuset_counts["markers"] <= nuset_counts["nms_kept"],
              f"stat_fish: NuSeT's counts {nuset_counts}")
        results["transfers"]["stat_fish"] = stat_fish_transfers(fetched, len(names), launches["flood_border"], nuset_counts["nms_kept"],
                                                            falls.get(fallbacks.WATERSHED_HOST_RECOMPUTE, 0))

        ann = {d: os.path.join(d, "annotated") for d in (imgs, inproc)}
        csv = {d: read_bytes(os.path.join(a, "stat_fish_lsq.csv")) for d, a in ann.items()}
        check(csv[imgs] == csv[inproc], "stat_fish command line: CSV bytes != the in-process run's")
        rows = csv[imgs].decode().splitlines()
        check(rows[0].split(",") == stat_fish.csv_header(2) and len(rows) - 1 > len(names) * (SIZE * SIZE // 90000) // 2, f"stat_fish CSV: {len(rows) - 1} rows")
        n_files = 0
        for name in names:
            stem = name[:-4]
            for d, a in ann.items():
                check(len(os.listdir(os.path.join(a, stem))) == 6, f"{d}: annotated/{stem} holds {sorted(os.listdir(os.path.join(a, stem)))}")
            for fname in sorted(os.listdir(os.path.join(ann[imgs], stem))):
                a_, b_ = (os.path.join(ann[d], stem, fname) for d in (imgs, inproc))
                if fname.endswith(".npy"):
                    check(read_bytes(a_) == read_bytes(b_), f"stat_fish: {fname} bytes differ between the command line and in-process")
                    seg = np.load(a_)
                    side = int(round(SIZE * 0.3)) // 16 * 16  # NuSeT's side at scale_ratio 0.3
                    check(seg.shape == ni.output_shape((side, side), 0.3) and seg.max() > SIZE * SIZE // 180000,
                          f"{fname}: shape {seg.shape}, {seg.max()} nuclei")
                else:
                    check(np.array_equal(imgio.imread_rgb(a_), imgio.imread_rgb(b_)), f"stat_fish: {fname} pixels differ between the command line and in-process")
                n_files += 1

        marks["in-process run and output checks"] = time.perf_counter() - phase_t0

        # on copies of the inputs, the default run's bytes: ECSEG_FAST_WATERSHED=host
        # (no B3 launch: only the watershed launches B3 in stat_fish), and
        # ECSEG_DEVICE_PIPELINE=0 (the host watershed, cleanup and matched
        # filter: no kernel launch), the branch pair the JAX repo's
        # scripts/parity_tpu.py compares stat_fish's artifacts under
        host_walls = {}
        for tag, env in (("ECSEG_FAST_WATERSHED=host", {"ECSEG_FAST_WATERSHED": "host"}),
                         ("ECSEG_DEVICE_PIPELINE=0", {"ECSEG_DEVICE_PIPELINE": "0", "ECSEG_FAST_WATERSHED": None})):
            copy_dir = os.path.join(work, "host_" + tag.split("=")[0].lower())
            os.makedirs(copy_dir)
            for name in names:
                shutil.copy(os.path.join(inproc, name), copy_dir)
            os.chdir(work)
            tracer.enabled = True
            tracer.reset()
            fallbacks.reset()
            K.reset_launches()
            try:
                t0 = time.perf_counter()
                with environ(env):
                    rc = stat_fish.main(config=Config(raw={"stat_fish": {"inpath": copy_dir, "scale": 1, "use_min_cut": True, "nuclei_size_T": STAT_FISH_T}}), device="cuda")
                host_walls[tag] = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
                tracer.enabled = False
            host_launches = dict(K.LAUNCHES)
            check(rc == 0 and fallbacks.counts() == {}, f"stat_fish under {tag}: rc {rc}, fallbacks {fallbacks.counts()}")
            if tag.startswith("ECSEG_FAST_WATERSHED"):
                host_stages = tracer.times()
                check(host_launches["flood_border"] == 0 and host_launches["label"] == launches["label"],
                      f"stat_fish under {tag} launched {host_launches}")
            else:  # the U-Net passes stay on the card
                check({k: v for k, v in host_launches.items() if v} == {"conv3x3": launches["conv3x3"]}, f"stat_fish under {tag} launched {host_launches}")
            host_ann = os.path.join(copy_dir, "annotated")
            check(read_bytes(os.path.join(host_ann, "stat_fish_lsq.csv")) == csv[inproc], f"{tag}: CSV bytes != the default run's")
            for name in names:
                stem = name[:-4]
                for fname in sorted(os.listdir(os.path.join(ann[inproc], stem))):
                    a_, b_ = os.path.join(ann[inproc], stem, fname), os.path.join(host_ann, stem, fname)
                    if fname.endswith(".npy"):
                        check(read_bytes(a_) == read_bytes(b_), f"{tag}: {fname} bytes != the default run's")
                    else:
                        check(np.array_equal(imgio.imread_rgb(a_), imgio.imread_rgb(b_)), f"{tag}: {fname} pixels != the default run's")
            print(f"stat_fish under {tag}: {host_walls[tag]:.3f} s, launches {({k: v for k, v in host_launches.items() if v})}, "
                  "CSV, .npy and TIFFs equal the default run's", flush=True)
        host_wall = host_walls["ECSEG_FAST_WATERSHED=host"]
        marks["host watershed run"] = time.perf_counter() - phase_t0

        # stage by stage on image 0 and a 900x700 crop of it
        params = load_stat_fish_params()
        model = load_nuset_model(os.path.join(work, "models"), dev, bbox_min_score=params.min_score,
                                 nms_threshold=params.nms_threshold, resize_scale=params.scale_ratio)
        I0 = imgio.u16_to_u8(imgio.imread_bgr8(os.path.join(inproc, names[0])))
        results["nuset_conv3x3"] = nuset_conv3x3_check(model, ni.nuclei_segment_prepare(I0[:, :, 0], params.scale_ratio),
                                                       ni.nuclei_segment_prepare(I0[: STAT_FISH_SMALL[0], : STAT_FISH_SMALL[1], 0], params.scale_ratio))
        stage_checks, kernel_inputs, geoms = {}, {}, {}
        full = f"{SIZE}x{SIZE}"
        for tag, I in ((full, I0), ("900x700", np.ascontiguousarray(I0[: STAT_FISH_SMALL[0], : STAT_FISH_SMALL[1]]))):
            pre = ni.nuclei_segment_prepare(I[:, :, 0], params.scale_ratio)
            masks1 = ni.nuset_forward(model, pre[1], pass_two=False)
            mask, props, scores = ni.mask_and_proposals(model, foreground_norm(pre[0], masks1))
            geoms[tag] = mask.shape
            dev_ws, n_unc = nuset_marker_watershed_auto(scores, props, mask, params.min_score, dev)
            host_ws = nuset_marker_watershed(scores, props, mask, params.min_score)
            if dev_ws is not None:
                check(np.array_equal(dev_ws, host_ws), f"{tag}: the certified watershed != the host priority flood")
            ws = host_ws.astype(np.float32)
            out_hw = ni.output_shape(ws.shape, params.scale_ratio)
            seg = ni.cleanup_pass(ws, out_hw, STAT_FISH_T, dev)
            check(np.array_equal(seg, ni.cleanup_host(ws, params.scale_ratio, STAT_FISH_T)), f"{tag}: the device cleanup != the host chain")
            h, w = seg.shape
            Ic = I[:h, :w]
            mf_args = (Ic, seg, params.gaussian_sigma, params.normal_threshold, list(params.color_sensitivity), list(params.kernel_size))
            thr = mf.get_thresholded_device_packed(*mf_args, dev)
            check(np.array_equal(thr, mf.get_thresholded(*mf_args)), f"{tag}: the device matched filter != the host one")
            markers = nuset_place_markers(scores, props, mask, params.min_score)
            stage_checks[tag] = {"nuset_hw": list(mask.shape), "proposals": int(len(props)), "markers": int(markers.max()) if markers is not None else 0,
                                 "certificate": int(n_unc), "device_watershed_used": dev_ws is not None, "nuclei_px": int((seg > 0).sum()),
                                 "fish_px": int((thr > 0).sum())}
            # the ungated modes on the card against the CPU twins' padded pass,
            # B3 launches (one a pass), tie counts, and each mode's ms
            K.reset_launches()
            t0 = time.perf_counter()
            on_ws = nuset_marker_watershed_fast(scores, props, mask, params.min_score, dev)
            on_ms, b3_on = 1e3 * (time.perf_counter() - t0), K.LAUNCHES["flood_border"]
            K.reset_launches()
            t0 = time.perf_counter()
            check_ws, ties = nuset_marker_watershed_fast(scores, props, mask, params.min_score, dev, count_ties=True)
            check_ms, b3_check = 1e3 * (time.perf_counter() - t0), K.LAUNCHES["flood_border"]
            cpu_ws, cpu_ties = nuset_marker_watershed_fast(scores, props, mask, params.min_score, "cpu", count_ties=True)
            check(np.array_equal(on_ws, cpu_ws) and np.array_equal(check_ws, cpu_ws) and ties == cpu_ties,
                  f"{tag}: the fast watershed on the card != the CPU twins' (ties {ties} vs {cpu_ties})")
            want_b3 = (1, 2) if markers is not None else (0, 0)
            check((b3_on, b3_check) == want_b3, f"{tag}: B3 launched {(b3_on, b3_check)} times in on/check, expected {want_b3}")
            t0 = time.perf_counter()
            nuset_marker_watershed(scores, props, mask, params.min_score)
            host_ms = 1e3 * (time.perf_counter() - t0)
            t0 = time.perf_counter()
            nuset_marker_watershed_auto(scores, props, mask, params.min_score, dev)
            auto_ms = 1e3 * (time.perf_counter() - t0) + (host_ms if dev_ws is None else 0.0)
            stage_checks[tag].update({"fast_ties_px": ties, "fast_vs_host_px": int((on_ws != host_ws).sum()),
                                      "watershed_ms": {"host": host_ms, "auto": auto_ms, "on": on_ms, "check": check_ms}})
            m = torch.from_numpy(mask != 0).to(dev)
            kept = clean_image(torch.from_numpy(ws != 0).to(dev))
            supp = torch.from_numpy(seg > 0).to(dev)
            for what, t, conns in ((f"NuSeT mask {tag}", m, (1, 2)), (f"cleaned complement {tag}", ~kept, (2,)), (f"binarized support {h}x{w}", supp, (1,))):
                for conn in conns:
                    errors.compare("label", K.label(t, conn), K.label_plain(t, conn), what + f" conn {conn}")
            errors.compare("flood_border", K.flood_from_border(~m), K.flood_from_border_plain(~m), f"NuSeT background {tag}")
            kernel_inputs[tag] = (m, supp)
        print(f"stat_fish stages against the host chains: {stage_checks}", flush=True)

        marks["stages against the host chains"] = time.perf_counter() - phase_t0

        # the certified watershed with hand-placed proposals
        gh, gw = geoms[full]
        cert = []
        for n in (12, 12, 40, 40):
            pred, sc, pr = touching_nuclei_case(rng, gh, gw, n)
            out, n_unc = nuset_marker_watershed_auto(sc, pr, pred, 0.95, dev)
            host = nuset_marker_watershed(sc, pr, pred, 0.95)
            if out is not None:
                check(np.array_equal(out, host), "hand-placed proposals: the certified watershed != the host priority flood")
            cert.append({"nuclei": n, "certificate": int(n_unc), "clean": out is not None, "split_px": int((pred > 0).sum() - (host > 0).sum())})
        check(any(c["clean"] for c in cert), f"the certificate was never clean on the hand-placed cases: {cert}")
        print(f"certified watershed, hand-placed proposals on {gh}x{gw}: {cert}", flush=True)

        # times of the stages the JAX package left to XLA, on image 0
        pre = ni.nuclei_segment_prepare(I0[:, :, 0], params.scale_ratio)
        masks1 = ni.nuset_forward(model, pre[1], pass_two=False)
        fgn = foreground_norm(pre[0], masks1)
        x = torch.from_numpy(fgn.astype(np.float32)).to(dev)[None, None]
        mask, props, scores = ni.mask_and_proposals(model, fgn)
        with torch.no_grad():
            _, feat = model.unet_fg(x)
        m = torch.from_numpy(mask != 0).to(dev)
        markers = nuset_place_markers(scores, props, mask, params.min_score)
        mk = torch.from_numpy((markers if markers is not None else np.zeros_like(mask)).astype(np.int32)).to(dev)
        img = -edt_sq(binary_fill_holes(m))
        n_boxes = min(boxes.PRE_NMS_TOP_N, feat.shape[2] * feat.shape[3] * 21)
        tb = torch.rand((n_boxes, 4), generator=torch.Generator(device=dev).manual_seed(3), device=dev).cumsum(1) * 100

        def wall_ms(fn, reps=3):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t0) / reps

        with torch.no_grad():
            xla_side = {
                "unet_fg_forward (cuda events)": cuda_ms(lambda: model.unet_fg(x), 3),
                "unet_whole_forward (cuda events)": cuda_ms(lambda: model.unet_whole(x), 3),
                "proposal_pass with NMS (wall)": wall_ms(lambda: ni.proposal_pass(model, feat, 20.0, mask.shape)),
                f"nms suppression matrix {n_boxes} boxes (cuda events)": cuda_ms(lambda: boxes.suppression_matrix(tb, 0.01), 5),
                "edt_sq (wall)": wall_ms(lambda: edt_sq(m)),
                "lex_flood (wall)": wall_ms(lambda: lex_flood(img, torch.where(m, mk, 0), m)),
                "fast pass incl. B3 (wall)": wall_ms(lambda: nuset_fast_pass(m, mk)),
                f"resize matmul {tuple(mask.shape)} -> {SIZE}^2 (cuda events)": cuda_ms(lambda: resize_linear_matmul(m.float(), (SIZE, SIZE)), 10),
                "cleanup_pass incl. B2 (wall)": wall_ms(lambda: ni.cleanup_pass(mask, (SIZE, SIZE), STAT_FISH_T, dev)),
                "matched filter incl. transfers (wall)": wall_ms(lambda: mf.get_thresholded_device_packed(I0, np.full((SIZE, SIZE), 255, np.uint8), 3.0, 15, [70, 70], [7, 7], dev)),
            }
        print(f"stat_fish XLA-side ops on image 0: {xla_side}", flush=True)

        marks["hand-placed watershed and XLA-side times"] = time.perf_counter() - phase_t0

        # the device's busy share over one image's segmentation
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ni.nuclei_segment(I0[:, :, 0], model, STAT_FISH_T, pre=pre)
            torch.cuda.synchronize()
            seg_wall = time.perf_counter() - t0
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name) / 1e6
        profile_pass = {"wall_s": seg_wall, "device_busy_s": busy, "busy_share": busy / seg_wall}
        print(f"stat_fish nuclei_segment on image 0 under torch.profiler: {profile_pass}", flush=True)

        # B2 and B3 at stat_fish's geometries
        m608, supp = kernel_inputs[full]
        m_small, _ = kernel_inputs["900x700"]
        at = {
            "label": {f"NuSeT mask {tuple(m608.shape)} conn 1": cuda_ms(lambda: K.label(m608, 1), 20),
                      f"NuSeT mask {tuple(m608.shape)} conn 2": cuda_ms(lambda: K.label(m608, 2), 20),
                      f"NuSeT mask {tuple(m_small.shape)} conn 1": cuda_ms(lambda: K.label(m_small, 1), 20),
                      f"binarized support {tuple(supp.shape)} conn 1": cuda_ms(lambda: K.label(supp, 1), 20)},
            "flood_border": {f"NuSeT background {tuple(m608.shape)}": cuda_ms(lambda: K.flood_from_border(~m608), 20),
                             f"NuSeT background {tuple(m_small.shape)}": cuda_ms(lambda: K.flood_from_border(~m_small), 20)},
        }
        marks["profiler pass and B2/B3 times"] = time.perf_counter() - phase_t0
        results["stat_fish_kernels"] = {
            key: {"launches": launches[key], "images": len(names), "launches_per_image": launches[key] / len(names), "ms_at": at[key]}
            for key in ("label", "flood_border")
        }
        results["stat_fish"] = {
            "images": len(names), "wall_s": wall, "images_per_s": len(names) / wall, "cli_s": cli_s,
            "cli_images_per_s": len(names) / cli_s, "encode_s": encode_s, "launches": {k: v for k, v in launches.items() if v},
            "fallbacks": falls, "stages_s": {k: v for k, v in stages.items() if k.startswith(("stat_fish.", "nuset."))},
            "csv_rows": len(rows) - 1, "files_compared": n_files, "stage_checks": stage_checks, "hand_placed_watershed": cert,
            "xla_side_ms": xla_side, "profile": profile_pass, "phase_marks_s": marks,
            "host_watershed": {"wall_s": host_wall, "images_per_s": len(names) / host_wall, "watershed_s": host_stages.get("stat_fish.watershed", [])},
            "device_pipeline_0_wall_s": host_walls["ECSEG_DEVICE_PIPELINE=0"],
        }
        print(
            f"stat_fish: command line {cli_s:.2f} s for {len(names)} images ({len(names) / cli_s:.3f} images/s, process start included); "
            f"in-process main {wall:.3f} s ({len(names) / wall:.3f} images/s); launches {results['stat_fish']['launches']}; "
            f"fallbacks {falls}; CSV ({len(rows) - 1} rows), .npy and TIFFs equal across the two runs; phase marks {marks}", flush=True,
        )
        for name in [f"stat_fish.{n}" for n in STAT_FISH_STAGES] + [f"nuset.{n}" for n in NUSET_STAGES]:
            ts = stages.get(name, [])
            print(f"  stage {name:26s} n={len(ts)} total {sum(ts):.4f} s; ms: " + " ".join(f"{1e3 * t:.1f}" for t in ts), flush=True)
        ts = host_stages.get("stat_fish.watershed", [])
        print(f"  stage stat_fish.watershed (ECSEG_FAST_WATERSHED=host) n={len(ts)} total {sum(ts):.4f} s; ms: " + " ".join(f"{1e3 * t:.1f}" for t in ts), flush=True)
        for tag, sc in stage_checks.items():
            print(f"  watershed ms by mode on {tag}'s NuSeT outputs ({sc['markers']} markers): "
                  + " ".join(f"{mode} {ms:.1f}" for mode, ms in sc["watershed_ms"].items())
                  + f"; check's ties {sc['fast_ties_px']} px, on vs host {sc['fast_vs_host_px']} px", flush=True)
        # the command line's folder (images and annotated/) is interseg's input
        keep = tempfile.mkdtemp(prefix="ecseg_stat_fish_out_")
        results["stat_fish_folder"] = shutil.move(imgs, os.path.join(keep, "imgs"))
        shutil.copytree(os.path.join(work, "models"), os.path.join(keep, "models"))  # phase_multidevice's NuSeT weights
    finally:
        shutil.rmtree(work, ignore_errors=True)


class DictFetcher:
    """The imported-Keras graph constructor's fetcher over in-memory weights:
    ``{layer: [arrays in Keras's order]}``, a nested model's weights under
    its name as another such dict (the card's machine has no h5py, so the
    constructor is driven from a config and arrays, not from a file)."""

    def __init__(self, weights):
        self.weights = weights

    def fetch(self, name):
        w = self.weights.get(name, [])
        return list(w) if isinstance(w, list) else []

    def child(self, name, layers_cfg):
        return DictFetcher(self.weights.get(name, {}))


def _keras_layer(cls, name, inbound=None, **cfg):
    entry = {"class_name": cls, "config": {"name": name, **cfg}}
    if inbound is not None:
        entry["inbound_nodes"] = [[[n, 0, 0, {}] for n in inbound]]
    return entry


def _keras_conv(name, filters, k, inbound=None, activation="relu", cls="Conv2D", stride=1):
    return _keras_layer(cls, name, inbound, filters=filters, kernel_size=[k, k], strides=[stride, stride],
                        padding="same", activation=activation, use_bias=True)


def unet_keras_config(widths, bottleneck, num_classes):
    """The metaseg U-Net (``models/metaseg_unet.py``) as a legacy-format
    Keras Functional config: Rescaling(1/255), per level two 3x3 convs +
    ReLU and a 2x2 'same' max pool, the bottleneck, per level a 3x3 stride-2
    transpose conv + ReLU, the skip concat (skip first) and two convs, a
    1x1 softmax head."""
    layers = [_keras_layer("InputLayer", "inp", []), _keras_layer("Rescaling", "scale", ["inp"], scale=1 / 255.0, offset=0.0)]
    x = "scale"
    for i, w in enumerate(widths, start=1):
        layers += [_keras_conv(f"enc{i}_1", w, 3, [x]), _keras_conv(f"enc{i}_2", w, 3, [f"enc{i}_1"]),
                   _keras_layer("MaxPooling2D", f"pool{i}", [f"enc{i}_2"], pool_size=[2, 2], strides=[2, 2], padding="same")]
        x = f"pool{i}"
    layers += [_keras_conv("bott_1", bottleneck, 3, [x]), _keras_conv("bott_2", bottleneck, 3, ["bott_1"])]
    x = "bott_2"
    for i in range(len(widths), 0, -1):
        w = widths[i - 1]
        layers += [_keras_conv(f"up{i}", w, 3, [x], cls="Conv2DTranspose", stride=2),
                   _keras_layer("Concatenate", f"cat{i}", [f"enc{i}_2", f"up{i}"], axis=-1),
                   _keras_conv(f"dec{i}_1", w, 3, [f"cat{i}"]), _keras_conv(f"dec{i}_2", w, 3, [f"dec{i}_1"])]
        x = f"dec{i}_2"
    layers.append(_keras_conv("head", num_classes, 1, [x], activation="softmax"))
    return {"class_name": "Functional", "config": {"name": "metaseg", "layers": layers, "input_layers": [["inp", 0, 0]],
                                                  "output_layers": [["head", 0, 0]]}}


def unet_keras_weights(tree):
    """A metaseg parameter tree (``weights.params_to_numpy``) as Keras holds
    it: HWIO conv kernels, (H, W, out, in) transpose-conv kernels."""
    return {name: [np.transpose(p["kernel"], (0, 1, 3, 2)) if name.startswith("up") else p["kernel"], p["bias"]]
            for name, p in tree.items()}


def ecseg_i_keras_config():
    """ecSeg-i (``models/classifiers.EcsegI``) as a Keras Sequential: the
    bare (N, 256, 256) target channel reshaped to one channel,
    Rescaling(1/255), four blocks of 3x3 conv + ReLU and 2x2 max pool,
    the global mean, a softmax dense head."""
    from ecseg_torch.models.classifiers import WIDTHS

    layers = [_keras_layer("InputLayer", "in0"), _keras_layer("Reshape", "chan", target_shape=[256, 256, 1]),
              _keras_layer("Rescaling", "scale", scale=1 / 255.0, offset=0.0)]
    for i, w in enumerate(WIDTHS, start=1):
        layers += [_keras_conv(f"conv{i}", w, 3), _keras_layer("MaxPooling2D", f"pool{i}", pool_size=[2, 2], strides=[2, 2], padding="same")]
    layers += [_keras_layer("GlobalAveragePooling2D", "gap"), _keras_layer("Dense", "head", units=3, activation="softmax", use_bias=True)]
    return {"class_name": "Sequential", "config": {"name": "ecseg_i", "layers": layers}}


def classifier_keras_weights(tree):
    """A classifier tree (``models/demo.py``) as Keras holds it (the same
    HWIO and (in, out) arrays)."""
    return {name: [p["kernel"], p["bias"]] for name, p in tree.items()}


def ecseg_c_keras_config():
    """ecSeg-c (``models/classifiers.EcsegC``) as a Keras Sequential: the
    (N, 256, 256, 3) floats ``interseg.preprocess_ecseg_c`` gives, four
    blocks of 3x3 conv + ReLU and 2x2 max pool, the global mean, a sigmoid
    dense head of one unit."""
    from ecseg_torch.models.classifiers import WIDTHS

    layers = [_keras_layer("InputLayer", "in0")]
    for i, w in enumerate(WIDTHS, start=1):
        layers += [_keras_conv(f"conv{i}", w, 3), _keras_layer("MaxPooling2D", f"pool{i}", pool_size=[2, 2], strides=[2, 2], padding="same")]
    layers += [_keras_layer("GlobalAveragePooling2D", "gap"), _keras_layer("Dense", "head", units=1, activation="sigmoid", use_bias=True)]
    return {"class_name": "Sequential", "config": {"name": "ecseg_c", "layers": layers}}


# --- test writers of TensorFlow's formats: a TF1 V2 checkpoint (a tensor
# bundle: a LevelDB table of BundleEntryProto under <prefix>.index, the
# bytes in <prefix>.data-NNNNN-of-NNNNN) and a TF-Keras SavedModel's
# keras_metadata.pb and variables bundle.  The card's machine has no
# TensorFlow; the tests read these writers' files with TensorFlow's readers.

TF_DTYPES = {"<f4": 1, "<f8": 2, "<i4": 3, "|u1": 4, "<c8": 8, "<i8": 9, "|b1": 10}  # numpy -> TF DataType
TF_BLOCK_BYTES = 4096  # LevelDB's default block size
TF_RESTART_INTERVAL = 16  # LevelDB's default


def _pb_varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        out.append((n & 0x7F) | (0x80 if n > 0x7F else 0))
        n >>= 7
        if not n:
            return bytes(out)


def _pb(number: int, value, fixed32: bool = False) -> bytes:
    """One protobuf field: an int as a varint (``fixed32``: 4 bytes), bytes
    or str length-delimited."""
    if fixed32:
        return _pb_varint(number << 3 | 5) + struct.pack("<I", value)
    if isinstance(value, int):
        return _pb_varint(number << 3) + _pb_varint(value)
    value = value.encode() if isinstance(value, str) else value
    return _pb_varint(number << 3 | 2) + _pb_varint(len(value)) + value


def _table_block(entries) -> bytes:
    """A LevelDB block: keys prefix-compressed against the one before,
    restarted every ``TF_RESTART_INTERVAL`` entries, then the restart array."""
    buf, restarts, prev = bytearray(), [], b""
    for i, (key, value) in enumerate(entries):
        shared = 0
        if i % TF_RESTART_INTERVAL == 0:
            restarts.append(len(buf))
        else:
            while shared < min(len(prev), len(key)) and prev[shared] == key[shared]:
                shared += 1
        buf += _pb_varint(shared) + _pb_varint(len(key) - shared) + _pb_varint(len(value)) + key[shared:] + value
        prev = key
    restarts = restarts or [0]
    return bytes(buf) + struct.pack(f"<{len(restarts)}I", *restarts) + struct.pack("<I", len(restarts))


def write_table(path: str, entries, compression: int = 0) -> int:
    """A LevelDB table of sorted (key, value) byte pairs: data blocks of
    about ``TF_BLOCK_BYTES``, an empty metaindex block, the index block
    (each data block's last key and handle) and the footer; every block
    followed by its compression byte (``compression`` on data blocks) and
    masked crc32c.  Returns the file's size."""
    from ecseg_torch.core.tfbundle import TABLE_MAGIC, crc32c, mask

    out = bytearray()

    def block(contents: bytes, kind: int = 0) -> bytes:
        handle = _pb_varint(len(out)) + _pb_varint(len(contents))
        out.extend(contents + bytes([kind]) + struct.pack("<I", mask(crc32c(contents + bytes([kind])))))
        return handle

    index, pending, size = [], [], 0
    for key, value in entries:
        pending.append((key, value))
        size += len(key) + len(value)
        if size >= TF_BLOCK_BYTES:
            index.append((key, block(_table_block(pending), compression)))
            pending, size = [], 0
    if pending:
        index.append((pending[-1][0], block(_table_block(pending), compression)))
    meta = block(_table_block([]))
    footer = meta + block(_table_block(index))
    out += footer + bytes(40 - len(footer)) + struct.pack("<Q", TABLE_MAGIC)
    with open(path, "wb") as f:
        f.write(out)
    return len(out)


def write_tf_bundle(prefix: str, tensors: dict, num_shards: int = 1, big_endian: bool = False,
                    sliced=(), compression: int = 0) -> int:
    """A V2 checkpoint as ``tf.compat.v1.train.Saver`` writes it: the
    ``BundleHeaderProto`` under the key ``""`` and one ``BundleEntryProto``
    a tensor (dtype, shape, shard, offset, size, masked crc32c), the
    tensors' bytes spread over ``num_shards`` data files in key order.
    ``tensors``: name -> numpy array (``TF_DTYPES``), bytes (a string
    scalar) or a list of bytes (a string vector).  ``big_endian``, ``sliced`` (names whose entries get an
    empty slice) and ``compression`` write what the reader must refuse.
    Returns the bytes written."""
    from ecseg_torch.core.tfbundle import crc32c, mask

    shards = [bytearray() for _ in range(num_shards)]
    entries = [(b"", _pb(1, num_shards) + (_pb(2, 1) if big_endian else b"") + _pb(3, _pb(1, 1)))]
    for k, name in enumerate(sorted(tensors)):
        value = tensors[name]
        if isinstance(value, (bytes, list)):  # DT_STRING: varint lengths, their masked crc32c, the bytes
            shape, value = ([], [value]) if isinstance(value, bytes) else ([len(value)], value)
            crc = 0
            for v in value:
                crc = crc32c(len(v).to_bytes(4, "little"), crc)
            check = struct.pack("<I", mask(crc))
            data = b"".join(_pb_varint(len(v)) for v in value) + check + b"".join(value)
            crc = crc32c(b"".join(value), crc32c(check, crc))
            dtype = 7
        else:
            arr = np.asarray(value)  # ascontiguousarray would make a scalar 1-D
            data, crc = arr.tobytes(), crc32c(arr)
            dtype, shape = TF_DTYPES[arr.dtype.str], arr.shape
        shard = k % num_shards
        entry = (_pb(1, dtype) + _pb(2, b"".join(_pb(2, _pb(1, n)) for n in shape)) + _pb(3, shard)
                 + _pb(4, len(shards[shard])) + _pb(5, len(data)) + _pb(6, mask(crc), fixed32=True)
                 + (_pb(7, b"") if name in sliced else b""))
        shards[shard] += data
        entries.append((name.encode(), entry))
    total = write_table(prefix + ".index", entries, compression)
    for i, data in enumerate(shards):
        with open(f"{prefix}.data-{i:05d}-of-{num_shards:05d}", "wb") as f:
            f.write(data)
        total += len(data)
    return total


NUSET_TF_DECONV = {"deconv4": "conv2d_transpose", "deconv3": "conv2d_transpose_1", "deconv2": "conv2d_transpose_2",
                   "deconv1": "conv2d_transpose_3"}


def nuset_tf1_checkpoints(tree):
    """The NuSeT tree (``models/nuset.npz``'s) as the reference's two TF1
    checkpoints hold it, under its graph's names: ``{"whole_norm.ckpt":
    {name: array}, "foreground.ckpt": ...}``; transpose-conv kernels as TF
    keeps them, (H, W, out, in); besides the weights, one Adam slot,
    ``beta1_power`` and ``global_step``, which the converter drops."""
    def unet(layers):
        out = {}
        for name, leaves in layers.items():
            for leaf, value in leaves.items():
                if name in NUSET_TF_DECONV and leaf == "kernel":
                    value = np.transpose(value, (0, 1, 3, 2))
                out[f"model_U-Net/{NUSET_TF_DECONV.get(name, name)}/{leaf}"] = value
        return out

    extra = {"model_U-Net/conv1-1/kernel/Adam": np.zeros_like(tree["whole"]["conv1-1"]["kernel"]),
             "beta1_power": np.array(0.9, np.float32), "global_step": np.array(1, np.int64)}
    rpn = {f"model_RPN/{'rpn_conv/3x3' if name == 'rpn_conv' else name}/{leaf}": value
           for name, leaves in tree["fg"]["rpn"].items() for leaf, value in leaves.items()}
    return {"whole_norm.ckpt": {**unet(tree["whole"]), **extra}, "foreground.ckpt": {**unet(tree["fg"]["unet"]), **rpn, **extra}}


TUPLE_KEYS = ("kernel_size", "strides", "pool_size", "dilation_rate", "target_shape", "batch_input_shape", "size")


def _keras_saved_encoding(value, ids):
    """A config as Keras's SavedModel metadata encodes it: the tuple-valued
    keys as ``{"class_name": "__tuple__", "items": [...]}`` and a
    ``shared_object_id`` on every layer."""
    if isinstance(value, dict):
        out = {k: ({"class_name": "__tuple__", "items": v} if k in TUPLE_KEYS and isinstance(v, list) else _keras_saved_encoding(v, ids))
               for k, v in value.items()}
        if "class_name" in out and isinstance(out.get("config"), dict) and "name" in out["config"] and "layers" not in out["config"]:
            out["shared_object_id"] = next(ids)
        return out
    if isinstance(value, list):
        return [_keras_saved_encoding(v, ids) for v in value]
    return value


def write_keras_savedmodel(directory: str, config: dict, weights: dict, keras_version: str = "2.8.0") -> int:
    """A TF-Keras SavedModel's two files that describe a Keras model:
    ``keras_metadata.pb`` (a ``SavedMetadata``: the root's metadata JSON
    with ``model_config`` in the SavedModel encoding, one node a layer of
    ``model.layers`` under its path, ``root.layer_with_weights-M`` for a
    layer with weights and ``root.layer-N`` for one without) and
    ``variables/variables.*`` (the weights under their checkpoint keys and
    a ``TrackableObjectGraph`` in ``_CHECKPOINTABLE_OBJECT_GRAPH``: the
    root's ``layer-N`` and ``layer_with_weights-M`` children, each layer's
    ``kernel``/``bias`` and its ``variables`` and ``trainable_variables``
    lists).  ``weights``: ``{layer: [kernel, bias]}``.  No
    ``saved_model.pb``: only TensorFlow's loader reads it.  Returns the
    bytes written."""
    import itertools

    layers = [lc for lc in config["config"]["layers"] if config["class_name"] != "Sequential" or lc["class_name"] != "InputLayer"]
    graph, tensors, meta, n_weighted = [None], {}, [], 0  # graph: [(children, attributes)], the root first

    def add(children=(), attributes=()):
        graph.append((list(children), list(attributes)))
        return len(graph) - 1

    root_children = []
    for n, lc in enumerate(layers):
        name, held = lc["config"]["name"], weights.get(lc["config"]["name"], [])
        path = f"layer_with_weights-{n_weighted}" if held else f"layer-{n}"
        variables = []
        for leaf, value in zip(("kernel", "bias"), held):
            key = f"{path}/{leaf}/.ATTRIBUTES/VARIABLE_VALUE"
            tensors[key] = np.ascontiguousarray(value, np.float32)
            variables.append((leaf, add(attributes=[("VARIABLE_VALUE", f"{name}/{leaf}", key)])))
        listed = add([(str(i), v) for i, (_, v) in enumerate(variables)])
        trainable = add([(str(i), v) for i, (_, v) in enumerate(variables)])
        node = add(variables + [("variables", listed), ("trainable_variables", trainable)])
        root_children.append((f"layer-{n}", node))
        if held:
            root_children.append((path, node))
            n_weighted += 1
        meta.append((f"root.{path}", "_tf_keras_layer", {"name": name, "class_name": lc["class_name"], "config": lc["config"]}))
    graph[0] = (root_children, [])

    def node_pb(children, attributes):
        return (b"".join(_pb(1, _pb(1, i) + _pb(2, local)) for local, i in children)
                + b"".join(_pb(2, _pb(1, a) + _pb(2, b) + _pb(3, c)) for a, b, c in attributes))

    tensors["_CHECKPOINTABLE_OBJECT_GRAPH"] = b"".join(_pb(1, node_pb(*node)) for node in graph)
    encoded = _keras_saved_encoding(config, itertools.count())
    root_meta = {"name": config["config"]["name"], "class_name": config["class_name"], "model_config": encoded,
                 "keras_version": keras_version, "backend": "tensorflow", "is_graph_network": True}
    identifier = "_tf_keras_sequential" if config["class_name"] == "Sequential" else "_tf_keras_network"
    version = _pb(6, _pb(1, 2) + _pb(2, 1))
    nodes = [_pb(1, _pb(2, i) + _pb(3, path) + _pb(4, ident) + _pb(5, json.dumps(md)) + version)
             for i, (path, ident, md) in enumerate([("root", identifier, root_meta)] + meta)]
    os.makedirs(os.path.join(directory, "variables"), exist_ok=True)
    with open(os.path.join(directory, "keras_metadata.pb"), "wb") as f:
        f.write(b"".join(nodes))
    return sum(len(n) for n in nodes) + write_tf_bundle(os.path.join(directory, "variables", "variables"), tensors)


INTERSEG_PROB_ATOL = 1e-5  # tests/test_torch_classifiers.py's PROB_ATOL
INTERSEG_STAGES = ("decode_wait", "crops", "predict_i", "predict_c", "write")


def phase_interseg(dev, results):
    """``make interseg`` as a user runs it, on the folder that the stat_fish
    phase's command line wrote (three 2048^2 RGB images, their
    ``annotated/stat_fish_lsq.csv`` and ``*_segmentation.tif``), with the
    crafted demo ecSeg-i/ecSeg-c trees in ``interseg_models/*.npz``,
    ``FISH_color: red`` and ``has_centromeric_probe: True``:
    ``python3 -m ecseg_torch.pipelines.interseg`` (``ECSEG_TRACE=1``), then
    ``interseg.main`` in-process on the same folder (launch counters set to
    0 just before, read just after: interseg runs no hand kernel).  Checks:
    exit code 0 and the two CSVs byte-equal; per image, the labels of the
    batched card run equal the labels of per-row (batch-of-1) card
    predictions, with probabilities within ``INTERSEG_PROB_ATOL``, and
    equal those of the same crops through the port on the CPU; both
    classifiers ran on the card (their parameters on ``cuda``, ecSeg-c on at
    least one image).  Prints each image's stage times (decode wait, crop
    gather, predict_i, predict_c) and the CSV write beside the card."""
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.core.csvio import read_csv
    from ecseg_torch.models.classifiers import flops_per_patch
    from ecseg_torch.models.demo import demo_ecseg_c_tree, demo_ecseg_i_tree
    from ecseg_torch.models.weights import save_npz
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.pipelines import interseg
    from ecseg_torch.runtime import trace

    root = os.path.dirname(os.path.abspath(__file__))
    folder = results.pop("stat_fish_folder")
    work = tempfile.mkdtemp(prefix="ecseg_interseg_")
    try:
        models = os.path.join(work, "interseg_models")
        save_npz(os.path.join(models, "interseg.npz"), demo_ecseg_i_tree())
        save_npz(os.path.join(models, "ecseg_c.npz"), demo_ecseg_c_tree())
        raw = {"interseg": {"inpath": folder, "FISH_color": "red", "has_centromeric_probe": True}}
        with open(os.path.join(work, "config.yaml"), "w") as f:
            f.write(f"interseg:\n  inpath: {folder}\n  FISH_color: red\n  has_centromeric_probe: True\n")
        out_csv = os.path.join(folder, "interphase_prediction_red.csv")
        env = dict(os.environ, ECSEG_TRACE="1", PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ecseg_torch.pipelines.interseg"], cwd=work, env=env, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"python -m ecseg_torch.pipelines.interseg exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        names = [os.path.basename(p) for p in imgio.get_imgs(folder)]  # main's order, the CSV's
        check(proc.stdout.count("Processing image:") == len(names), "the interseg command line did not process every image")
        cli_csv = read_bytes(out_csv)

        cwd = os.getcwd()
        os.chdir(work)
        tracer = trace.tracer()
        tracer.enabled = True
        tracer.reset()
        K.reset_launches()
        try:
            t0 = time.perf_counter()
            rc = interseg.main(config=Config(raw=raw), device="cuda")
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launches = dict(K.LAUNCHES)
        stages = tracer.times()
        tracer.enabled = False
        check(rc == 0, f"in-process interseg.main returned {rc}")
        check(read_bytes(out_csv) == cli_csv, "interseg: the command line's CSV bytes != the in-process run's")
        check(not any(launches.values()), f"interseg launched hand kernels: {launches}")
        rows = cli_csv.decode().splitlines()
        check(rows[0] == "image_name,nucleus_center,interSeg_label,ecSeg-c_label,ecSeg-i_label", f"interseg CSV header {rows[0]}")

        # per image: batched card labels == per-row card labels == CPU labels
        i_model, c_model = interseg.load_classifier_models(True, model_dir=models, device=dev)
        check(all(p.is_cuda for m in (i_model, c_model) for p in m.parameters()), "the classifiers are not on the card")
        cpu_models = [copy.deepcopy(m).cpu() for m in (i_model, c_model)]
        stat = read_csv(os.path.join(folder, "annotated", "stat_fish_lsq.csv"))
        per_image, csv_rows, max_err, c_images, last = {}, [], {"i": 0.0, "c": 0.0}, 0, None
        for name in names:
            stem = name[:-4]
            I = imgio.u16_to_u8(imgio.imread_rgb(os.path.join(folder, name)))
            seg = imgio.imread_rgb(os.path.join(folder, "annotated", stem, f"{stem}_segmentation.tif"))
            crops = interseg.collect_crops(stem, I, seg, 0)
            passed = interseg.quality_passes(stat, stem, "green")
            labels = interseg.classify(crops, i_model, c_model, passed)
            check(labels == interseg.classify(crops, *cpu_models, passed), f"{stem}: the card's labels != the CPU's on the same crops")
            batch = np.stack(crops.patches) if crops.patches else None
            c_rows = np.nonzero((batch[..., 1].max(axis=(1, 2)) > 10) & passed)[0] if batch is not None else []
            pre = np.stack([interseg.preprocess_ecseg_c(batch[k]) for k in c_rows]) if len(c_rows) else None
            for key, model, x in (("i", i_model, None if batch is None else batch[..., 0]), ("c", c_model, pre)):
                if x is None:
                    continue
                full = interseg.predict(model, x)
                rows1 = np.concatenate([interseg.predict(model, x[k : k + 1]) for k in range(len(x))])
                finite = np.isfinite(full) & np.isfinite(rows1)
                check(np.array_equal(np.isfinite(full), np.isfinite(rows1)), f"{stem} ecSeg-{key}: NaN rows differ between batch and per-row")
                err = float(np.abs(full - rows1)[finite].max()) if finite.any() else 0.0
                max_err[key] = max(max_err[key], err)
                check(err <= INTERSEG_PROB_ATOL, f"{stem} ecSeg-{key}: batched vs per-row max |diff| {err}")
                same = np.array_equal(full.argmax(-1), rows1.argmax(-1)) if key == "i" else np.array_equal(full > 0.5, rows1 > 0.5)
                check(same, f"{stem} ecSeg-{key}: batched labels != per-row labels")
            c_images += pre is not None
            last = batch if batch is not None else last
            csv_rows += [",".join(r) for r in zip(crops.names, crops.centroids, labels[0], labels[1], labels[2])]
            per_image[stem] = {"rows": len(crops.entries), "patches": len(crops.patches), "ecseg_c_rows": int(len(c_rows)), "quality_pass": passed}
        check(csv_rows == rows[1:], "interseg: the CSV rows != the labels of the crops classified here")
        check(last is not None and c_images > 0, f"ecSeg-i or ecSeg-c ran on no image (gates): {per_image}")

        card = results["card"]
        n_i = sum(v["patches"] for v in per_image.values())
        n_c = sum(v["ecseg_c_rows"] for v in per_image.values())
        tflops = {key: n * flops_per_patch(ch) / sum(stages.get(f"interseg.{key}", [])) / 1e12 if n else None
                  for key, n, ch in (("predict_i", n_i, 1), ("predict_c", n_c, 3))}
        print(f"interseg classifiers incl. copies: ecSeg-i {n_i} patches at {tflops['predict_i']} TFLOP/s, "
              f"ecSeg-c {n_c} at {tflops['predict_c']} TFLOP/s (float32, TF32 off) [{card}]", flush=True)
        print(f"interseg: command line {cli_s:.2f} s for {len(names)} images (process start included), in-process main {wall:.3f} s; "
              f"{len(rows) - 1} CSV rows byte-equal across the two runs; batched = per-row = CPU labels on every image; "
              f"max |batched - per-row| ecSeg-i {max_err['i']:.3g}, ecSeg-c {max_err['c']:.3g}; {per_image} [{card}]", flush=True)
        for k, name in enumerate(INTERSEG_STAGES):
            ts = stages.get(f"interseg.{name}", [])
            print(f"  stage interseg.{name:12s} n={len(ts)} ms: " + " ".join(f"{1e3 * t:.1f}" for t in ts) + f" [{card}]", flush=True)
        results["interseg_batch"] = last  # the last image's crops with a patch, for phase_keras_import
        results["interseg"] = {
            "images": len(names), "csv_rows": len(rows) - 1, "cli_s": cli_s, "wall_s": wall, "per_image": per_image,
            "max_abs_batched_vs_rows": max_err, "stages_s": {k: v for k, v in stages.items() if k.startswith("interseg.")},
            "predict_tflops": tflops,
        }
        results["multidevice_stat_fish"] = folder  # stat_fish's and interseg's inputs and outputs
        # the same with the .npz run's CSV: phase_keras_h5's input and reference
        results["keras_h5_stat_fish"] = shutil.copytree(folder, os.path.join(tempfile.mkdtemp(prefix="ecseg_keras_h5_interseg_"), "imgs"))
    finally:
        shutil.rmtree(work, ignore_errors=True)


MULTIDEVICE_TRAIN_MODEL_AXIS = 2  # the training mesh: (data 2, model 2)
METASEG_SHARDED_BATCH = 256  # metaseg.segment_folder_sharded's batch_patches (its default; a multiple of 2 and 4 entries)
MULTIDEVICE_TRAIN_STEPS = 3
# bf16 gradients, mesh against one card: 4 L 2^-8 relative L2 for the L = 23
# convolution layers at the default widths (tests/test_torch_train.py's BF16_GRAD_TOL)
MULTIDEVICE_BF16_GRAD_TOL = 4 * 23 * 2.0**-8
CALLER_FLAGS = {"enabled": True, "benchmark": False, "deterministic": False, "allow_tf32": True}  # PyTorch's defaults


def multidevice_entries(n: int = 2):
    """Every card when there is more than one, else a logical mesh: the one
    card listed ``n`` times (it shows the code paths, the launches and the
    bytes of a mesh, and no speed-up)."""
    cards = torch.cuda.device_count()
    return [f"cuda:{k}" for k in range(cards)] if cards > 1 else ["cuda:0"] * n


def _cudnn_flags():
    c = torch.backends.cudnn
    return {"enabled": c.enabled, "benchmark": c.benchmark, "deterministic": c.deterministic, "allow_tf32": c.allow_tf32}


@contextlib.contextmanager
def parity_probe(tag):
    """Run a fan-out under the caller's flags (PyTorch's defaults, TF32 on)
    and record, at every float32 convolution (``F.conv2d`` and
    ``F.conv_transpose2d``, which every float32 forward calls), the calling
    thread and cuDNN's ``allow_tf32``.  After the fan-out: every record False
    (each worker's first forward included) and the caller's flags back.
    Yields the records."""
    import torch.nn.functional as F

    records = []
    real = {name: getattr(F, name) for name in ("conv2d", "conv_transpose2d")}

    def probe(fn):
        def wrapped(x, *a, **kw):
            if x.dtype == torch.float32:
                records.append((threading.get_ident(), torch.backends.cudnn.allow_tf32))
            return fn(x, *a, **kw)
        return wrapped

    with torch.backends.cudnn.flags(**CALLER_FLAGS):
        for name, fn in real.items():
            setattr(F, name, probe(fn))
        try:
            yield records
        finally:
            for name, fn in real.items():
                setattr(F, name, fn)
        after = _cudnn_flags()
    check(after == CALLER_FLAGS, f"{tag}: cuDNN's flags after the fan-out {after} != the caller's {CALLER_FLAGS}")
    first = {}
    for thread, tf32 in records:
        first.setdefault(thread, tf32)
    check(not any(tf32 for _, tf32 in records), f"{tag}: {sum(t for _, t in records)} of {len(records)} float32 convolutions ran with allow_tf32 True")
    print(f"{tag}: {len(records)} float32 convolutions on {len(first)} threads, allow_tf32 False in each (first forward of each: "
          f"{sorted(set(first.values()))}); the caller's flags back after the fan-out", flush=True)


def _mesh_grads(step):
    """The mesh step's summed gradients by parameter name, float64 on the
    CPU, split kernels concatenated (row 0's slots)."""
    pieces = {}
    for name, _, p in step.model.slots(0):
        pieces.setdefault(name, []).append(p.grad.double().cpu())
    dims = step.model.shard_dims()
    return {n: torch.cat(g, dims.get(n, 0)) for n, g in pieces.items()}


def sharded_host_path_reordered(ref, names, mesh, card):
    """ROADMAP C8's remainder: ``metaseg.segment_folder_sharded`` (the
    ``ECSEG_DEVICE_PIPELINE=0`` mesh path) on ``ref``'s images reversed with
    the first removed, so that other patches share each image's batches and
    the last batch is padded otherwise.  Checks that every chunk dispatched
    has the one shape (``METASEG_SHARDED_BATCH`` / entries patches) and
    that each image's labels (``host_post`` of its raw canvas) equal
    ``ref/labels/*.npy``; the model is ``load_model``'s from the working
    directory."""
    from ecseg_torch.device import entry_devices
    from ecseg_torch.pipelines import metaseg

    shapes = []
    real = metaseg._patch_labels_on
    metaseg._patch_labels_on = lambda replica, d, chunk: (shapes.append(tuple(chunk.shape)), real(replica, d, chunk))[1]
    paths = [os.path.join(ref, n) for n in names][::-1][1:]
    try:
        raws = list(metaseg.segment_folder_sharded(metaseg.load_model(device=mesh[0]), paths, entry_devices(None, mesh)))
    finally:
        metaseg._patch_labels_on = real
    total = sum(len(metaseg._prepare_image(p, save_dapi=False)[0]) for p in paths)
    batches = -(-total // METASEG_SHARDED_BATCH)
    check(shapes == [(METASEG_SHARDED_BATCH // len(mesh), 256, 256, 1)] * (len(mesh) * batches), f"metaseg mesh, =0: chunks dispatched {shapes} for {total} patches")
    check([p for p, _ in raws] == paths, "metaseg mesh, =0: images out of order")
    for path, raw in raws:
        npy = os.path.join(ref, "labels", os.path.basename(path)[:-4] + ".npy")
        check(np.array_equal(metaseg.host_post(raw)[0], np.load(npy)), f"metaseg mesh, =0: {os.path.basename(path)} labels on a reordered folder != the single-card run's")
    images = [os.path.basename(p) for p in paths]
    print(f"metaseg mesh, ECSEG_DEVICE_PIPELINE=0 on {images} ({total} patches): {len(shapes)} chunks of {shapes[0][0]} patches, "
          f"the last batch padded; labels equal the single-card run's [{card}]", flush=True)
    return {"images": images, "patches": total, "chunks": len(shapes)}


def phase_multidevice(args, dev, results):
    """The multi-device paths (``ECSEG_*_SHARD``, metaseg's sharded folder
    paths, the mesh train step) on every card, or, on one card, on a
    logical mesh of it listed twice (printed).  It reuses the folders that
    earlier phases wrote and checks, byte for byte against their
    single-card runs: ``metaseg.main(devices=...)`` on the main path's four
    2048^2 images at the default widths, in the default form (each image's
    chain on one entry: the launches of the single-card run, one host redo
    for the crowded image) and under ``ECSEG_DEVICE_PIPELINE=0`` (patch
    batches split over the entries, the stitch and the oracle on the host:
    no launch), and that path again on the folder reversed with one image
    removed (``sharded_host_path_reordered``: one chunk shape, the same
    labels); ``meta_overlay``, ``stat_fish`` and ``interseg``
    ``main(devices=...)`` (CSV bytes, PNG and TIFF pixels, ``.npy`` bytes,
    B2/B8a/B3 launches equal).  Every fan-out runs under the caller's
    cuDNN flags (PyTorch's defaults), which read the same after it, while
    each float32 convolution in the workers sees ``allow_tf32`` False
    (``parity_probe``).  Then ``train_step_on_mesh`` on a (data 2, model 2)
    mesh (four entries) at the default widths, batch 16 at 256^2 from one
    seed: float32 for three steps, the losses within ``TRAIN_LOSS_RTOL``
    of the single-card ``train_step``'s and the first step's gradients held
    to the CPU's float64 gradient and to the single card's, per tensor, by
    ``_rel_p90_errors`` within ``TRAIN_GRAD_FACTOR`` x (the CPU float32
    gradient's + ``TRAIN_GRAD_TOL``) (phase_train's bound); bf16 for one
    step, the loss within 2^-8 and each gradient's relative L2 error within
    ``MULTIDEVICE_BF16_GRAD_TOL`` of the single card's.  Prints ms per image
    (and per step) of each path, mesh against single card."""
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.demo import demo_ecseg_c_tree, demo_ecseg_i_tree
    from ecseg_torch.models.metaseg_unet import MetasegUNet
    from ecseg_torch.models.weights import save_npz
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import tiling
    from ecseg_torch.parallel.mesh import make_mesh
    from ecseg_torch.pipelines import interseg, meta_overlay, stat_fish
    from ecseg_torch.runtime import fallbacks, trace
    from ecseg_torch.runtime import train as tt
    from ecseg_torch.runtime.data import crop_batches, load_training_pairs

    card = results["card"]
    phase_t0 = time.perf_counter()
    mesh = multidevice_entries()
    kind = "every card" if torch.cuda.device_count() > 1 else "a logical mesh of the one card listed twice"
    print(f"multidevice: mesh {mesh} ({kind}) [{card}]", flush=True)
    out = {"mesh": mesh, "kind": kind}
    md_metaseg = results.pop("multidevice_metaseg")
    md_overlay = results.pop("multidevice_overlay")
    md_stat_fish = results.pop("multidevice_stat_fish")
    work = tempfile.mkdtemp(prefix="ecseg_multidevice_")
    cwd = os.getcwd()
    tracer = trace.tracer()
    try:
        # metaseg: the default form and ECSEG_DEVICE_PIPELINE=0 against the main path's run
        ref = os.path.join(md_metaseg, "imgs")
        names = sorted(n for n in os.listdir(ref) if n.endswith(".tif"))
        with open(os.path.join(ref, "ec_quantification.csv")) as f:
            counts = {ln.rsplit(",", 1)[0]: int(ln.rsplit(",", 1)[1]) for ln in f.read().splitlines()[1:]}
        single_ms = 1e3 * results["grouped"]["2 + 2"]["wall_s"] / len(names)
        os.chdir(md_metaseg)  # load_model reads models/metaseg.npz from here
        tracer.enabled = True
        forms = (("default", {}, None, 1), ("ECSEG_DEVICE_PIPELINE=0", {"ECSEG_DEVICE_PIPELINE": "0"}, {k: 0 for k in KERNELS}, 0))
        for k, (form, env, per_image, redos) in enumerate(forms):
            sub = os.path.join(work, f"metaseg{k}")
            os.makedirs(sub)
            for name in names:
                shutil.copy(os.path.join(ref, name), sub)
            with parity_probe(f"metaseg mesh, {form}") as probes:
                launches, stages, wall = run_main(sub, "default", len(names), env=env, per_image=per_image, redos=redos, tag=f"metaseg mesh, {form}", devices=mesh)
            if form == "default":
                check(launches == results["launches"]["default"], f"metaseg mesh: launches {launches} != the single-card run's {results['launches']['default']}")
                check(len({t for t, _ in probes}) >= 2, f"metaseg mesh: forwards on {len({t for t, _ in probes})} threads")
            else:  # segment_folder_sharded: a forward per entry per batch of METASEG_SHARDED_BATCH patches
                batches = -(-len(names) * len(tiling.patch_positions(SIZE, SIZE)) // METASEG_SHARDED_BATCH)
                want = {key: n * len(mesh) * batches for key, n in FORWARD_LAUNCHES.items()}
                check({k: launches[k] for k in want} == want, f"metaseg mesh, {form}: forward launches {launches}, expected {want}")
            check_same_outputs(sub, ref, names, counts, f"metaseg mesh, {form}")
            out[f"metaseg {form}"] = {"wall_s": wall, "ms_per_image": 1e3 * wall / len(names), "launches": {k: v for k, v in launches.items() if v},
                                      "stages_s": stages}
        # ROADMAP C8's remainder on the mesh
        out["metaseg ECSEG_DEVICE_PIPELINE=0"]["reordered"] = sharded_host_path_reordered(ref, names, mesh, card)
        host_single_ms = 1e3 * results["host_post"]["wall_s"] / len(results["host_post"]["images"])
        print(f"metaseg mesh: labels, PNGs and CSV rows byte-equal to the single-card run; ms per image: default {out['metaseg default']['ms_per_image']:.1f} "
              f"(single card, 2 + 2: {single_ms:.1f}), ECSEG_DEVICE_PIPELINE=0 {out['metaseg ECSEG_DEVICE_PIPELINE=0']['ms_per_image']:.1f} "
              f"(single card: {host_single_ms:.1f}) [{card}]", flush=True)
        torch.cuda.empty_cache()

        # meta_overlay against the in-process single-card run
        sub = os.path.join(work, "overlay")
        shutil.copytree(md_overlay, sub)
        for f in ("red", "green"):
            shutil.rmtree(os.path.join(sub, f))
        os.remove(os.path.join(sub, "fish_quantification.csv"))
        K.reset_launches()
        with parity_probe("meta_overlay mesh"):
            t0 = time.perf_counter()
            rc = meta_overlay.main(config=Config(raw={"meta_overlay": {"inpath": sub, "color_sensitivity": OVERLAY_SENSITIVITY}}), devices=mesh)
            wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        check(rc == 0 and launches == results["overlay_launches"], f"meta_overlay mesh: rc {rc}, launches {launches} != {results['overlay_launches']}")
        check(read_bytes(os.path.join(sub, "fish_quantification.csv")) == read_bytes(os.path.join(md_overlay, "fish_quantification.csv")), "meta_overlay mesh: CSV bytes differ")
        for f in ("red", "green"):
            got = sorted(os.listdir(os.path.join(sub, f)))
            check(got == sorted(os.listdir(os.path.join(md_overlay, f))), f"meta_overlay mesh: {f}/ holds {got}")
            for name in got:
                check(read_bytes(os.path.join(sub, f, name)) == read_bytes(os.path.join(md_overlay, f, name)), f"meta_overlay mesh: {f}/{name} bytes differ")
        n_rgb = results["overlay"]["images"]
        out["meta_overlay"] = {"wall_s": wall, "ms_per_image": 1e3 * wall / n_rgb, "single_ms_per_image": 1e3 * results["overlay"]["wall_s"] / n_rgb}
        print(f"meta_overlay mesh: CSV and PNG bytes equal the single-card run's, launches {launches}; ms per RGB image {out['meta_overlay']['ms_per_image']:.1f} "
              f"(single card {out['meta_overlay']['single_ms_per_image']:.1f}) [{card}]", flush=True)

        # stat_fish against its command line's (equal to its in-process single-card) run
        sub = os.path.join(work, "stat_fish")
        os.makedirs(sub)
        sf_names = sorted(n for n in os.listdir(md_stat_fish) if n.endswith(".tif"))
        for name in sf_names:
            shutil.copy(os.path.join(md_stat_fish, name), sub)
        os.chdir(os.path.dirname(md_stat_fish))  # models/nuset.npz
        fallbacks.reset()
        K.reset_launches()
        with parity_probe("stat_fish mesh") as probes:
            t0 = time.perf_counter()
            rc = stat_fish.main(config=Config(raw={"stat_fish": {"inpath": sub, "scale": 1, "use_min_cut": True, "nuclei_size_T": STAT_FISH_T}}), devices=mesh)
            wall = time.perf_counter() - t0
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        check(rc == 0 and launches == results["stat_fish"]["launches"], f"stat_fish mesh: rc {rc}, launches {launches} != {results['stat_fish']['launches']}")
        check(len({t for t, _ in probes}) >= 2, f"stat_fish mesh: float32 convolutions on {len({t for t, _ in probes})} threads")
        ann_ref, ann = os.path.join(md_stat_fish, "annotated"), os.path.join(sub, "annotated")
        check(read_bytes(os.path.join(ann, "stat_fish_lsq.csv")) == read_bytes(os.path.join(ann_ref, "stat_fish_lsq.csv")), "stat_fish mesh: CSV bytes differ")
        n_files = 0
        for name in sf_names:
            stem = name[:-4]
            got = sorted(os.listdir(os.path.join(ann, stem)))
            check(got == sorted(os.listdir(os.path.join(ann_ref, stem))), f"stat_fish mesh: annotated/{stem} holds {got}")
            for fname in got:
                a_, b_ = os.path.join(ann, stem, fname), os.path.join(ann_ref, stem, fname)
                if fname.endswith(".npy"):
                    check(read_bytes(a_) == read_bytes(b_), f"stat_fish mesh: {fname} bytes differ")
                else:
                    check(np.array_equal(imgio.imread_rgb(a_), imgio.imread_rgb(b_)), f"stat_fish mesh: {fname} pixels differ")
                n_files += 1
        out["stat_fish"] = {"wall_s": wall, "ms_per_image": 1e3 * wall / len(sf_names), "single_ms_per_image": 1e3 * results["stat_fish"]["wall_s"] / len(sf_names),
                            "files_compared": n_files, "fallbacks": fallbacks.counts()}
        print(f"stat_fish mesh: CSV, .npy and TIFFs ({n_files} files) equal the single-card run's, launches {launches}; ms per image "
              f"{out['stat_fish']['ms_per_image']:.1f} (single card {out['stat_fish']['single_ms_per_image']:.1f}) [{card}]", flush=True)

        # interseg against its in-process single-card run, on stat_fish's folder
        models = os.path.join(work, "interseg_models")
        save_npz(os.path.join(models, "interseg.npz"), demo_ecseg_i_tree())
        save_npz(os.path.join(models, "ecseg_c.npz"), demo_ecseg_c_tree())
        out_csv = os.path.join(md_stat_fish, "interphase_prediction_red.csv")
        want = read_bytes(out_csv)
        os.remove(out_csv)
        os.chdir(work)
        K.reset_launches()
        with parity_probe("interseg mesh") as probes:
            t0 = time.perf_counter()
            rc = interseg.main(config=Config(raw={"interseg": {"inpath": md_stat_fish, "FISH_color": "red", "has_centromeric_probe": True}}), devices=mesh)
            wall = time.perf_counter() - t0
        check(rc == 0 and not any(K.LAUNCHES.values()), f"interseg mesh: rc {rc}, launches {dict(K.LAUNCHES)}")
        check(read_bytes(out_csv) == want, "interseg mesh: CSV bytes differ from the single-card run's")
        check(len({t for t, _ in probes}) >= 2, f"interseg mesh: float32 convolutions on {len({t for t, _ in probes})} threads")
        out["interseg"] = {"wall_s": wall, "ms_per_image": 1e3 * wall / len(sf_names), "single_ms_per_image": 1e3 * results["interseg"]["wall_s"] / len(sf_names)}
        print(f"interseg mesh: CSV bytes equal the single-card run's; ms per image {out['interseg']['ms_per_image']:.1f} "
              f"(single card {out['interseg']['single_ms_per_image']:.1f}) [{card}]", flush=True)
        os.chdir(cwd)
        tracer.enabled = False

        # the mesh train step: (data 2, model 2) against one card
        cards = torch.cuda.device_count()
        train_entries = [f"cuda:{k % cards}" for k in range(2 * MULTIDEVICE_TRAIN_MODEL_AXIS)]
        tmesh = make_mesh(train_entries, model_axis=MULTIDEVICE_TRAIN_MODEL_AXIS)
        pairs = load_training_pairs(results["train_folder"])
        batches = list(crop_batches(pairs, TRAIN_BATCH, MULTIDEVICE_TRAIN_STEPS, seed=args.seed + 9))
        model0 = MetasegUNet(generator=torch.Generator().manual_seed(args.seed))
        t0 = time.perf_counter()
        x0, y0 = (torch.from_numpy(a) for a in batches[0])
        loss64, g64 = _loss_and_grads(model0, x0, y0, torch.float64, "cpu", contextlib.nullcontext())
        _, g32 = _loss_and_grads(model0, x0, y0, torch.float32, "cpu", contextlib.nullcontext())
        cpu_s = time.perf_counter() - t0
        err_cpu = _rel_p90_errors(g32, g64)
        bound = {n: TRAIN_GRAD_FACTOR * (e + TRAIN_GRAD_TOL) for n, e in err_cpu.items()}

        def single_run(dtype, steps):
            model = copy.deepcopy(model0).to(dev)
            opt = tt.make_optimizer(model, TRAIN_LR)
            losses, grads, ms = [], None, []
            for k, (x, y) in enumerate(batches[:steps]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses.append(float(tt.train_step(model, opt, x, y, dtype=dtype)))
                ms.append(1e3 * (time.perf_counter() - t))
                if k == 0:
                    grads = {n: p.grad.double().cpu() for n, p in model.named_parameters()}
            return losses, grads, ms

        def mesh_run(dtype, steps):
            step = tt.train_step_on_mesh(tmesh, copy.deepcopy(model0), TRAIN_LR, dtype=dtype)
            losses, grads, ms = [], None, []
            for k, (x, y) in enumerate(batches[:steps]):
                torch.cuda.synchronize()
                t = time.perf_counter()
                losses.append(float(step(x, y)))
                ms.append(1e3 * (time.perf_counter() - t))
                if k == 0:
                    grads = _mesh_grads(step)
            split = sorted(step.model.shard_dims())
            del step
            return losses, grads, ms, split

        K.reset_launches()
        l_card, g_card, ms_card = single_run(torch.float32, MULTIDEVICE_TRAIN_STEPS)
        with parity_probe("train mesh, float32") as probes:
            l_mesh, g_mesh, ms_mesh, split = mesh_run(torch.float32, MULTIDEVICE_TRAIN_STEPS)
        check(not any(K.LAUNCHES.values()), f"training launched hand kernels: {dict(K.LAUNCHES)}")
        check(len({t for t, _ in probes}) >= 2, f"train mesh: forwards on {len({t for t, _ in probes})} threads")
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(l_mesh, l_card)]
        err_mesh, err_card = _rel_p90_errors(g_mesh, g64), _rel_p90_errors(g_card, g64)
        err_vs_card = _rel_p90_errors(g_mesh, g_card)
        over = {n: err_mesh[n] / bound[n] for n in bound}
        over_card = {n: err_vs_card[n] / bound[n] for n in bound}
        print(f"train mesh {[list(map(str, r)) for r in tmesh.devices]} (data 2, model 2; split: {split}): float32 losses {l_mesh} vs one card {l_card} "
              f"(rel {max(loss_rel):.3g}); first step's gradients, 90th percentile of |diff| / max |g|: from float64 the mesh {max(err_mesh.values()):.3g} "
              f"(worst share of its bound {max(over.values()):.3f}, at {max(over, key=over.get)}), one card {max(err_card.values()):.3g}, "
              f"CPU float32 {max(err_cpu.values()):.3g}; mesh vs one card {max(err_vs_card.values()):.3g} (worst share {max(over_card.values()):.3f}); "
              f"CPU float64 + float32 on {TRAIN_BATCH} crops {cpu_s:.1f} s [{card}]", flush=True)
        check(max(loss_rel) <= TRAIN_LOSS_RTOL, f"train mesh: losses {l_mesh} vs one card {l_card}")
        check(max(over.values()) <= 1.0, f"train mesh: float32 gradients outside their bound: {over}")
        check(max(over_card.values()) <= 1.0, f"train mesh: float32 gradients vs one card's outside the bound: {over_card}")
        check(len(split) > 0, "train mesh: no kernel split over the model axis")
        lb_card, gb_card, _ = single_run(torch.bfloat16, 1)
        lb_mesh, gb_mesh, _, _ = mesh_run(torch.bfloat16, 1)
        bf16_rel = {n: float((gb_mesh[n] - g).norm() / g.norm()) for n, g in gb_card.items()}
        print(f"train mesh, bf16: loss {lb_mesh[0]} vs one card {lb_card[0]}; gradients' relative L2 vs one card up to {max(bf16_rel.values()):.3g} "
              f"(bound {MULTIDEVICE_BF16_GRAD_TOL:.3g}) [{card}]", flush=True)
        check(abs(lb_mesh[0] - lb_card[0]) <= 2.0**-8 * abs(lb_card[0]), f"train mesh bf16: loss {lb_mesh[0]} vs {lb_card[0]}")
        check(max(bf16_rel.values()) <= MULTIDEVICE_BF16_GRAD_TOL, f"train mesh bf16: gradients {bf16_rel}")
        out["train"] = {"mesh": [list(map(str, r)) for r in tmesh.devices], "split": split, "losses": l_mesh, "single_losses": l_card,
                        "loss_rel": loss_rel, "grad_p90_from_f64": max(err_mesh.values()), "grad_share_of_bound": max(over.values()),
                        "grad_p90_vs_card": max(err_vs_card.values()), "step_ms": ms_mesh, "single_step_ms": ms_card,
                        "bf16_loss": lb_mesh[0], "single_bf16_loss": lb_card[0], "bf16_grad_rel_l2": max(bf16_rel.values()), "cpu_s": cpu_s}
        print(f"train step ms (host clock, synchronised; the first pays cuDNN's set-up): mesh {[round(t, 1) for t in ms_mesh]}, "
              f"one card {[round(t, 1) for t in ms_card]} [{card}]", flush=True)
        out["phase_s"] = time.perf_counter() - phase_t0
        print(f"phase_multidevice: {out['phase_s']:.1f} s [{card}]", flush=True)
        results["multidevice"] = out
    finally:
        os.chdir(cwd)
        tracer.enabled = False
        for d in (work, md_metaseg, os.path.dirname(md_overlay), os.path.dirname(md_stat_fish)):
            shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()


QUANT_CARD_AGREEMENT = 0.99  # the card's int8 labels against the CPU's on 2 patches
QUANT_FLOAT_AGREEMENT = 0.95  # int8 against float32 labels, tests/test_quant.py's bound
QUANT_ACC = (("enc2_1", (2, 128, 128, 32), False), ("up1", (2, 128, 128, 64), True))  # int32 accumulators held card vs CPU


def phase_quant(args, dev, results):
    """The int8 U-Net (``models/quant.py``; no entry point runs it) at the
    default widths with the main path's crafted demo weights, on image 0's
    100 patches.  Checks: every int8 kernel and scale quantized on the card
    bit-equal to the CPU's; the int32 accumulators of ``enc2_1`` and of the
    transpose ``up1`` on a seeded int8 input equal on the card and the CPU
    (``QUANT_ACC``); the card's labels (u8 quantize + argmax) on 2 patches
    against the CPU port's int8 labels (>= ``QUANT_CARD_AGREEMENT``); the
    card's int8 labels against its float32 forward's on the 100 patches (>=
    ``QUANT_FLOAT_AGREEMENT``).  Times a 100-patch forward in int8, bf16
    and float32 (CUDA events) and counts the weights' bytes."""
    from ecseg_torch.models import quant
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.models.weights import params_to_numpy, quant_params_from_numpy
    from ecseg_torch.ops import tiling

    patches, _ = results["metaseg_patches"]
    unet = demo_metaseg_params(torch.Generator().manual_seed(args.seed)).eval()
    tree = params_to_numpy(unet)
    for name, p in tree.items():
        if name in quant.DEFAULT_SKIP:
            continue
        kq, scale = quant.quantize_kernel(p["kernel"])
        kq_d, scale_d = quant.quantize_kernel(torch.from_numpy(p["kernel"]).to(dev))
        check(torch.equal(kq_d.cpu(), kq) and torch.equal(scale_d.cpu().view(torch.int32), scale.view(torch.int32)),
              f"int8 {name}: the card's kernel or scales != the CPU's")
    q_cpu = quant_params_from_numpy(tree)
    q_dev = copy.deepcopy(q_cpu).to(dev)
    qrng = np.random.default_rng(args.seed + 9)
    for name, shape, transpose in QUANT_ACC:
        xq = torch.from_numpy(qrng.integers(-127, 128, shape).astype(np.int8))
        kq = q_cpu.layers[name].tree()["kernel_q"]
        acc = quant.qconv_int32(xq, kq, transpose)
        check(torch.equal(quant.qconv_int32(xq.to(dev), kq.to(dev), transpose).cpu(), acc), f"int8 {name}: the card's int32 accumulators != the CPU's")
    x = torch.from_numpy(patches).to(dev)
    t0 = time.perf_counter()
    lab_cpu = tiling.patch_labels(q_cpu(x[:2].cpu()))
    cpu_s = time.perf_counter() - t0
    unet.to(dev)
    with torch.no_grad():
        lab_q = tiling.patch_labels(q_dev(x))
        lab_f = tiling.patch_labels(unet(x))
        card_agree = float((lab_q[:2].cpu() == lab_cpu).float().mean())
        float_agree = float((lab_q == lab_f).float().mean())
        ms = {"int8": cuda_ms(lambda: q_dev(x), 2), "bf16": cuda_ms(lambda: unet(x, torch.bfloat16), 2), "float32": cuda_ms(lambda: unet(x), 2)}
    check(card_agree >= QUANT_CARD_AGREEMENT, f"int8 labels on the card vs the CPU on 2 patches agree on {card_agree}")
    check(float_agree >= QUANT_FLOAT_AGREEMENT, f"int8 labels vs the float32 forward's agree on {float_agree}")
    nbytes = {"int8": sum(b.numel() * b.element_size() for b in q_cpu.buffers()), "float32": sum(p.numel() * 4 for p in unet.parameters())}
    results["quant"] = {"patches": len(patches), "card_vs_cpu_agreement_2_patches": card_agree, "vs_float32_agreement": float_agree,
                        "forward_ms": ms, "weight_bytes": nbytes, "cpu_2_patches_s": cpu_s}
    print(f"int8 U-Net: kernels, scales and the int32 accumulators of {[n for n, _, _ in QUANT_ACC]} equal on the card and the CPU; "
          f"labels card vs CPU on 2 patches agree {card_agree:.6f}, vs float32 on {len(patches)} patches {float_agree:.6f}; "
          f"{len(patches)}-patch forward ms " + " ".join(f"{k} {v:.2f}" for k, v in ms.items())
          + f"; weights {nbytes['int8']} bytes int8 vs {nbytes['float32']} float32 [{results['card']}]", flush=True)


def phase_keras_import(args, dev, results):
    """The imported-Keras executor on the card, from an in-memory config and
    weights (``DictFetcher``; the card's machine has no h5py): the metaseg
    U-Net at its default widths as a Keras Functional graph
    (``unet_keras_config``), holding the crafted demo metaseg weights of the
    main path, over image 0's 2048^2 patch stack, its stitched labels
    (``metaseg.segment_raw``: forward, u8 quantize + argmax, B1) byte-equal
    to ``MetasegUNet``'s with the same weights; ecSeg-i as a Keras
    Sequential (``ecseg_i_keras_config``) with the demo tree against
    ``EcsegI`` on the interseg phase's last crops: argmax equal,
    probabilities within ``INTERSEG_PROB_ATOL``.  Times both forwards
    beside their modules'."""
    from ecseg_torch.models.classifiers import EcsegI
    from ecseg_torch.models.demo import demo_ecseg_i_tree, demo_metaseg_params
    from ecseg_torch.models.keras_import import KerasModel, import_from_config
    from ecseg_torch.models.metaseg_unet import BOTTLENECK, ENC_WIDTHS, NUM_CLASSES
    from ecseg_torch.models.weights import classifier_from_numpy, params_to_numpy
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.pipelines import metaseg

    patches, pos = results.pop("metaseg_patches")
    unet = demo_metaseg_params(torch.Generator().manual_seed(args.seed)).to(dev).eval()
    tree = params_to_numpy(unet)
    keras = import_from_config(unet_keras_config(ENC_WIDTHS, BOTTLENECK, NUM_CLASSES), DictFetcher(unet_keras_weights(tree)), dev)
    check(isinstance(keras, KerasModel) and all(b.is_cuda for b in keras.buffers()), "the executor's weights are not on the card")
    K.reset_launches()
    raw_keras = metaseg.segment_raw(keras, patches, pos)
    check(K.LAUNCHES["stitch"] == 1, f"the executor's segment_raw launched {dict(K.LAUNCHES)}")
    raw_unet = metaseg.segment_raw(unet, patches, pos)
    check(raw_keras.shape == (SIZE, SIZE) and torch.equal(raw_keras, raw_unet), "the executor's stitched metaseg labels != MetasegUNet's")
    x = torch.from_numpy(patches).to(dev)
    with torch.no_grad():
        unet_err = float((keras(x[:8]) - unet(x[:8])).abs().max())
        keras_ms, unet_ms = cuda_ms(lambda: keras(x), 2), cuda_ms(lambda: unet(x), 2)

    itree = demo_ecseg_i_tree()
    ecseg_i = classifier_from_numpy(itree).to(dev).eval()
    check(isinstance(ecseg_i, EcsegI), "the demo ecSeg-i tree did not build EcsegI")
    seq = import_from_config(ecseg_i_keras_config(), DictFetcher(classifier_keras_weights(itree)), dev)
    xi = torch.from_numpy(results.pop("interseg_batch")[..., 0]).to(dev)
    with torch.no_grad():
        pk, pm = seq(xi), ecseg_i(xi)
        i_err = float((pk - pm).abs().max())
        seq_ms, mod_ms = cuda_ms(lambda: seq(xi), 3), cuda_ms(lambda: ecseg_i(xi), 3)
    check(torch.equal(pk.argmax(-1), pm.argmax(-1)) and i_err <= INTERSEG_PROB_ATOL, f"the executor's ecSeg-i != EcsegI (max |diff| {i_err})")
    card = results["card"]
    print(f"keras executor: metaseg U-Net ({len(patches)} patches of image 0) stitched labels byte-equal to MetasegUNet's, "
          f"probabilities max |diff| {unet_err:.3g} on 8 patches; forward {keras_ms:.2f} ms vs MetasegUNet {unet_ms:.2f} ms; "
          f"ecSeg-i Sequential on {len(xi)} crops max |diff| {i_err:.3g}, argmax equal; {seq_ms:.2f} ms vs EcsegI {mod_ms:.2f} ms [{card}]", flush=True)
    results["keras_import"] = {
        "unet_patches": len(patches), "unet_labels_equal": True, "unet_max_abs": unet_err, "unet_ms": {"executor": keras_ms, "module": unet_ms},
        "ecseg_i_crops": len(xi), "ecseg_i_max_abs": i_err, "ecseg_i_ms": {"executor": seq_ms, "module": mod_ms},
    }


def phase_keras_h5(args, dev, results):
    """The ``.h5`` entry points as a user runs them, through the port's own
    HDF5 reader (``core/hdf5.py``; the card's machine has no h5py).
    metaseg: ``models/metaseg.h5`` written by ``hdf5.write_keras_h5`` (the legacy
    layout TF-Keras 2 writes) from ``unet_keras_config`` at the default
    widths with the main path's demo weights, in a directory with a
    ``config.yaml`` whose folder holds the main path's four 2048^2 images
    (the crowded ``img2`` among them); ``python3 -m
    ecseg_torch.pipelines.metaseg`` as a subprocess on the default device,
    then ``main`` in-process on a copy (``run_main``: B1-B6 launched
    ``PER_IMAGE_LAUNCHES`` x 4 times, no H1: the executor's convs stay on
    cuDNN; one host redo).  Checks: exit code 0,
    the ``.h5`` named on stderr, every ``labels/*.npy`` and the CSV
    byte-equal between the two runs and to the main path's run of the same
    weights from ``metaseg.npz``, and each image's labels equal to the host
    oracle on its raw canvas.  interseg: ``interseg_models/interseg.h5`` and
    ``ecseg_c.h5`` (``ecseg_i_keras_config``, ``ecseg_c_keras_config``, the
    demo trees) and no ``.npz`` beside them, on a copy of the folder that
    ``phase_interseg`` ran on; ``python3 -m ecseg_torch.pipelines.interseg``
    must write that run's CSV bytes, and that run gave ecSeg-c rows.
    Prints the reader's host seconds (the file parsed and read, the
    executor built on the CPU) and each command's wall time beside the
    card."""
    from ecseg_torch.core import hdf5
    from ecseg_torch.models.demo import demo_ecseg_c_tree, demo_ecseg_i_tree, demo_metaseg_params
    from ecseg_torch.models.keras_import import KerasModel, import_keras_h5
    from ecseg_torch.models.metaseg_unet import BOTTLENECK, ENC_WIDTHS, NUM_CLASSES
    from ecseg_torch.models.weights import params_to_numpy
    from ecseg_torch.ops.meta_post import meta_inference
    from ecseg_torch.pipelines import metaseg

    card = results["card"]
    phase_t0 = time.perf_counter()
    npz_run = results.pop("keras_h5_metaseg")
    sf_folder = results.pop("keras_h5_stat_fish")
    work = tempfile.mkdtemp(prefix="ecseg_keras_h5_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cwd = os.getcwd()
    out = {}
    try:
        # metaseg from models/metaseg.h5
        mwork = os.path.join(work, "metaseg")
        h5_path = os.path.join(mwork, "models", "metaseg.h5")
        os.makedirs(os.path.dirname(h5_path))
        tree = params_to_numpy(demo_metaseg_params(torch.Generator().manual_seed(args.seed)))
        t0 = time.perf_counter()
        size = hdf5.write_keras_h5(h5_path, unet_keras_config(ENC_WIDTHS, BOTTLENECK, NUM_CLASSES), unet_keras_weights(tree))
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with hdf5.File(h5_path) as f:
            arrays = []
            f.visititems(lambda name, obj: arrays.append(np.array(obj)) if isinstance(obj, hdf5.Dataset) else None)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host_model = import_keras_h5(h5_path, device="cpu")
        import_s = time.perf_counter() - t0
        n_params = sum(a.size for p in tree.values() for a in p.values())
        check(sum(a.size for a in arrays) == n_params and sum(b.numel() for b in host_model.buffers()) == n_params,
              f"metaseg.h5 holds {sum(a.size for a in arrays)} floats, the executor {sum(b.numel() for b in host_model.buffers())}, the tree {n_params}")
        del host_model, arrays
        names = sorted(n for n in os.listdir(npz_run) if n.endswith(".tif"))
        for sub in ("imgs", "inproc"):
            os.makedirs(os.path.join(mwork, sub))
            for name in names:
                shutil.copy(os.path.join(npz_run, name), os.path.join(mwork, sub))
        with open(os.path.join(mwork, "config.yaml"), "w") as f:
            f.write("metaseg:\n  inpath: ./imgs\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ecseg_torch.pipelines.metaseg"], cwd=mwork, env=env, capture_output=True, text=True, timeout=600)
        metaseg_cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"metaseg.h5: python -m ecseg_torch.pipelines.metaseg exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        check(f"[ecseg] loading model {os.path.join('models', 'metaseg.h5')}" in proc.stderr, f"metaseg.h5: the command line did not load the .h5:\n{proc.stderr[-2000:]}")
        check(proc.stdout.count("Processing image:") == len(names), "metaseg.h5: the command line did not process every image")
        os.chdir(mwork)  # load_model reads models/metaseg.h5 from here
        # the .h5 executor keeps cuDNN: the post's launches, no H1
        launches, _, inproc_s = run_main(os.path.join(mwork, "inproc"), "default", len(names), tag="metaseg.h5 in-process",
                                         per_image=PER_IMAGE_LAUNCHES["default"] | dict.fromkeys(FORWARD_LAUNCHES, 0))
        model = metaseg.load_model(device=dev)
        check(isinstance(model, KerasModel) and all(b.is_cuda for b in model.buffers()), "metaseg.h5: load_model did not give the executor on the card")
        for name in names + ["ec_quantification.csv"]:
            rel = name if name.endswith(".csv") else os.path.join("labels", name[:-4] + ".npy")
            cli = read_bytes(os.path.join(mwork, "imgs", rel))
            check(cli == read_bytes(os.path.join(mwork, "inproc", rel)), f"metaseg.h5: the command line's {rel} bytes != the in-process run's")
            check(cli == read_bytes(os.path.join(npz_run, rel)), f"metaseg.h5: {rel} bytes != the main path's metaseg.npz run's")
        with post_form("default"):
            for name in names:
                patches, pos = metaseg._prepare_image(os.path.join(mwork, "imgs", name), save_dapi=False)
                raw = metaseg.segment_raw(model, patches, pos)
                want = meta_inference(raw.cpu().numpy().astype(np.int64))
                check(np.array_equal(np.load(os.path.join(mwork, "imgs", "labels", name[:-4] + ".npy")), want), f"metaseg.h5: {name} labels != host oracle")
        del model
        os.chdir(cwd)
        out["metaseg"] = {"h5_bytes": size, "write_s": write_s, "parse_s": parse_s, "import_cpu_s": import_s, "cli_s": metaseg_cli_s,
                          "inproc_s": inproc_s, "images": len(names), "launches": {k: v for k, v in launches.items() if v}}
        print(f"metaseg.h5 ({size} bytes, written in {write_s:.2f} s): host read {parse_s:.3f} s (file parsed, {n_params} floats read), "
              f"executor built on the CPU from the file {import_s:.3f} s; python -m ecseg_torch.pipelines.metaseg on {len(names)} images of "
              f"{SIZE}x{SIZE} {metaseg_cli_s:.2f} s (process start and model load included), in-process main {inproc_s:.3f} s, launches "
              f"{out['metaseg']['launches']}; labels and CSV byte-equal to the in-process run, the metaseg.npz run and the host oracle [{card}]", flush=True)
        torch.cuda.empty_cache()

        # interseg from interseg_models/interseg.h5 and ecseg_c.h5
        iwork = os.path.join(work, "interseg")
        models = os.path.join(iwork, "interseg_models")
        os.makedirs(models)
        sizes = {
            "interseg.h5": hdf5.write_keras_h5(os.path.join(models, "interseg.h5"), ecseg_i_keras_config(), classifier_keras_weights(demo_ecseg_i_tree())),
            "ecseg_c.h5": hdf5.write_keras_h5(os.path.join(models, "ecseg_c.h5"), ecseg_c_keras_config(), classifier_keras_weights(demo_ecseg_c_tree())),
        }
        out_csv = os.path.join(sf_folder, "interphase_prediction_red.csv")
        want = read_bytes(out_csv)
        os.remove(out_csv)
        c_rows = sum(v["ecseg_c_rows"] for v in results["interseg"]["per_image"].values())
        check(c_rows > 0, f"the .npz run of interseg gave no ecSeg-c row: {results['interseg']['per_image']}")
        with open(os.path.join(iwork, "config.yaml"), "w") as f:
            f.write(f"interseg:\n  inpath: {sf_folder}\n  FISH_color: red\n  has_centromeric_probe: True\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ecseg_torch.pipelines.interseg"], cwd=iwork, env=env, capture_output=True, text=True, timeout=300)
        interseg_cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"interseg .h5: python -m ecseg_torch.pipelines.interseg exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        for f in sizes:
            check(f"[ecseg] loading model {os.path.join('interseg_models', f)}" in proc.stderr, f"interseg: the command line did not load {f}:\n{proc.stderr[-2000:]}")
        check(read_bytes(out_csv) == want, "interseg .h5: the CSV bytes != the interseg_models/*.npz run's")
        out["interseg"] = {"h5_bytes": sizes, "cli_s": interseg_cli_s, "csv_rows": want.decode().count("\n") - 1, "ecseg_c_rows": c_rows}
        out["phase_s"] = time.perf_counter() - phase_t0
        print(f"interseg .h5 (interseg.h5 {sizes['interseg.h5']} bytes, ecseg_c.h5 {sizes['ecseg_c.h5']}): python -m ecseg_torch.pipelines.interseg "
              f"{interseg_cli_s:.2f} s, {out['interseg']['csv_rows']} CSV rows byte-equal to the .npz run's ({c_rows} ecSeg-c rows); "
              f"phase_keras_h5: {out['phase_s']:.1f} s [{card}]", flush=True)
        results["keras_h5"] = out
        results["tf_models_stat_fish"] = sf_folder  # stat_fish's command line's outputs and this interseg CSV
    finally:
        os.chdir(cwd)
        for d in (work, os.path.dirname(npz_run)) + (() if "tf_models_stat_fish" in results else (os.path.dirname(sf_folder),)):
            shutil.rmtree(d, ignore_errors=True)


TF_MODELS_TIMEOUT_S = 600  # each command line of phase_tf_models


def _tree_leaves(tree, prefix=()):
    for k, v in tree.items():
        yield from _tree_leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]


def phase_tf_models(args, dev, results):
    """The reference's TensorFlow-format models on the card's machine, which
    has no TensorFlow: the two converters as a user runs them, then the
    tasks from what they wrote.  NuSeT: ``confident_nuset_tree`` (the demo
    NuSeT at its published widths, 64-512 and a 1024 bottleneck, as
    ``phase_stat_fish`` ran it) written by ``write_tf_bundle`` as the
    reference's TF1 checkpoint pair ``models/nuset/{whole_norm,foreground}.ckpt``
    under its graph's names (``nuset_tf1_checkpoints``: transpose-conv
    kernels as TF keeps them, an Adam slot, ``beta1_power``,
    ``global_step``); ``python3 -m ecseg_torch.convert_tf1_ckpt`` with its
    defaults; ``models/nuset.npz`` must equal the tree array for array.
    Then ``python3 -m ecseg_torch.pipelines.stat_fish`` from it on
    ``phase_stat_fish``'s three 2048^2 images: every CSV, ``.npy`` and TIFF
    byte-equal to that phase's command line run from the tree's
    ``nuset.npz``; ``stat_fish.main`` in-process on a copy (launch counters
    set to 0 just before, read just after): four B2 an image, one B3 a
    watershed with markers, at least one, nothing else, and the same CSV.
    interseg: the demo ecSeg-i and ecSeg-c (``ecseg_i_keras_config``,
    ``ecseg_c_keras_config``) written by ``write_keras_savedmodel`` as
    SavedModel directories (``keras_metadata.pb`` in Keras's SavedModel
    encoding and the variables bundle with its object graph);
    ``python3 -m ecseg_torch.convert_savedmodel`` for each into
    ``interseg_models/{interseg,ecseg_c}.h5``; ``python3 -m
    ecseg_torch.pipelines.interseg`` on the folder that stat_fish just
    wrote: its CSV byte-equal to ``phase_keras_h5``'s interseg run.  Prints
    the bytes written, each converter's and each command's wall seconds
    (the converters run on the host only) and the phase's total beside the
    card."""
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.demo import demo_ecseg_c_tree, demo_ecseg_i_tree
    from ecseg_torch.models.weights import load_npz
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.pipelines import stat_fish

    card = results["card"]
    phase_t0 = time.perf_counter()
    ref = results.pop("tf_models_stat_fish")  # phase_stat_fish's command line's folder, interseg's CSV in it
    work = tempfile.mkdtemp(prefix="ecseg_tf_models_")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cwd = os.getcwd()
    out = {}

    def command(*argv):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=work, env=env, capture_output=True, text=True, timeout=TF_MODELS_TIMEOUT_S)
        check(proc.returncode == 0, f"python -m {' '.join(argv)} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        return proc, time.perf_counter() - t0

    try:
        # NuSeT: the TF1 checkpoint pair -> models/nuset.npz
        tree = confident_nuset_tree(args.seed)
        ckpt_dir = os.path.join(work, "models", "nuset")
        os.makedirs(ckpt_dir)
        t0 = time.perf_counter()
        ckpt_bytes = sum(write_tf_bundle(os.path.join(ckpt_dir, f), t) for f, t in nuset_tf1_checkpoints(tree).items())
        write_s = time.perf_counter() - t0
        proc, convert_s = command("ecseg_torch.convert_tf1_ckpt")
        check(proc.stdout == f"wrote {os.path.join('models', 'nuset.npz')}\n", f"convert_tf1_ckpt printed {proc.stdout!r}")
        want, got = dict(_tree_leaves(tree)), dict(_tree_leaves(load_npz(os.path.join(work, "models", "nuset.npz"))))
        check(got.keys() == want.keys() and all(got[k].dtype == v.dtype and got[k].shape == v.shape and got[k].tobytes() == v.tobytes() for k, v in want.items()),
              "convert_tf1_ckpt: models/nuset.npz != the tree written as checkpoints")
        n_params = sum(v.size for v in want.values())
        print(f"NuSeT as TF1 checkpoints ({ckpt_bytes} bytes, {n_params} parameters, written in {write_s:.2f} s): python -m "
              f"ecseg_torch.convert_tf1_ckpt {convert_s:.2f} s (host only, process start included), nuset.npz equal to the tree [{card}]", flush=True)

        # stat_fish from the converted npz on phase_stat_fish's images
        names = sorted(n for n in os.listdir(ref) if n.endswith(".tif"))
        for sub in ("imgs", "inproc"):
            os.makedirs(os.path.join(work, sub))
            for name in names:
                shutil.copy(os.path.join(ref, name), os.path.join(work, sub))
        with open(os.path.join(work, "config.yaml"), "w") as f:  # phase_stat_fish's bytes: stat_fish copies it into annotated/
            f.write(f"stat_fish:\n  inpath: ./imgs\n  scale: 1\n  use_min_cut: True\n  nuclei_size_T: {STAT_FISH_T}\n")
        proc, stat_fish_s = command("ecseg_torch.pipelines.stat_fish")
        check(proc.stdout.count("Processing image:") == len(names), "tf models: the stat_fish command line did not process every image")
        ann, ref_ann = os.path.join(work, "imgs", "annotated"), os.path.join(ref, "annotated")
        files = sorted(os.path.relpath(os.path.join(d, f), ref_ann) for d, _, fs in os.walk(ref_ann) for f in fs)
        check(files == sorted(os.path.relpath(os.path.join(d, f), ann) for d, _, fs in os.walk(ann) for f in fs) and len(files) > len(names),
              f"tf models: stat_fish wrote other files than phase_stat_fish's command line: {files}")
        for rel in files:
            check(read_bytes(os.path.join(ann, rel)) == read_bytes(os.path.join(ref_ann, rel)), f"tf models: stat_fish's {rel} bytes != phase_stat_fish's")
        os.chdir(work)  # models/nuset.npz
        K.reset_launches()
        try:
            t0 = time.perf_counter()
            rc = stat_fish.main(config=Config(raw={"stat_fish": {"inpath": os.path.join(work, "inproc"), "scale": 1, "use_min_cut": True,
                                                                 "nuclei_size_T": STAT_FISH_T}}), device="cuda")
            inproc_s = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
        launches = dict(K.LAUNCHES)
        check(rc == 0, f"tf models: in-process stat_fish.main returned {rc}")
        check(launches["label"] == STAT_FISH_LABELS_PER_IMAGE * len(names), f"tf models: B2 launched {launches['label']} times")
        check(1 <= launches["flood_border"] <= len(names), f"tf models: B3 launched {launches['flood_border']} times")
        check(launches["conv3x3"] == NUSET_FORWARD_LAUNCHES["conv3x3"] * len(names), f"tf models: H1 launched {launches['conv3x3']} times")
        check(all(n == 0 for k, n in launches.items() if k not in ("label", "flood_border", "conv3x3")), f"tf models: stat_fish launched {launches}")
        check(read_bytes(os.path.join(work, "inproc", "annotated", "stat_fish_lsq.csv")) == read_bytes(os.path.join(ref_ann, "stat_fish_lsq.csv")),
              "tf models: the in-process stat_fish CSV != phase_stat_fish's")
        print(f"stat_fish from the converted nuset.npz: python -m ecseg_torch.pipelines.stat_fish {stat_fish_s:.2f} s on {len(names)} "
              f"images of {SIZE}x{SIZE}, {len(files)} files byte-equal to phase_stat_fish's command line; in-process {inproc_s:.3f} s, "
              f"launches {({k: v for k, v in launches.items() if v})} [{card}]", flush=True)

        # interseg: SavedModels -> interseg_models/*.h5
        sm_bytes, convert_h5_s = {}, {}
        for name, cfg, t in (("interseg", ecseg_i_keras_config(), demo_ecseg_i_tree()), ("ecseg_c", ecseg_c_keras_config(), demo_ecseg_c_tree())):
            sm_bytes[name] = write_keras_savedmodel(os.path.join(work, "savedmodels", name), cfg, classifier_keras_weights(t))
            os.makedirs(os.path.join(work, "interseg_models"), exist_ok=True)
            h5 = os.path.join("interseg_models", f"{name}.h5")
            proc, convert_h5_s[name] = command("ecseg_torch.convert_savedmodel", os.path.join("savedmodels", name), h5)
            check(proc.stdout == f"wrote {h5}\n", f"convert_savedmodel printed {proc.stdout!r}")
        with open(os.path.join(work, "config.yaml"), "w") as f:
            f.write("interseg:\n  inpath: ./imgs\n  FISH_color: red\n  has_centromeric_probe: True\n")
        proc, interseg_s = command("ecseg_torch.pipelines.interseg")
        for name in ("interseg", "ecseg_c"):
            check(f"[ecseg] loading model {os.path.join('interseg_models', name + '.h5')}" in proc.stderr,
                  f"tf models: interseg did not load {name}.h5:\n{proc.stderr[-2000:]}")
        csv = read_bytes(os.path.join(work, "imgs", "interphase_prediction_red.csv"))
        check(csv == read_bytes(os.path.join(ref, "interphase_prediction_red.csv")), "tf models: interseg's CSV bytes != phase_keras_h5's")
        out = {"nuset_ckpt_bytes": ckpt_bytes, "nuset_write_s": write_s, "convert_tf1_ckpt_s": convert_s, "stat_fish_cli_s": stat_fish_s,
               "stat_fish_inproc_s": inproc_s, "files_compared": len(files), "launches": {k: v for k, v in launches.items() if v},
               "savedmodel_bytes": sm_bytes, "convert_savedmodel_s": convert_h5_s, "interseg_cli_s": interseg_s,
               "csv_rows": csv.decode().count("\n") - 1, "phase_s": time.perf_counter() - phase_t0}
        print(f"interseg from SavedModels (interseg {sm_bytes['interseg']} bytes, ecseg_c {sm_bytes['ecseg_c']}): python -m "
              f"ecseg_torch.convert_savedmodel {convert_h5_s['interseg']:.2f} s and {convert_h5_s['ecseg_c']:.2f} s (host only), python -m "
              f"ecseg_torch.pipelines.interseg {interseg_s:.2f} s, {out['csv_rows']} CSV rows byte-equal to phase_keras_h5's; "
              f"phase_tf_models: {out['phase_s']:.1f} s [{card}]", flush=True)
        results["tf_models"] = out
    finally:
        os.chdir(cwd)
        for d in (work, os.path.dirname(ref)):
            shutil.rmtree(d, ignore_errors=True)


TRAIN_BATCH = 16  # scripts/train_metaseg.py's default
TRAIN_LR = 1e-4  # the script's default
# card float32 gradients, per tensor: the 90th percentile of |g - g64| / max |g64| (g64: the CPU's
# float64 gradient) <= TRAIN_GRAD_FACTOR x (the CPU float32 gradient's own + TRAIN_GRAD_TOL);
# a TF32 backward exceeds it
TRAIN_GRAD_FACTOR = 4.0
TRAIN_GRAD_TOL = 1e-5
TRAIN_LOSS_RTOL = 1e-5  # card vs CPU float32 loss
TRAIN_TIMED_STEPS = 10  # after 3 warm-up steps
TRAIN_MODES = {  # name -> (compute dtype, remat)
    "float32": (torch.float32, False), "bf16": (torch.bfloat16, False),
    "float32_remat": (torch.float32, True), "bf16_remat": (torch.bfloat16, True),
}
TRAIN_CLI_STEPS = 20
TRAIN_SERVE_SIZE = 512  # side of the crops the float32 export segments


def _loss_and_grads(model, x, y, dtype, dev, flags):
    """The loss (float) and the gradients (float64 on the CPU, by parameter
    name) of one forward and backward of a copy of ``model`` on ``dev``
    computing in ``dtype``, forward and backward under ``flags``."""
    from ecseg_torch.runtime import train as tt

    m = copy.deepcopy(model).to(dev)
    with flags:
        loss = tt.softmax_xent_loss(m, x.to(dev), y.to(dev), dtype=dtype)
        loss.backward()
    return float(loss.detach()), {n: p.grad.double().cpu() for n, p in m.named_parameters()}


def _rel_max_errors(grads, ref):
    """Per parameter: max |grad - ref| / max |ref|."""
    return {n: float((g - ref[n]).abs().max() / ref[n].abs().max()) for n, g in grads.items()}


def _rel_p90_errors(grads, ref):
    """Per parameter: the 90th percentile of |grad - ref| over its
    elements, / max |ref|.  A ReLU or max-pool decision that flips at
    float32's rounding moves the slice of a weight gradient behind it by
    far more than rounding does (on the deep layers, up to ~5e-3 of max |g|
    from float64 on the CPU and on the card alike); the percentile skips
    those slices and keeps the dense error, where TF32's 10-bit products
    show on every element."""
    return {n: float(torch.quantile((g - ref[n]).abs().flatten(), 0.9) / ref[n].abs().max()) for n, g in grads.items()}


def phase_train(args, dev, results):
    """Training of the metaseg U-Net (``runtime/train.py``) at the default
    widths on 256^2 crops of the main path's four 2048^2 images and the
    ``labels/*.npy`` metaseg wrote for them.  Checks: a float32 loss and
    its gradients on 2 crops from the same weights, the card's loss within
    ``TRAIN_LOSS_RTOL`` of the CPU's, and each of its gradient tensors held
    to the CPU's float64 gradient: the 90th percentile of the element
    errors relative to max |g| (``_rel_p90_errors``) within
    ``TRAIN_GRAD_FACTOR`` times the CPU float32 gradient's, plus
    ``TRAIN_GRAD_TOL`` (at random weights a deep layer's gradient is a
    small remainder of large terms: float32 lands ~1e-4 from float64 there
    on any device, ~1e-8 at the head, so the bound follows each tensor's
    conditioning), and the same step with its backward under PyTorch's
    default flags (TF32 on) outside that bound;
    two float32 steps from one state bit-equal; remat equal to plain; four
    uninterrupted steps bit-equal to two, ``save_checkpoint`` /
    ``restore_checkpoint`` into fresh objects, two more; no hand kernel
    launched while training.  Then ``python3 -m
    ecseg_torch.pipelines.train_metaseg`` as a user runs it, in float32 and
    with ``--bf16 --remat``, both at once (exit code 0, two checkpoints, finite losses,
    ``models/metaseg.npz`` exported), and the float32 export served back on
    ``TRAIN_SERVE_SIZE``^2 crops of two of the images by
    ``python3 -m ecseg_torch.pipelines.metaseg`` (one CSV row an image) and
    by ``metaseg.main`` in-process on a copy (launch counters set to 0 just
    before, read just after: ``PER_IMAGE_LAUNCHES["default"]`` an image;
    labels equal to the host oracle on the raw canvas and byte-equal to the
    command line's).  Times (CUDA events over ``TRAIN_TIMED_STEPS`` steps
    after 3 warm-up steps, the batch on the card): ms a step, TFLOP/s from
    3 (4 with remat) forward FLOPs a patch, peak memory, for each of
    ``TRAIN_MODES``; the host's ``crop_batches`` and H2D copy a step."""
    from ecseg_torch.core import imgio
    from ecseg_torch.core.config import Config
    from ecseg_torch.models.metaseg_unet import MetasegUNet, flops_per_patch
    from ecseg_torch.models.layers import parity_flags
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import tiling
    from ecseg_torch.ops.meta_post import meta_inference
    from ecseg_torch.pipelines import metaseg
    from ecseg_torch.runtime import checkpoint as ckpt
    from ecseg_torch.runtime import train as tt
    from ecseg_torch.runtime.data import crop_batches, load_training_pairs

    root = os.path.dirname(os.path.abspath(__file__))
    card = results["card"]
    folder = results.pop("train_folder")
    work = tempfile.mkdtemp(prefix="ecseg_train_")
    phase_t0 = time.perf_counter()
    cwd = os.getcwd()
    cudnn_flags = {k: getattr(torch.backends.cudnn, k) for k in ("allow_tf32", "deterministic", "benchmark")}
    print(f"train: cuDNN's process-wide flags at the phase's start {cudnn_flags} [{card}]", flush=True)

    def pytorch_defaults():
        """PyTorch's default cuDNN flags, set explicitly.  The TF32 contrast
        and the timed steps run under them (float32 steps enter the parity
        flags inside ``train_step``).  This enters ``cudnn.flags`` directly,
        not through ``parity_flags``'s holder count: it runs on the main
        thread with no parity holder active (every fan-out has joined), so
        nothing else saves or restores the flags meanwhile."""
        return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=True)

    try:
        pairs = load_training_pairs(folder)
        check(len(pairs) == 4 and all(img.shape == (SIZE, SIZE) for img, _ in pairs), "training pairs of the main path's folder")
        batches = list(crop_batches(pairs, TRAIN_BATCH, 4, seed=args.seed))

        def fresh(seed=args.seed):
            model = MetasegUNet(generator=torch.Generator().manual_seed(seed)).to(dev)
            return model, tt.make_optimizer(model, TRAIN_LR)

        def steps(model, opt, bs, dtype=torch.float32, remat=False):
            for x, y in bs:
                loss = tt.train_step(model, opt, x, y, dtype=dtype, remat=remat)
            return loss

        def params_equal(a, b):
            return all(torch.equal(p, q) for p, q in zip(a.parameters(), b.parameters()))

        # card against CPU, float32, 2 crops, each held to the float64 gradient;
        # then the backward at PyTorch's defaults (TF32 on)
        x2, y2 = (torch.from_numpy(a[:2]) for a in batches[0])
        ref = MetasegUNet(generator=torch.Generator().manual_seed(args.seed))
        t0 = time.perf_counter()
        loss64, g64 = _loss_and_grads(ref, x2, y2, torch.float64, "cpu", contextlib.nullcontext())
        loss_cpu, g_cpu = _loss_and_grads(ref, x2, y2, torch.float32, "cpu", contextlib.nullcontext())
        cpu_s = time.perf_counter() - t0
        loss_card, g_card = _loss_and_grads(ref, x2, y2, torch.float32, dev, parity_flags())
        _, g_tf32 = _loss_and_grads(ref, x2, y2, torch.float32, dev, pytorch_defaults())
        loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
        err_cpu, err_card, err_tf32 = (_rel_p90_errors(g, g64) for g in (g_cpu, g_card, g_tf32))
        max_cpu, max_card, max_tf32 = (max(_rel_max_errors(g, g64).values()) for g in (g_cpu, g_card, g_tf32))
        bound = {n: TRAIN_GRAD_FACTOR * (e + TRAIN_GRAD_TOL) for n, e in err_cpu.items()}
        over = {n: err_card[n] / bound[n] for n in bound}
        over_tf32 = {n: err_tf32[n] / bound[n] for n in bound}
        card_vs_cpu = max(_rel_max_errors(g_card, g_cpu).values())
        print(f"train: card vs CPU float32 on 2 crops: loss {loss_card:.7f} vs {loss_cpu:.7f} (rel {loss_err:.3g}, float64 {loss64:.7f}); "
              f"gradients from float64, 90th percentile of |diff| / max |g|: CPU float32 up to {max(err_cpu.values()):.3g}, the card "
              f"{max(err_card.values()):.3g} (worst share of its bound {max(over.values()):.3f}), with a TF32 backward "
              f"{max(err_tf32.values()):.3g} (worst share {max(over_tf32.values()):.1f}, at {max(over_tf32, key=over_tf32.get)}; "
              f"{sum(v > 1 for v in over_tf32.values())} of {len(over_tf32)} tensors over); max |diff| / max |g|: CPU {max_cpu:.3g}, "
              f"card {max_card:.3g}, TF32 {max_tf32:.3g}, card vs CPU {card_vs_cpu:.3g}; CPU forward+backward (float64 and float32) "
              f"{cpu_s:.2f} s [{card}]", flush=True)
        check(loss_err <= TRAIN_LOSS_RTOL, f"card vs CPU loss rel {loss_err}")
        check(max(over.values()) <= 1.0, f"card float32 gradients outside their bound: {over}")
        check(max(over_tf32.values()) > 1.0, f"a TF32 backward stays within the bound: {over_tf32}")

        # determinism, remat, resume; no hand kernel launched
        K.reset_launches()
        a, oa = fresh()
        b, ob = fresh()
        steps(a, oa, batches[:1])
        steps(b, ob, batches[:1])
        check(params_equal(a, b), "two float32 steps from one state differ")
        r, orr = fresh()
        steps(r, orr, batches[:1], remat=True)
        remat_bit_equal = params_equal(a, r)
        remat_err = max(float((p - q).detach().abs().max()) for p, q in zip(r.parameters(), a.parameters()))
        check(all(torch.allclose(p, q, rtol=1e-6, atol=1e-7) for p, q in zip(r.parameters(), a.parameters())), "remat step != plain step")
        u, ou = fresh()
        steps(u, ou, batches)
        h, oh = fresh()
        steps(h, oh, batches[:2])
        path = ckpt.save_checkpoint(os.path.join(work, "ckpt"), 2, h, oh)
        check(ckpt.latest_checkpoint(os.path.join(work, "ckpt")) == path, "latest_checkpoint")
        g, og = fresh(args.seed + 1)
        check(ckpt.restore_checkpoint(path, g, og) == 2, "restored step")
        steps(g, og, batches[2:])
        check(params_equal(u, g), "four steps != two, save, restore into fresh objects, two more")
        train_launches = dict(K.LAUNCHES)
        check(not any(train_launches.values()), f"training launched hand kernels: {train_launches}")
        del a, oa, b, ob, r, orr, u, ou, h, oh, g, og
        print(f"train: two float32 steps bit-equal; remat {'bit-equal' if remat_bit_equal else 'within rtol 1e-6'} to plain; "
              f"resume through a checkpoint bit-equal to 4 uninterrupted steps; no hand kernel launched [{card}]", flush=True)

        # times a step, TFLOP/s, peak memory, per mode; the host's share
        x_dev, y_dev = (torch.from_numpy(t).to(dev) for t in batches[0])
        timing = {}
        for mode, (dtype, remat) in TRAIN_MODES.items():
            model, opt = fresh()
            with pytorch_defaults():
                for _ in range(3):
                    steps(model, opt, [(x_dev, y_dev)], dtype, remat)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev0.record()
                for _ in range(TRAIN_TIMED_STEPS):
                    loss = tt.train_step(model, opt, x_dev, y_dev, dtype=dtype, remat=remat)
                ev1.record()
                torch.cuda.synchronize()
            ms = ev0.elapsed_time(ev1) / TRAIN_TIMED_STEPS
            flops = (4 if remat else 3) * flops_per_patch() * TRAIN_BATCH
            timing[mode] = {"ms_per_step": ms, "tflops": flops / ms / 1e9, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                            "loss": float(loss)}
            check(np.isfinite(float(loss)), f"{mode}: loss {float(loss)}")
            del model, opt
        # the same steps with the input strided NCHW: the (N, 256, 256, 1) crops'
        # permuted view reads as channels-last, and cuDNN follows its first conv
        x_nchw = x_dev.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format).permute(0, 2, 3, 1)
        nchw_ms = {}
        for mode in ("float32", "bf16"):
            model, opt = fresh()
            dtype = TRAIN_MODES[mode][0]
            with pytorch_defaults():
                nchw_ms[mode] = cuda_ms(lambda: tt.train_step(model, opt, x_nchw, y_dev, dtype=dtype), TRAIN_TIMED_STEPS)
            del model, opt
        print(f"train with an NCHW-strided input: float32 {nchw_ms['float32']:.3f} ms, bf16 {nchw_ms['bf16']:.3f} ms a step "
              f"(channels-last view: {timing['float32']['ms_per_step']:.3f}, {timing['bf16']['ms_per_step']:.3f}) [{card}]", flush=True)
        t0 = time.perf_counter()
        host_batches = list(crop_batches(pairs, TRAIN_BATCH, TRAIN_TIMED_STEPS, seed=args.seed + 1))
        crop_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, y in host_batches:
            torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev)
        torch.cuda.synchronize()
        h2d_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_TIMED_STEPS
        for mode, row in timing.items():
            row["host_share"] = (crop_ms + h2d_ms) / (crop_ms + h2d_ms + row["ms_per_step"])
            print(f"train {mode:13s}: {row['ms_per_step']:.3f} ms a step of {TRAIN_BATCH} crops, {row['tflops']:.2f} TFLOP/s, "
                  f"peak {row['peak_mem_bytes'] / 2**30:.3f} GiB, host share {row['host_share']:.3f} [{card}]", flush=True)
        print(f"train host: crop_batches {crop_ms:.3f} ms a batch of {TRAIN_BATCH}, H2D copy {h2d_ms:.3f} ms a step [{card}]", flush=True)

        # the command lines as a user runs them, then the float32 export served back
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        # the two runs at once, as two users would share the card
        runs = {}
        try:
            t0 = time.perf_counter()
            for mode, extra in (("float32", []), ("bf16_remat", ["--bf16", "--remat"])):
                d = os.path.join(work, mode)
                os.makedirs(d)
                cmd = [sys.executable, "-m", "ecseg_torch.pipelines.train_metaseg", "--inpath", folder, "--steps", str(TRAIN_CLI_STEPS),
                       "--batch", str(TRAIN_BATCH), "--ckpt-every", "10"] + extra
                runs[mode] = (d, extra, subprocess.Popen(cmd, cwd=d, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            outputs = {mode: proc.communicate(timeout=300) + (proc.returncode,) for mode, (_, _, proc) in runs.items()}
            cli_s = time.perf_counter() - t0
        finally:
            for _, _, proc in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        cli = {"wall_s_both": cli_s}
        for mode, (d, extra, _) in runs.items():
            stdout, stderr, rc = outputs[mode]
            check(rc == 0, f"train_metaseg {extra} exited {rc}:\n{stdout[-2000:]}\n{stderr[-4000:]}")
            out = stdout.splitlines()
            losses = [float(ln.split()[-1]) for ln in out if ln.startswith("step ")]
            ckpts = sorted(os.listdir(os.path.join(d, "checkpoints", "metaseg")))
            check(out[0] == "4 training images" and len(losses) == 3 and all(np.isfinite(losses)), f"train_metaseg {extra} output: {out}")
            check(ckpts == ["step_00000010.pt", "step_00000020.pt"], f"train_metaseg {extra} checkpoints {ckpts}")
            check(out[-1] == "exported weights: models/metaseg.npz" and os.path.exists(os.path.join(d, "models", "metaseg.npz")), f"train_metaseg {extra}: no export")
            cli[mode] = {"losses": losses}
            print(f"train command line {mode}: {TRAIN_CLI_STEPS} steps, rc 0, losses {losses}, checkpoints {ckpts} [{card}]", flush=True)
        print(f"train command lines: both ran at once in {cli_s:.2f} s (process start included) [{card}]", flush=True)

        # served back on 512^2 crops of two training images: a 20-step model's
        # labels are noisy, and the host redo of a noisy 2048^2 map takes ~25 s
        serve = os.path.join(work, "float32")
        names = ["img0.tif", "img1.tif"]
        for sub in ("imgs", "inproc"):
            os.makedirs(os.path.join(serve, sub))
            for name in names:
                imgio.write_tiff(os.path.join(serve, sub, name), imgio.imread_rgb(os.path.join(folder, name))[:TRAIN_SERVE_SIZE, :TRAIN_SERVE_SIZE])
        with open(os.path.join(serve, "config.yaml"), "w") as f:
            f.write("metaseg:\n  inpath: ./imgs\n")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ecseg_torch.pipelines.metaseg"], cwd=serve, env=env, capture_output=True, text=True, timeout=600)
        serve_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"served back: metaseg exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        with open(os.path.join(serve, "imgs", "ec_quantification.csv")) as f:
            rows = f.read().splitlines()
        check(rows[0] == "image name,# of ec" and sorted(r.rsplit(",", 1)[0] for r in rows[1:]) == names, f"served back: CSV rows {rows}")
        os.chdir(serve)
        model = metaseg.load_model(device=dev)
        with post_form("default"):
            K.reset_launches()
            check(metaseg.main(config=Config(raw={"metaseg": {"inpath": os.path.join(serve, "inproc")}}), device="cuda") == 0, "served back: in-process main")
            served_launches = dict(K.LAUNCHES)
            for key, n in (PER_IMAGE_LAUNCHES["default"] | metaseg_forward_launches(len(tiling.patch_positions(TRAIN_SERVE_SIZE, TRAIN_SERVE_SIZE)))).items():
                check(served_launches[key] == n * len(names), f"served back: {key} launched {served_launches[key]} times, expected {n * len(names)}")
            for name in names:
                npy = os.path.join("labels", name[:-4] + ".npy")
                out = np.load(os.path.join(serve, "imgs", npy))
                patches, pos = metaseg._prepare_image(os.path.join(serve, "imgs", name), save_dapi=False)
                raw = metaseg.segment_raw(model, patches, pos)
                check(np.array_equal(out, meta_inference(raw.cpu().numpy().astype(np.int64))), f"served back: {name} labels != host oracle")
                check(read_bytes(os.path.join(serve, "imgs", npy)) == read_bytes(os.path.join(serve, "inproc", npy)), f"served back: {npy} != in-process")
        print(f"train served back: python -m ecseg_torch.pipelines.metaseg on the float32 export, {len(names)} images in {serve_s:.2f} s, "
              f"rc 0; labels equal the host oracle and the in-process run's bytes; launches {served_launches} [{card}]", flush=True)
        results["train"] = {
            "batch": TRAIN_BATCH, "cudnn_flags_at_start": cudnn_flags, "modes": timing, "nchw_input_ms": nchw_ms, "crop_batches_ms": crop_ms, "h2d_ms": h2d_ms,
            "card_vs_cpu": {"loss_rel": loss_err, "grad_max_rel": card_vs_cpu,
                            "grad_p90_rel_vs_float64": {"cpu": max(err_cpu.values()), "card": max(err_card.values()), "card_tf32_backward": max(err_tf32.values())},
                            "grad_max_rel_vs_float64": {"cpu": max_cpu, "card": max_card, "card_tf32_backward": max_tf32},
                            "tf32_tensors_over_bound": sum(v > 1 for v in over_tf32.values()),
                            "worst_share_of_bound": {"card": max(over.values()), "card_tf32_backward": max(over_tf32.values())}},
            "remat_bit_equal": remat_bit_equal, "remat_max_abs": remat_err, "command_line": cli, "served_back_s": serve_s,
            "phase_s": time.perf_counter() - phase_t0,
        }
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(folder, ignore_errors=True)


COMPARE_ARGS = ["--steps", "30", "--n-train", "2", "--n-eval", "1"]  # compare_archs' command line here
COMPARE_KEYS = ["arch", "steps", "batch", "train_s", "iou_bg", "iou_nucleus", "iou_chromosome", "iou_ec", "mean_iou", "pixel_acc"]
COMPARE_TIMEOUT_S = 150
COMPARE_FORWARD_TOL = 2e-5  # card vs CPU float32 probabilities (the main path's bound)


def phase_compare_archs(args, dev, results):
    """The JAX repo's two model scripts as the port runs them.  ``python3 -m
    ecseg_torch.compare_archs`` with ``COMPARE_ARGS`` (30 steps at both
    widths, two training fields, one held-out field) in an empty working
    directory: exit code 0; two JSON lines, ``default`` then ``xl``, with
    the script's keys in its order; every IoU and the accuracy in [0, 1];
    each width's losses finite, the last step's below the first's; XL's ms a
    step (its ``train_s`` over the steps, the first step included).
    ``python3 -m ecseg_torch.roofline_forward`` for both architectures, at
    the same time: exit code 0 and closing lines equal to the totals of
    ``roofline_forward.layers``.  In-process, ``compare_archs.evaluate`` on
    one 1024^2 field with the default-width demo weights (level 1 crafted,
    so the labels are decided by a margin; the deep layers seeded and run
    at full cost): the launch counters set to 0 just before and read just
    after, one B1 launch a field and the forward's ``FORWARD_LAUNCHES``, no
    other kernel; the labels equal with
    ``stitch_plain`` on the card; the CPU forward's probabilities within
    ``COMPARE_FORWARD_TOL`` of the card's, and the CPU's labels equal the
    card's wherever the CPU's top two quantized bytes differ by more than 1
    (the bound of the CPU tests' forward checks; the count of such
    near-ties is printed)."""
    from ecseg_torch import compare_archs, roofline_forward
    from ecseg_torch.models.demo import demo_metaseg_params
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import tiling

    card = results["card"]
    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    phase_t0 = time.perf_counter()
    out = {"args": COMPARE_ARGS}
    with tempfile.TemporaryDirectory() as work:
        roofs = {arch: subprocess.Popen([sys.executable, "-m", "ecseg_torch.roofline_forward", "--arch", arch], cwd=work, env=env,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for arch in compare_archs.ARCHS}
        rc, lines = run_streams([sys.executable, "-m", "ecseg_torch.compare_archs", *COMPARE_ARGS], COMPARE_TIMEOUT_S, cwd=work, env=env)
        out["command_s"] = time.perf_counter() - phase_t0
        check(rc == 0, f"python -m ecseg_torch.compare_archs exited {rc}:\n" + "\n".join(ln for _, ln in lines[-40:]))
        rows = [json.loads(ln) for tag, ln in lines if tag == "out"]
        check([r.get("arch") for r in rows] == ["default", "xl"], f"compare_archs printed {rows}")
        steps = int(COMPARE_ARGS[1])
        for r in rows:
            check(list(r) == COMPARE_KEYS, f"compare_archs keys {list(r)}")
            check(all(0 <= r[k] <= 1 for k in COMPARE_KEYS[4:]) and r["steps"] == steps, f"compare_archs row {r}")
            losses = {}
            for tag, ln in lines:
                if tag == "err" and ln.startswith(f"[{r['arch']}] step "):
                    losses[int(ln.split()[2])] = float(ln.split()[-1])
            check(set(losses) == {0, steps - 1} and all(np.isfinite(v) for v in losses.values()), f"{r['arch']} losses {losses}")
            check(losses[steps - 1] < losses[0], f"{r['arch']}: loss at step {steps - 1} {losses[steps - 1]} not below step 0's {losses[0]}")
            r["losses"] = losses
            r["ms_a_step"] = 1e3 * r["train_s"] / steps
        out["rows"] = rows
        print(f"python -m ecseg_torch.compare_archs {' '.join(COMPARE_ARGS)}: rc 0 in {out['command_s']:.1f} s; "
              + "; ".join(f"{r['arch']} mean IoU {r['mean_iou']} ec {r['iou_ec']} acc {r['pixel_acc']} loss {r['losses'][0]:.4f} -> "
                          f"{r['losses'][steps - 1]:.4f}, {r['ms_a_step']:.1f} ms a step (train_s / steps)" for r in rows) + f" [{card}]", flush=True)

        peak = PEAKS[H100]
        roof_out = {}
        for arch, proc in roofs.items():
            stdout, stderr = proc.communicate(timeout=COMPARE_TIMEOUT_S)
            check(proc.returncode == 0, f"python -m ecseg_torch.roofline_forward --arch {arch} exited {proc.returncode}: {stderr[-2000:]}")
            layer_rows = roofline_forward.layers(*compare_archs.ARCHS[arch])
            t = roofline_forward.totals(layer_rows, peak["bfloat16"], peak["hbm_bytes_per_s"])
            want = roofline_forward.total_lines(t)
            got = stdout.strip().splitlines()[-2:]
            check(got == want, f"roofline {arch}: closing lines {got} != {want}")
            roof_out[arch] = {k: round(v, 6) for k, v in t.items()}
        out["roofline"] = roof_out
        print(f"python -m ecseg_torch.roofline_forward: rc 0 for both; closing lines equal the sums of layers(): {roof_out}", flush=True)

    img, lab = compare_archs.synth_pair(np.random.default_rng(args.seed + 9), 1024)
    model = demo_metaseg_params(torch.Generator().manual_seed(args.seed)).to(dev)
    K.reset_launches()
    iou, acc = compare_archs.evaluate(model, [(img, lab)])
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    check(launches == {k: int(k == "stitch") + FORWARD_LAUNCHES.get(k, 0) for k in launches}, f"compare_archs.evaluate on one field launched {launches}")
    got = compare_archs.predict(model, img)
    plain = compare_archs.predict(model, img, stitch=K.stitch_plain)
    check(np.array_equal(got, plain), "compare_archs: B1's labels != stitch_plain's on the card")
    _, patches, positions = tiling.im2patches_overlap(img[..., None])
    cpu_model = copy.deepcopy(model).cpu()
    with torch.no_grad():
        p_card = model(torch.from_numpy(patches).to(dev), dtype=torch.float32).cpu()
        p_cpu = cpu_model(torch.from_numpy(patches), dtype=torch.float32)
    fwd_err = float((p_card - p_cpu).abs().max())
    check(bool(torch.isfinite(p_card).all()) and fwd_err < COMPARE_FORWARD_TOL, f"compare_archs: card vs CPU forward max |diff| {fwd_err}")
    q = tiling.quantize_u8(p_cpu).to(torch.int16)
    top2 = q.sort(dim=-1).values[..., -2:]
    close = K.stitch_plain(((top2[..., 1] - top2[..., 0]) <= 1).to(torch.uint8), positions).numpy().astype(bool)
    cpu_labels = K.stitch_plain(tiling.patch_labels(p_cpu), positions).numpy()  # compare_archs.predict on the CPU
    differ = cpu_labels != got
    check(not (differ & ~close).any(), f"compare_archs: {int((differ & ~close).sum())} labels differ card vs CPU where the CPU's bytes decide them")
    out["evaluate"] = {"iou": iou.tolist(), "pixel_acc": acc, "launches": launches, "forward_max_abs_card_vs_cpu": fwd_err,
                       "labels_differ_card_vs_cpu": int(differ.sum()), "near_ties": int(close.sum())}
    print(f"compare_archs.evaluate on one 1024^2 field: B1 launched {launches['stitch']}, H1 {launches['conv3x3']}, nothing else; labels equal stitch_plain's; "
          f"card vs CPU forward max |diff| {fwd_err:.3g}, {int(differ.sum())} labels differ (at {int(close.sum())} near-tie pixels); "
          f"IoU {np.round(iou, 4).tolist()} acc {acc:.4f} [{card}]", flush=True)
    del model, cpu_model, p_card, p_cpu
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"phase_compare_archs: {out['phase_s']:.1f} s", flush=True)
    results["compare_archs"] = out


STUDIES = {  # run -> (module, its arguments here, its environment, the kernels it must have launched)
    "profile_meta_post": ("profile_meta_post", ["2", "--size", "1024"], {},
                          {"label", "flood_border", "flood_seeds", "label_mc", "flood_mc"}),
    "profile_meta_post ECSEG_MC_MERGE=1": ("profile_meta_post", ["1", "--size", "1024"], {"ECSEG_MC_MERGE": "1"},
                                           {"label", "flood_border", "label_flood", "label_mc", "flood_mc"}),
    "profile_metaseg_2048": ("profile_metaseg_2048", ["--size", "1024", "--reps", "1"], {},
                             {"stitch", "label", "flood_border", "flood_seeds", "label_mc", "flood_mc"}),
    "profile_layers": ("profile_layers", ["--n", "2", "--reps", "10"], {}, {"conv3x3"}),
    "profile_nuclei_segment": ("profile_nuclei_segment", ["--size", "1024", "--reps", "1"], {}, {"label"}),
    "profile_fast_watershed": ("profile_fast_watershed", ["--reps", "1"], {}, {"flood_border"}),
    "quantify_watershed_divergence": ("quantify_watershed_divergence", ["2"], {}, {"flood_border"}),
}
STUDIES_TIMEOUT_S = 180  # each study's command line


def phase_studies(results):
    """The on-chip studies as a user runs them: ``python3 -m
    ecseg_torch.<study>`` for each of ``STUDIES`` (the six, and
    ``profile_meta_post`` again under ``ECSEG_MC_MERGE=1`` for B9), all at
    once (one process each, as ``torch.profiler`` needs), at small sizes,
    in an empty working directory.  Checks: exit code 0; the last line of each is its
    JSON line, naming this card and holding a row a block with its times;
    the kernels of ``STUDIES`` launched (``profile_layers`` H1 alone);
    ``quantify_watershed_divergence`` on 2 cases prints the same lines and
    numbers as its run on the CPU here (in-process, while the card runs)."""
    import io

    from ecseg_torch import quantify_watershed_divergence

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        procs = {
            run: subprocess.Popen([sys.executable, "-m", f"ecseg_torch.{module}", *args], cwd=work, env={**env, **extra},
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for run, (module, args, extra, _) in STUDIES.items()
        }
        cpu_out = io.StringIO()
        with contextlib.redirect_stdout(cpu_out):
            check(quantify_watershed_divergence.main(STUDIES["quantify_watershed_divergence"][1], device="cpu") == 0,
                  "quantify_watershed_divergence on the CPU")
        outs, ended = {}, {}
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=STUDIES_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for p in procs.values():
                    p.kill()
                    p.communicate()
                raise
            check(proc.returncode == 0, f"python3 -m ecseg_torch.{name} exit code {proc.returncode}: {err[-3000:]}")
            outs[name] = out
            ended[name] = round(time.perf_counter() - t0, 1)  # an upper bound: the runs are read in turn
    wall = time.perf_counter() - t0
    summary = {"wall_s": round(wall, 1)}
    for name, out in outs.items():
        line = json.loads(out.strip().splitlines()[-1])
        check(line["study"] == STUDIES[name][0] and line["card"] == results["card"], f"{name}'s JSON line names {line.get('card')}")
        check(line["rows"] and all(r["wall_ms"] is not None for r in line["rows"] if not r["name"].startswith("case ")),
              f"{name}: a row without its time")
        want = STUDIES[name][3]
        check(set(line["launches"]) >= want and (want or not line["launches"]),
              f"{name} launched {line['launches']}, expected {sorted(want)}")
        summary[name] = {"rows": len(line["rows"]), "launches": line["launches"], "ended_s": ended[name],
                         "device_not_measured": [r["name"] for r in line["rows"] if "device_not_measured" in r]}
    card_lines = [ln for ln in outs["quantify_watershed_divergence"].splitlines() if not ln.startswith("{") and ln != results["card"]]
    cpu_lines = [ln for ln in cpu_out.getvalue().splitlines() if not ln.startswith("{")]
    check(card_lines == cpu_lines, f"quantify_watershed_divergence: the card's lines {card_lines} differ from the CPU's {cpu_lines}")
    summary["quantify_summary"] = json.loads(outs["quantify_watershed_divergence"].strip().splitlines()[-1])["summary"]
    print(f"phase_studies: {wall:.1f} s, {len(STUDIES)} study runs at once; launches "
          f"{ {name: summary[name]['launches'] for name in STUDIES} }; quantify_watershed_divergence equal on the card and the CPU", flush=True)
    results["studies"] = summary


DEMO_TASKS = ("metaseg", "meta_overlay", "stat_fish", "interseg", "fish_distance")  # README's demo, in its order
DEMO_SWITCHES = {"ECSEG_STAT_FISH_TAIL_WORKERS": "3", "ECSEG_TIF_LZW": "1", "ECSEG_NO_NATIVE": "1"}
# the kernel launches of each demo task on its one image; stat_fish's demo
# RPN places no marker, so its watershed passes through and launches no B3
DEMO_LAUNCHES = {
    "metaseg": PER_IMAGE_LAUNCHES["default"],
    "meta_overlay": OVERLAY_LAUNCHES,
    "stat_fish": {key: STAT_FISH_LABELS_PER_IMAGE * (key == "label") for key in ALL_KERNELS} | NUSET_FORWARD_LAUNCHES,
    "interseg": {key: 0 for key in ALL_KERNELS},
    "fish_distance": {key: 0 for key in ALL_KERNELS},
}
B2_ONLY_KERNEL = "uf_resolve"  # B2's flattening pass; B5 runs it too, but not on stat_fish's path


def demo_files(work):
    """relative path -> bytes of every file under ``work``'s example folders."""
    out = {}
    for sub in ("example_ecSeg", "example_interSeg"):
        for dirpath, _, names in os.walk(os.path.join(work, sub)):
            for name in names:
                path = os.path.join(dirpath, name)
                out[os.path.relpath(path, work)] = read_bytes(path)
    return out


def demo_counts(work):
    """The rows README's demo promises, as the CPU test pins them
    (tests/test_torch_demo_weights.py): one metaseg and one meta_overlay
    row for input.tif; three nuclei, each with one green and three red
    foci, three ``EC-amp`` rows and three distances."""
    rows = lambda *p: open(os.path.join(work, *p)).read().splitlines()[1:]
    fish = [r.split(",") for r in rows("example_interSeg", "annotated", "stat_fish_lsq.csv")]
    return {
        "metaseg": rows("example_ecSeg", "ec_quantification.csv"),
        "meta_overlay": len(rows("example_ecSeg", "fish_quantification.csv")),
        "stat_fish": [(r[0], r[3], r[7]) for r in fish],
        "interseg": [r.split(",")[2:] for r in rows("example_interSeg", "interphase_prediction_red.csv")],
        "fish_distance": len(rows("example_interSeg", "centromere_distances.csv")),
    }


DEMO_COUNTS = {
    "metaseg": ["input.tif,1"], "meta_overlay": 1, "stat_fish": [("cells", "1", "3")] * 3,
    "interseg": [["EC-amp", "EC-amp"]] * 3, "fish_distance": 3,
}


def phase_demo(results):
    """README's end-to-end demo through the port, as a user runs it on the
    card: in an empty directory with a copy of the repository's
    ``config.yaml``, ``python3 -m ecseg_torch.make_demo_weights`` and then
    ``python3 -m ecseg_torch.pipelines.<task>`` for metaseg, meta_overlay,
    stat_fish (under ``ECSEG_TRACE=1 ECSEG_TRACE_DIR=<dir>``), interseg and
    fish_distance.  Checks: exit codes 0; the rows of ``DEMO_COUNTS``; one
    Chrome trace in the directory, with CUDA kernel events among which B2's
    ``uf_resolve``; stat_fish again on a fresh copy under
    ``DEMO_SWITCHES`` (three tail workers, LZW TIFFs, the Python min-cut
    and watershed): its CSV, ``.npy`` and copied YAML bytes equal the
    default run's, its TIFFs carry compression 5 (the default's 1) and
    decode to the same pixels; then the five tasks in-process on another
    copy (``main()`` reading ``./config.yaml``), each with every launch
    counter set to 0 just before and read just after (``DEMO_LAUNCHES``),
    every output file byte-equal to the command lines'."""
    from ecseg_torch.core import imgio
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.pipelines import fish_distance, interseg, meta_overlay, metaseg, stat_fish

    root = os.path.dirname(os.path.abspath(__file__))
    card = results["card"]
    work = tempfile.mkdtemp(prefix="ecseg_demo_")
    cwd = os.getcwd()
    env = {k: v for k, v in os.environ.items() if k not in ("ECSEG_TRACE", "ECSEG_TRACE_DIR", *DEMO_SWITCHES)}
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    walls = {}

    def run(name, args, where, extra=None):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", *args], cwd=where, env=dict(env, **(extra or {})), capture_output=True, text=True, timeout=600)
        walls[name] = time.perf_counter() - t0
        check(proc.returncode == 0, f"demo: python -m {' '.join(args)} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        print(f"demo: python -m {' '.join(args)}{' under ' + str(extra) if extra else ''}: rc 0 in {walls[name]:.2f} s [{card}]", flush=True)
        return proc

    try:
        shutil.copy(os.path.join(root, "config.yaml"), work)
        out = run("make_demo_weights", ["ecseg_torch.make_demo_weights"], work).stdout.splitlines()
        check(len(out) == 6 and all(ln.startswith("wrote ") for ln in out), f"make_demo_weights printed {out}")
        for sub in ("switches", "inproc"):  # fresh copies of the inputs and weights
            os.makedirs(os.path.join(work, sub))
            shutil.copy(os.path.join(work, "config.yaml"), os.path.join(work, sub))
            for d in ("example_ecSeg", "example_interSeg", "models", "interseg_models"):
                shutil.copytree(os.path.join(work, d), os.path.join(work, sub, d))
        trace_dir = os.path.join(work, "traces")
        for task in DEMO_TASKS:
            extra = {"ECSEG_TRACE": "1", "ECSEG_TRACE_DIR": trace_dir} if task == "stat_fish" else None
            proc = run(task, [f"ecseg_torch.pipelines.{task}"], work, extra)
            if task == "stat_fish":
                check("[ecseg trace]" in proc.stdout, "demo: stat_fish under ECSEG_TRACE=1 printed no stage table")
        counts = demo_counts(work)
        check(counts == DEMO_COUNTS, f"demo: rows {counts} != {DEMO_COUNTS}")

        traces = sorted(os.listdir(trace_dir))
        check(len(traces) == 1 and traces[0].startswith("ecseg_trace_"), f"demo: the trace directory holds {traces}")
        with open(os.path.join(trace_dir, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        check(any(B2_ONLY_KERNEL in k for k in kernels), f"demo: the stat_fish trace shows no B2 launch among {len(kernels)} kernel events")
        trace_info = {"file_bytes": os.path.getsize(os.path.join(trace_dir, traces[0])), "events": len(events), "kernel_events": len(kernels),
                      "b2_resolve_events": sum(B2_ONLY_KERNEL in k for k in kernels)}
        print(f"demo: stat_fish's Chrome trace {trace_info}", flush=True)

        sw = os.path.join(work, "switches")
        run("stat_fish_switches", ["ecseg_torch.pipelines.stat_fish"], sw, DEMO_SWITCHES)
        base, other = (os.path.join(d, "example_interSeg", "annotated") for d in (work, sw))
        names = sorted(os.path.relpath(os.path.join(dp, n), base) for dp, _, ns in os.walk(base) for n in ns)
        check(names == sorted(os.path.relpath(os.path.join(dp, n), other) for dp, _, ns in os.walk(other) for n in ns),
              "demo: stat_fish under the switches wrote other files")
        n_tif = 0
        for name in names:
            a, b = read_bytes(os.path.join(base, name)), read_bytes(os.path.join(other, name))
            if name.endswith(".tif"):
                comp = (imgio._tiff_header(a)[1][259], imgio._tiff_header(b)[1][259])
                check(comp == ((1,), (5,)), f"demo: {name} compression {comp}, expected 1 by default and 5 under ECSEG_TIF_LZW=1")
                check(np.array_equal(imgio.imread_rgb(os.path.join(base, name)), imgio.imread_rgb(os.path.join(other, name))),
                      f"demo: {name} pixels differ under the switches")
                n_tif += 1
            else:
                check(a == b, f"demo: {name} bytes differ under the switches")
        check(n_tif == 5, f"demo: {n_tif} TIFFs compared")
        print(f"demo: stat_fish under {DEMO_SWITCHES}: {len(names) - n_tif} CSV/.npy/YAML files byte-equal, {n_tif} LZW TIFFs decode to the default's pixels", flush=True)

        inproc = os.path.join(work, "inproc")
        os.chdir(inproc)
        launches, inproc_s = {}, {}
        mains = {"metaseg": metaseg.main, "meta_overlay": meta_overlay.main, "stat_fish": stat_fish.main, "interseg": interseg.main}
        for task in DEMO_TASKS:
            K.reset_launches()
            t0 = time.perf_counter()
            rc = fish_distance.main() if task == "fish_distance" else mains[task](device="cuda")
            torch.cuda.synchronize()
            inproc_s[task] = time.perf_counter() - t0
            launches[task] = dict(K.LAUNCHES)
            check(rc == 0, f"demo: in-process {task}.main returned {rc}")
            check(launches[task] == DEMO_LAUNCHES[task], f"demo: in-process {task} launched {launches[task]}, expected {DEMO_LAUNCHES[task]}")
        got, want = demo_files(inproc), demo_files(work)
        check(sorted(got) == sorted(want), f"demo: in-process files {sorted(set(got) ^ set(want))} differ from the command lines'")
        for name, data in want.items():
            check(got[name] == data, f"demo: in-process {name} bytes != the command line's")
        results["demo"] = {
            "command_s": walls, "inproc_s": inproc_s, "rows": counts, "trace": trace_info,
            "launches": {task: {k: v for k, v in ln.items() if v} for task, ln in launches.items()}, "files_compared": len(want),
        }
        print(f"demo: in-process runs {inproc_s}, launches {results['demo']['launches']}, {len(want)} files byte-equal to the command lines' [{card}]", flush=True)
    finally:
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
    # No single PyTorch call computes B2-B9 (library_ms null); B1's nearest
    # is a gather by the replayed source map (int64, cached outside the call)
    src64 = K._source_map(pos, dev).long()
    landed = int((src64 >= 0).sum())
    flat = lp.reshape(-1)
    library = {"stitch": lambda: torch.where(src64 >= 0, flat.take(src64.clamp(min=0)), 0)}
    check(torch.equal(library["stitch"]().int(), raw), "B1's library gather != the stitch on the main path's input")
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
            "bound_by": "bytes", "library_ms": cuda_ms(library[key], 20) if key in library else None,
        })
        if key in library:
            rows[-1]["library_call"] = "torch.where(src >= 0, flat.take(src.clamp(min=0)), 0)"
            rows[-1]["library_kernels"] = device_kernels(library[key])
        if key in REDESIGNED:
            rows[-1]["redesigned"] = REDESIGNED[key]
        lib = f", library {rows[-1]['library_ms']:.4f} ms ({len(rows[-1]['library_kernels'])} kernels)" if key in library else ""
        print(f"{b} {name} at main-path shapes: kernel {ms:.4f} ms (device {dev_ms:.4f} ms), plain {plain_ms:.3f} ms, bound {rows[-1]['bound_ms']:.4f} ms{lib}", flush=True)
    rows.append(banded_row(K, dev, errors, results))
    return rows


def banded_row(K, dev, errors, results):
    """B7's row.  The JAX package's banded labeler and flood carry B2's and
    B4's contracts on maps too large for its fast memory; the port's B2 and
    B4 kernels take any size, so they serve it (bit-equal at 2048x3072 in
    phase 2).  Timed as B2 on a 2048x3072 random mask; its launches are
    those of the B2 and B4 wrappers in the default form's run."""
    h, w = BANDED_SHAPE
    m = torch.rand((h, w), generator=torch.Generator(device=dev).manual_seed(7), device=dev) < 0.5
    kern, plain = (lambda: K.label(m, 2)), (lambda: K.label_plain(m, 2))
    errors.compare("label", kern(), plain(), f"random {h}x{w} (the banded contract's map)")
    launches = results["launches"]["default"]
    row = {
        "name": "label_banded", "b": "B7", "route": "cuda", "source": KERNELS["label"][2],
        "replaces": "ecseg_tpu/ops/cc_pallas_banded.py:230", "pallas_function": "label_banded/flood_banded",
        "served_by": "label (B2) and flood_from_seeds (B4), which take any map size",
        "launches": launches["label"] + launches["flood_seeds"], "launches_form": "default",
        "max_abs_err": max(errors.max["label"], errors.max["flood_seeds"]),
        "ms": cuda_ms(kern, 20), "device_ms": device_ms(kern, 20), "plain_ms": cuda_ms(plain, 1),
        "bound_ms": 1e3 * 5 * h * w / HBM_BYTES_PER_S, "bound_by": "bytes", "library_ms": None,
        "input": f"random p = 0.5 mask, {h}x{w}, connectivity 2 (B2)",
    }
    row["matches_plain"] = row["max_abs_err"] == 0
    print(f"B7 label_banded (served by B2) at {h}x{w}: kernel {row['ms']:.4f} ms (device {row['device_ms']:.4f} ms), "
          f"plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms, launches {row['launches']}", flush=True)
    return row


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
    """B8a on the stress masks; B8b on random class labels (the second half
    of each batch sparse) on 1, 2 and 32 tiles of the 1024^2 plan in one
    launch and one 2048^2 tile, every class at both connectivities, uint8
    and int32 labels, against its twin and (one and two tiles) against
    ``stitch_plain`` + ``==`` + the B8a twin (at class 0 the pixels no copy
    writes are background, as in the Pallas kernel); then on the tile-edge
    masks as class 3 over random classes 0-2, nine 1024^2 canvases in one
    launch."""
    for h, w in COUNT_SIZES:
        for name, m in [("random", rng.random((h, w)) < 0.5), ("snake", snake(h, w)), ("spiral", spiral(h, w))]:
            mt = torch.from_numpy(m).to(dev)
            for conn in (1, 2):
                errors.compare("count", K.count_components(mt, conn), K.count_components_plain(mt, conn), f"{name} {h}x{w} conn {conn}")
            print(f"B8a count {name} {h}x{w}: matches plain; conn 2 {cuda_ms(lambda: K.count_components(mt, 2), 5):.3f} ms", flush=True)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _masks import tile_masks

    for h, w, t in COUNT_PLANS:
        pos = tuple(map(tuple, tiling.patch_positions(h, w)))
        lp_np = rng.integers(0, 4, (t, len(pos), 256, 256)).astype(np.uint8)
        sparse = lp_np[t - t // 2 :]  # a view: the second half of the batch
        sparse[rng.random(sparse.shape) < 0.97] = 0
        lp = torch.from_numpy(lp_np).to(dev)
        lp32 = lp.int()
        written = K.stitch_plain(torch.ones_like(lp[0]), pos) != 0
        for cls in range(4):
            for conn in (1, 2):
                what = f"{h}x{w} ({t} x {len(pos)} patches) class {cls} conn {conn}"
                want = K.count_from_patches_plain(lp, pos, cls, conn)
                got = K.count_from_patches(lp, pos, cls, conn)
                errors.compare("count_patches", got, want, what)
                errors.compare("count_patches", K.count_from_patches(lp32, pos, cls, conn), want, what + " int32 labels")
                for i in range(t if t <= 2 else 0):
                    mask = K.stitch_plain(lp[i], pos) == cls
                    if cls == 0:
                        mask &= written
                    errors.compare("count_patches", (got[0][i], got[1][i]), K.count_components_plain(mask, conn), what + " (stitch_plain + ==)")
        print(
            f"B8b stitch+count {h}x{w}, {t} tile(s): matches plain for class 0-3, connectivity 1 and 2, uint8 and int32; "
            f"{cuda_ms(lambda: K.count_from_patches(lp, pos, 3), 5):.4f} ms", flush=True,
        )
    h = w = 1024
    pos = tuple(map(tuple, tiling.patch_positions(h, w)))
    imgs = [np.where(m, 3, rng.integers(0, 3, (h, w))).astype(np.uint8) for m in tile_masks(h, w).values()]
    lp = torch.from_numpy(np.stack([np.stack([img[y : y + 256, x : x + 256] for (y, x) in pos]) for img in imgs])).to(dev)
    for cls in (3, 0):
        for conn in (1, 2):
            what = f"tile-edge masks as class 3 on {len(imgs)} 1024^2 canvases, class {cls} conn {conn}"
            want = K.count_from_patches_plain(lp, pos, cls, conn)
            errors.compare("count_patches", K.count_from_patches(lp, pos, cls, conn), want, what)
            errors.compare("count_patches", K.count_from_patches(lp.int(), pos, cls, conn), want, what + " int32 labels")
    print(f"B8b stitch+count on the tile-edge masks ({', '.join(tile_masks(1, 1))}) at 1024^2: matches plain", flush=True)


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
    from ecseg_torch.models.layers import TFConvTranspose2d, parity_flags
    from ecseg_torch.ops import tiling
    from ecseg_torch.ops.convt import conv2d_transpose_packed, conv2d_transpose_packed_plain
    from ecseg_torch.ops.fused_tail import fused_dec1_head, fused_dec1_head_plain
    from ecseg_torch.pipelines import tile_count as tc

    inputs = results.pop("tile_inputs")
    model, labels, positions, x_cat = inputs["default"]
    launches = results["tile_launches"]
    rows = []
    ec = results.pop("ec_mask")
    fish2_nc = results.pop("overlay_fish2_nc")
    # the overlay's own B8a input, beside the row's
    errors.compare("count", K.count_components(fish2_nc, 2), K.count_components_plain(fish2_nc, 2), "the overlay's fish2_nc mask")
    fish2_ms = cuda_ms(lambda: K.count_components(fish2_nc, 2), 20)
    fish2_dev_ms, fish2_kernel_ms = device_ms(lambda: K.count_components(fish2_nc, 2), 20, kernel=KERNEL_NAMES["count"], event_ms=fish2_ms)
    rows.append(_timed_row(
        "count", lambda: K.count_components(ec, 2), lambda: K.count_components_plain(ec, 2), ec.numel() + 8, 0, None,
        results["overlay_launches"]["count"], 20, errors, path="meta_overlay",
        input="metaseg image 0's ecDNA mask (2048^2); launches from meta_overlay.main on 3 RGB images",
        redesigned=REDESIGNED["count"],
        fish2_nc={"input": "the overlay's image-0 fish2_nc mask (2048^2)", "ms": fish2_ms, "device_ms": fish2_dev_ms,
                  "kernel_device_ms": fish2_kernel_ms, "px": int(fish2_nc.sum())},
    ))
    print(f"B8a on the overlay's fish2_nc mask: {fish2_ms:.4f} ms (device {fish2_dev_ms:.4f} ms)", flush=True)
    t = labels.shape[0]
    landed = int((K._source_map(positions, dev) >= 0).sum())
    rows.append(_timed_row(
        "count_patches", lambda: K.count_from_patches(labels, positions, 3), lambda: K.count_from_patches_plain(labels, positions, 3),
        t * landed + 8 * t, 0, None, launches["default unfused"]["count_patches"], 20, errors,
        path="tile_count default unfused", input=f"{t} tiles x 25 patch labels (uint8) of the default path",
        redesigned=REDESIGNED["count_patches"],
    ))
    def tail_cost(x, w):
        n, c1, c2 = x.shape[0], x.shape[3], w[0].shape[3]
        flops = 2 * 256 * 256 * (9 * c1 * c2 + 9 * c2 * c2 + 4 * c2) * n
        return x.numel() * x.element_size() + 4 * n * 256 * 256 + sum(a.numel() * a.element_size() for a in w), flops

    def chain(model, x):  # the unfused cuDNN chain B10 replaces, in bf16
        L = model.layers
        with parity_flags():
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


def conv3x3_forward_check(model, paths):
    """H1 on the main path: ``segment_folder`` over the main path's images
    with the forward's 3x3 convs on the kernel (the default) and on cuDNN
    (``MetasegUNet._kernel_route`` off): a launch per 3x3 conv a forward
    (18 at four levels), no fallback, label pixels within ``CONV3X3_LABEL_PX`` of cuDNN's and
    ecDNA counts equal; the same bytes on a second kernel run."""
    from ecseg_torch.models.metaseg_unet import MetasegUNet
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.pipelines import metaseg
    from ecseg_torch.runtime import fallbacks

    def run():
        K.reset_launches()
        with torch.no_grad():
            out = {os.path.basename(p): (np.asarray(lab), num) for p, lab, num in metaseg.segment_folder(model, paths)}
        return out, K.LAUNCHES["conv3x3"]

    fallbacks.reset()
    kern, launches = run()
    again, _ = run()
    check(fallbacks.counts().get(fallbacks.CONV3X3_CUDNN, 0) == 0, f"H1: 3x3 convs left to cuDNN on the main path: {fallbacks.summary()}")
    route = MetasegUNet._kernel_route
    MetasegUNet._kernel_route = lambda self, x, dtype: False
    try:
        cudnn, cudnn_launches = run()
    finally:
        MetasegUNet._kernel_route = route
    per = sum(1 for layer in model.layers.values() if layer.kernel_size == (3, 3) and layer.stride == (1, 1))  # 18 at 4 levels
    check(launches == per * len(paths) and cudnn_launches == 0, f"H1: {launches} launches over {len(paths)} forwards of {per} 3x3 convs (cuDNN run {cudnn_launches})")
    px = sum(int((kern[n][0] != cudnn[n][0]).sum()) for n in kern)
    counts = {n: (kern[n][1], cudnn[n][1]) for n in kern}
    check(px <= CONV3X3_LABEL_PX, f"H1: {px} label pixels differ from the cuDNN forward's")
    check(all(a == b for a, b in counts.values()), f"H1: ecDNA counts {counts}")
    check(all(np.array_equal(kern[n][0], again[n][0]) for n in kern), "H1: a second run's labels differ")
    out = {"images": len(paths), "launches": launches, "label_px_differ": px, "ec_counts": counts}
    print(f"H1 on the main path: {out}", flush=True)
    return out


def nuset_conv3x3_check(model, pre, pre_small):
    """H1 in stat_fish: image 0's two NuSeT passes (the whole-image mask,
    then the foreground pass's mask and proposals; ``pre`` from
    ``nuclei_segment_prepare``) with the convs on the kernel (the default)
    and on cuDNN (``NuSeTUNet._kernel_route`` off):
    ``NUSET_FORWARD_LAUNCHES`` and no fallback, both masks within
    ``NUSET_CONV3X3_MASK_PX`` pixels of cuDNN's, as many proposals, the same
    bytes on a second kernel run; then the first pass on ``pre_small``, on
    the card (half of ``NUSET_FORWARD_LAUNCHES``) and in a CPU copy of the
    U-Net (none), masks within the same limit.  The demo NuSeT's logits
    read level 1 alone, so a U-Net of seeded Glorot weights, whose decoder
    reaches the logits, holds a whole pass on ``pre``'s input against the
    cuDNN pass (:func:`nuset_glorot_pass_check`), and H1 is held against its
    twin and cuDNN at NuSeT's own shapes (:func:`nuset_conv3x3_rows`)."""
    from ecseg_torch.models import nuset
    from ecseg_torch.models import nuset_infer as ni
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops.normalization import foreground_norm
    from ecseg_torch.runtime import fallbacks

    def run():
        K.reset_launches()
        whole = ni.nuset_forward(model, pre[1], pass_two=False)
        fg, props, _ = ni.mask_and_proposals(model, foreground_norm(pre[0], whole))
        return (whole, fg), len(props), K.LAUNCHES["conv3x3"]

    fallbacks.reset()
    kern, kern_props, launches = run()
    again, _, _ = run()
    check(fallbacks.counts().get(fallbacks.CONV3X3_CUDNN, 0) == 0, f"NuSeT: 3x3 convs left to cuDNN: {fallbacks.summary()}")
    route = nuset.NuSeTUNet._kernel_route
    nuset.NuSeTUNet._kernel_route = lambda self, x, dtype: False
    try:
        cudnn, cudnn_props, cudnn_launches = run()
    finally:
        nuset.NuSeTUNet._kernel_route = route
    check(launches == NUSET_FORWARD_LAUNCHES["conv3x3"] and cudnn_launches == 0, f"NuSeT: H1 launched {launches} times over an image's two passes (cuDNN run {cudnn_launches})")
    px = [int((a != b).sum()) for a, b in zip(kern, cudnn)]
    check(sum(px) <= NUSET_CONV3X3_MASK_PX, f"NuSeT: {px} mask pixels of the two passes differ from the cuDNN passes'")
    check(kern_props == cudnn_props > 0, f"NuSeT: {kern_props} proposals on H1, {cudnn_props} on cuDNN")
    check(all(np.array_equal(a, b) for a, b in zip(kern, again)), "NuSeT: a second run's masks differ")
    K.reset_launches()
    card_small = ni.unet_pass(model.unet_whole, pre_small[1], model.device)[0]
    card_launches = K.LAUNCHES["conv3x3"]
    K.reset_launches()
    cpu_small = ni.unet_pass(copy.deepcopy(model.unet_whole).cpu(), pre_small[1], "cpu")[0]
    cpu_launches = K.LAUNCHES["conv3x3"]
    px_cpu = int((card_small != cpu_small).sum())
    check(card_launches == NUSET_FORWARD_LAUNCHES["conv3x3"] // 2 and cpu_launches == 0,
          f"NuSeT pass on {pre_small[1].shape}: H1 launched {card_launches} times on the card, {cpu_launches} on the CPU")
    check(px_cpu <= NUSET_CONV3X3_MASK_PX, f"NuSeT pass on {pre_small[1].shape}: {px_cpu} mask pixels differ between the card and the CPU")
    out = {"launches": launches, "mask_px_differ": px, "proposals": [kern_props, cudnn_props],
           "small": {"shape": list(pre_small[1].shape), "card_launches": card_launches, "cpu_launches": cpu_launches, "mask_px_differ": px_cpu}}
    print(f"H1 in NuSeT on image 0: {out}", flush=True)
    out["glorot_pass"] = nuset_glorot_pass_check(pre[1], model.device)
    out["rows"] = nuset_conv3x3_rows(model.device)
    return out


def nuset_glorot_pass_check(image_norm, dev):
    """A whole NuSeT U-Net pass of seeded Glorot weights on ``image_norm``
    (stat_fish's 608^2 input), on H1 against the cuDNN pass (the route off,
    TF32 off): ``NUSET_FORWARD_LAUNCHES`` / 2 launches, the logits and the
    RPN feature within ``NUSET_PASS_REL`` of each one's largest value, the
    mask within ``NUSET_CONV3X3_MASK_PX`` pixels."""
    from ecseg_torch.models import nuset
    from ecseg_torch.models import nuset_infer as ni
    from ecseg_torch.ops import cc_kernels as K

    unet = nuset.NuSeTUNet(torch.Generator().manual_seed(NUSET_GLOROT_SEED)).to(dev).eval()
    x = ni._unet_input(image_norm, dev)
    K.reset_launches()
    with torch.no_grad():
        got = unet(x)
    launches = K.LAUNCHES["conv3x3"]
    route = nuset.NuSeTUNet._kernel_route
    nuset.NuSeTUNet._kernel_route = lambda self, x, dtype: False
    try:
        with torch.no_grad():
            want = unet(x)
    finally:
        nuset.NuSeTUNet._kernel_route = route
    rel = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)]
    px = int((nuset.pred_mask(got[0]) != nuset.pred_mask(want[0])).sum())
    out = {"launches": launches, "logits_rel": rel[0], "feature_rel": rel[1], "logits_scale": float(want[0].abs().max()),
           "mask_px_differ": px}
    print(f"H1 on a Glorot NuSeT pass at {tuple(x.shape)}: {out}", flush=True)
    check(launches == NUSET_FORWARD_LAUNCHES["conv3x3"] // 2, f"Glorot NuSeT pass: H1 launched {launches} times")
    check(max(rel) <= NUSET_PASS_REL, f"Glorot NuSeT pass: logits and feature {rel} of scale from the cuDNN pass's")
    check(px <= NUSET_CONV3X3_MASK_PX, f"Glorot NuSeT pass: {px} mask pixels differ from the cuDNN pass's")
    return out


def nuset_conv3x3_rows(dev):
    """H1 at NuSeT's own shapes, one 608^2 image's planes with their partial
    8 x 16 tiles (``NUSET_CONV3X3_SHAPES``), and two of its transpose convs
    as 3x3 convs of the zero-spread input (``NUSET_CONVT_SHAPES``, through
    ``layers.kernel_conv_transpose3x3``): bit-equal to the twin on integer
    inputs, within 1e-5 of cuDNN's largest output on normal ones (the
    transpose convs against ``forward_bias_after``, then the ReLU where
    the layer has one), the same bytes on a second call; ms beside cuDNN's."""
    from ecseg_torch.models import layers
    from ecseg_torch.ops import conv3x3

    cl = torch.channels_last
    rows = []

    def compare(tag, kern, twin, library, operands):
        integer_inputs = operands(True)
        check(torch.equal(kern(*integer_inputs), twin(*integer_inputs)), f"H1 {tag}: != its twin on integer inputs")
        del integer_inputs
        normal_inputs = operands(False)
        got, want = kern(*normal_inputs), library(*normal_inputs)
        rel = float((got - want).abs().max() / want.abs().max())
        check(rel < 1e-5, f"H1 {tag}: max relative error {rel:.3g} against cuDNN")
        check(torch.equal(kern(*normal_inputs), got), f"H1 {tag}: a second call's bytes differ")
        ms, library_ms = cuda_ms(lambda: kern(*normal_inputs), 5), cuda_ms(lambda: library(*normal_inputs), 5)
        return {"max_rel_err_cudnn": rel, "ms": ms, "library_ms": library_ms}

    for tag, (h, w, ca, cb, cout) in NUSET_CONV3X3_SHAPES.items():
        cin = ca + cb
        g = torch.Generator(device=dev).manual_seed(h * cin + cout)

        def operands(integer):
            if integer:
                x = torch.randint(-2, 3, (1, cin, h, w), device=dev, generator=g).float()
                k = torch.randint(-2, 3, (cout, cin, 3, 3), device=dev, generator=g).float()
            else:
                x = torch.randn((1, cin, h, w), device=dev, generator=g)
                k = torch.randn((cout, cin, 3, 3), device=dev, generator=g) / (3 * cin**0.5)
            b = torch.randint(-20, 21, (cout,), device=dev, generator=g).float()
            return x.contiguous(memory_format=cl), k, b

        def kern(x, k, b, fn=conv3x3.conv3x3_relu):
            return fn(x[:, :ca].contiguous(memory_format=cl), k, b, x[:, ca:].contiguous(memory_format=cl) if cb else None)

        def library(x, k, b):  # cuDNN under the parity flags, the bias after the float32 conv
            with layers.parity_flags():
                return torch.relu(layers.conv_same(x.contiguous(), k, b))

        row = compare(tag, kern, lambda x, k, b: kern(x, k, b, conv3x3.conv3x3_relu_plain), library, operands)
        row.update(input=f"{tag} {(1, h, w, ca, cb, cout)}", tflops=2 * 9 * h * w * cin * cout / row["ms"] / 1e9)
        rows.append(row)
    for tag, (h, w, cin, cout, relu) in NUSET_CONVT_SHAPES.items():
        layer = layers.TFConvTranspose2d(cin, cout).to(dev)
        g = torch.Generator(device=dev).manual_seed(h * cin + cout)

        def operands(integer):
            with torch.no_grad():
                if integer:
                    layer.weight.copy_(torch.randint(-2, 3, layer.weight.shape, device=dev, generator=g).float())
                    x = torch.randint(-2, 3, (1, cin, h, w), device=dev, generator=g).float()
                else:
                    layer.weight.copy_(torch.randn(layer.weight.shape, device=dev, generator=g) / (3 * cin**0.5))
                    x = torch.randn((1, cin, h, w), device=dev, generator=g)
                layer.bias.copy_(torch.randint(-20, 21, (cout,), device=dev, generator=g).float())
            return (x.contiguous(memory_format=cl),)

        def kern(x):
            with torch.no_grad():
                return layers.kernel_conv_transpose3x3(layer, x, relu)

        def twin(x):
            real = conv3x3.conv3x3_relu
            conv3x3.conv3x3_relu = conv3x3.conv3x3_relu_plain
            try:
                return kern(x)
            finally:
                conv3x3.conv3x3_relu = real

        def library(x):
            with torch.no_grad(), layers.parity_flags():
                y = layer.forward_bias_after(x)
            return torch.relu(y) if relu else y

        row = compare(tag, kern, twin, library, operands)
        row.update(input=f"{tag} {(1, h, w, cin, cout)} relu={relu}", tflops=2 * 9 * 4 * h * w * cin * cout / row["ms"] / 1e9)
        rows.append(row)
    for row in rows:
        print(f"H1 at NuSeT's {row['input']}: {row['ms']:.3f} ms ({row['tflops']:.1f} TFLOP/s of the kernel's products), "
              f"cuDNN {row['library_ms']:.3f} ms, max rel err {row['max_rel_err_cudnn']:.3g}", flush=True)
    return rows


def conv3x3_rows(dev, results):
    """H1's timing rows at ``CONV3X3_SHAPES``: bit-equal to its twin on
    integer-valued inputs (every sum exact; cuDNN's FFT tiling is not), the
    max relative error against cuDNN (``parity_flags``) on normal inputs, the same bytes
    on a second call and over 50 + 50 patches, then ms, device ms, bound,
    the twin's ms and cuDNN's (``library_ms``)."""
    from ecseg_torch.models.layers import parity_flags
    from ecseg_torch.ops import conv3x3

    rows = []
    for level, (n, h, w, ca, cb, cout) in CONV3X3_SHAPES.items():
        cin = ca + cb
        g = torch.Generator(device=dev).manual_seed(n * h + cin)
        xi = torch.randint(-2, 3, (n, cin, h, w), device=dev, generator=g).float().contiguous(memory_format=torch.channels_last)
        ki = torch.randint(-2, 3, (cout, cin, 3, 3), device=dev, generator=g).float()
        b = torch.randint(-20, 21, (cout,), device=dev, generator=g).float()

        def halves(x):
            return (x[:, :ca].contiguous(memory_format=torch.channels_last),
                    x[:, ca:].contiguous(memory_format=torch.channels_last) if cb else None)

        def kern(x, k):
            xa, xb = halves(x)
            return conv3x3.conv3x3_relu(xa, k, b, xb)

        def library(x, k):  # as the forward ran before H1: NCHW, cuDNN's fused bias, then the ReLU
            with parity_flags():
                return torch.relu(torch.nn.functional.conv2d(x.contiguous(), k, b, padding=1))

        def plain(x, k):
            xa, xb = halves(x)
            return conv3x3.conv3x3_relu_plain(xa, k, b, xb)

        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        want = plain(xi, ki)  # the twin's one call: its ms (each costs seconds)
        z.record()
        torch.cuda.synchronize()
        plain_ms = a.elapsed_time(z)
        check(torch.equal(kern(xi, ki), want), f"H1 {level}: != its twin on integer inputs")
        del want
        x = torch.randn((n, cin, h, w), device=dev, generator=g).contiguous(memory_format=torch.channels_last)
        k = torch.randn((cout, cin, 3, 3), device=dev, generator=g) / (3 * cin**0.5)
        xa, xb = halves(x)
        got, want = kern(x, k), library(x, k)
        rel = float((got - want).abs().max() / want.abs().max())
        check(rel < 1e-5, f"H1 {level}: max relative error {rel:.3g} against cuDNN")
        check(torch.equal(kern(x, k), got), f"H1 {level}: a second call's bytes differ")
        split = torch.cat([conv3x3.conv3x3_relu(xa[:50], k, b, None if xb is None else xb[:50]),
                           conv3x3.conv3x3_relu(xa[50:], k, b, None if xb is None else xb[50:])])
        check(torch.equal(split, got), f"H1 {level}: 50 + 50 patches differ from 100")
        del got, want, split
        ms = cuda_ms(lambda: conv3x3.conv3x3_relu(xa, k, b, xb), 5)
        dev_ms, kernel_ms = device_ms(lambda: conv3x3.conv3x3_relu(xa, k, b, xb), 5, kernel="conv3x3_f32", event_ms=ms)
        xn = x.contiguous()
        library_ms = cuda_ms(lambda: library(xn, k), 3)
        flops = 2 * 9 * n * h * w * cin * cout
        nbytes = 4 * (n * h * w * (cin + cout) + 9 * cin * cout + cout)
        by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
        row = {
            "name": "conv3x3_relu", "b": "H1", "route": "cuda", "source": "ecseg_torch/csrc/conv3x3_f32.cu",
            "replaces": None, "pallas_function": None, "path": "metaseg float32 forward (18 launches a 100-patch model call)",
            "input": f"{level} {(n, h, w, ca, cb, cout)} float32, channels-last",
            "launches": results["launches"]["default"]["conv3x3"], "launches_form": "default",
            "max_rel_err_cudnn": rel, "ms": ms, "device_ms": dev_ms, "kernel_device_ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "library_ms": library_ms, "tflops": flops / ms / 1e9,
        }
        row["bound_share"] = row["bound_ms"] / ms
        rows.append(row)
        print(f"H1 conv3x3_relu {level}: kernel {ms:.3f} ms (device {dev_ms}), {row['tflops']:.1f} TFLOP/s, "
              f"bound {row['bound_ms']:.3f} ms ({100 * row['bound_share']:.1f} %), plain {plain_ms:.1f} ms, "
              f"cuDNN (parity flags) {library_ms:.3f} ms, max rel err {rel:.3g}", flush=True)
        del x, xn, k, xa, xb, xi, ki
        torch.cuda.empty_cache()
    rows[0]["main_path"] = results.get("conv3x3_forward")
    return rows


@contextlib.contextmanager
def plain_twins():
    """Run the bench's full program and the post it calls through the
    kernels' plain twins: each wrapper name that ``ecseg_torch.bench``,
    ``meta_post_gpu`` or ``morphology_gpu`` calls is bound to its twin, and
    restored after."""
    from ecseg_torch import bench
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import meta_post_gpu, morphology_gpu

    saved = []
    try:
        for _, fname, *_ in KERNELS.values():
            plain = getattr(K, PLAIN_TWINS.get(fname, fname + "_plain"))
            for m in (bench, meta_post_gpu, morphology_gpu):
                if getattr(m, fname, None) is getattr(K, fname):
                    saved.append((m, fname))
                    setattr(m, fname, plain)
        check(saved, "no module of the full program calls a wrapper")
        yield
    finally:
        for m, fname in saved:
            setattr(m, fname, getattr(K, fname))


def run_streams(cmd, timeout, **kw):
    """Run ``cmd`` to its end; (exit code, [(stream, line), ...] in the order
    the lines arrived, stream "out" or "err").  Killed at ``timeout``."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)
    lines, lock = [], threading.Lock()

    def pump(f, tag):
        for ln in f:
            with lock:
                lines.append((tag, ln.rstrip("\n")))

    pumps = [threading.Thread(target=pump, args=(f, tag)) for f, tag in ((proc.stdout, "out"), (proc.stderr, "err"))]
    for t in pumps:
        t.start()
    try:
        rc = proc.wait(timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    finally:
        for t in pumps:
            t.join()
    return rc, lines


def phase_bench(dev, results):
    """``make bench`` as the port runs it, then its programs in-process.

    ``python3 -m ecseg_torch.bench`` with its default flags as a subprocess:
    exit code 0; three JSON lines (the full-pipeline and XL lines, then the
    scored tiles/s line, last, the only one on stdout, with bench.py's
    metric); every value > 0; ``forward_mfu`` in (0, 1].  In-process at one
    chunk and one pass, with the launch counters set to 0 just before each
    ``measure`` (a first call, a warm-up and one timed call) and read just
    after: the full program cut after each stage, per canvas
    ``bench_stage_launches``; the fused-tail tile program, per call
    ``tile_path_launches(True)``.  The full program's counts on
    ``BENCH_TWIN_TILES`` tiles equal to the same program through the plain
    twins on the card, which launch nothing.  Then ``python3 -m
    ecseg_torch.bench_stat_fish 3``: exit code 0, one JSON line on stdout."""
    from ecseg_torch import bench
    from ecseg_torch.ops import cc_kernels as K
    from ecseg_torch.ops import tiling
    from ecseg_torch.pipelines import tile_count as tc

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    for var in FORM_VARS + ("ECSEG_BENCH_FULL_TILES",):
        env.pop(var, None)
    work = tempfile.mkdtemp(prefix="ecseg_bench_")
    phase_t0 = time.perf_counter()
    out = {}
    try:
        torch.cuda.empty_cache()  # the subprocesses need the card's memory
        t0 = time.perf_counter()
        rc, lines = run_streams([sys.executable, "-m", "ecseg_torch.bench"], BENCH_TIMEOUT_S, cwd=work, env=env)
        out["command_s"] = time.perf_counter() - t0
        check(rc == 0, f"python -m ecseg_torch.bench exited {rc}:\n" + "\n".join(ln for _, ln in lines[-40:]))
        # the two pipes are read by two threads, so the order of lines across
        # them is not observable here: each stream's order is checked (the
        # merged order is tests/test_torch_bench.py's)
        js = [(tag, json.loads(ln)) for tag, ln in lines if ln.startswith("{")]
        check(len(js) == 3, f"python -m ecseg_torch.bench printed {len(js)} JSON lines, not 3: {js}")
        js = [j for j in js if j[0] == "err"] + [j for j in js if j[0] == "out"]
        stdout = [ln for tag, ln in lines if tag == "out" and ln.strip()]
        check([tag for tag, _ in js] == ["err", "err", "out"] and stdout[-1].startswith("{"),
              f"the scored line is not the last and only stdout JSON line: {js}")
        scored_metric = "1024x1024 DAPI tiles/sec/chip (U-Net seg + CC labeling)"
        want_metrics = [scored_metric + " [full-pipeline: + device meta_inference]", scored_metric + " [arch=xl]", scored_metric]
        check([r["metric"] for _, r in js] == want_metrics, f"metrics {[r['metric'] for _, r in js]}")
        for _, r in js:
            check(r["value"] > 0 and r["unit"] == "tiles/s/chip", f"bench line {r}")
            check(r["forward_mfu"] is not None and 0 < r["forward_mfu"] <= 1, f"forward_mfu of {r}")
        out["lines"] = [r for _, r in js]
        print(f"python -m ecseg_torch.bench: rc 0 in {out['command_s']:.1f} s; " + "; ".join(
            f"{r['metric'][len(scored_metric):].strip() or '[scored]'} {r['value']} tiles/s (forward_mfu {r['forward_mfu']})" for _, r in js), flush=True)

        with post_form("default"), environ({"ECSEG_BENCH_FULL_TILES": None}):
            batch = bench._sizes("default")[0]
            calls = 3  # a first call, a warm-up and reps=1
            stage_ms = {}
            for stage in bench.STAGES:
                K.reset_launches()
                rate = bench.measure("default", full=True, full_stage=stage, nchunks=1, passes=1, reps=1)
                torch.cuda.synchronize()
                launches = dict(K.LAUNCHES)
                want = {k: calls * batch * v for k, v in bench_stage_launches(stage).items()}
                check(launches == want, f"bench full program through {stage}: launches {launches}, want {want}")
                stage_ms[stage] = 1e3 / rate
            K.reset_launches()
            fused_rate = bench.measure("default", fused_tail=True, nchunks=1, passes=1, reps=1)
            torch.cuda.synchronize()
            launches = dict(K.LAUNCHES)
            want = {k: calls * v for k, v in tile_path_launches(True).items()}
            check(launches == want, f"bench fused-tail: launches {launches}, want {want}")
            out["in_process"] = {"full_ms_per_tile": stage_ms, "fused_tail_tiles_per_s": fused_rate, "launches_per_canvas": bench_stage_launches("full")}
            print(f"bench in-process (1 chunk, 1 pass, {batch} tiles a call): full program ms per tile through each stage {stage_ms}; "
                  f"launches per canvas as bench_stage_launches; fused-tail {fused_rate:.2f} tiles/s, launches as tile_path_launches", flush=True)

            model = tc.realistic_model("default", torch.Generator().manual_seed(0)).to(dev)
            patches, positions = tc.tile_patches(tc.synthetic_tiles(BENCH_TWIN_TILES, 0))
            group = torch.from_numpy(patches).to(dev)
            K.reset_launches()
            got = bench.full_program(model, group, positions).cpu()
            check(K.LAUNCHES == {k: BENCH_TWIN_TILES * v for k, v in bench_stage_launches("full").items()}, f"full program on {BENCH_TWIN_TILES} tiles: launches {K.LAUNCHES}")
            K.reset_launches()
            with plain_twins():
                want = bench.full_program(model, group, positions).cpu()
            check(all(v == 0 for v in K.LAUNCHES.values()), f"the twins' run launched {K.LAUNCHES}")
            check(torch.equal(got, want), f"full program counts {got.tolist()} != the plain twins' {want.tolist()}")
            check(bool((got > 10).all()), f"full program counts {got.tolist()} <= 10")
            out["twin_counts"] = got.tolist()
            print(f"bench full program on {BENCH_TWIN_TILES} tiles: counts {got.tolist()} equal the plain twins' on the card", flush=True)
            del model, group

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rc, lines = run_streams([sys.executable, "-m", "ecseg_torch.bench_stat_fish", str(BENCH_STAT_FISH_IMAGES)], BENCH_TIMEOUT_S, cwd=work, env=env)
        out["stat_fish_command_s"] = time.perf_counter() - t0
        check(rc == 0, f"python -m ecseg_torch.bench_stat_fish exited {rc}:\n" + "\n".join(ln for _, ln in lines[-40:]))
        js = [json.loads(ln) for tag, ln in lines if tag == "out" and ln.startswith("{")]
        check(len(js) == 1 and js[0]["n_images"] == BENCH_STAT_FISH_IMAGES and js[0]["value"] > 0, f"bench_stat_fish printed {js}")
        out["stat_fish"] = js[0]
        print(f"python -m ecseg_torch.bench_stat_fish {BENCH_STAT_FISH_IMAGES}: rc 0 in {out['stat_fish_command_s']:.1f} s; "
              f"{js[0]['value']} images/s, top stage {js[0]['top_stage']}", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"phase_bench: {out['phase_s']:.1f} s", flush=True)
    results["bench"] = out


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

    smi = card()
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built the CUDA kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    errors = Errors()
    results = {"card": smi}
    phase_kernels(K, tiling, rng, dev, errors)
    phase_tile_masks(K, dev, errors)  # draws no numbers from rng
    # its own generator, so the main path's images do not depend on it
    phase_multiclass_kernels(K, np.random.default_rng(args.seed + 1), dev, errors)
    # their own generators, so the main path's images do not depend on them
    phase_count_kernels(K, tiling, np.random.default_rng(args.seed + 2), dev, errors)
    phase_tail_kernels(np.random.default_rng(args.seed + 3), dev, errors, results)
    phase_main_path(args, rng, dev, errors, results)
    phase_command_line(args, np.random.default_rng(args.seed + 4), dev, results)
    phase_meta_overlay(args, np.random.default_rng(args.seed + 5), dev, errors, results)
    phase_fish_distance(np.random.default_rng(args.seed + 6), results)
    rows = phase_timings(K, dev, errors, results)
    xl_ms = phase_xl_forward(rng, dev)
    per_tile = phase_tile_count(K, dev, results)
    rows += tile_rows(K, dev, errors, results)
    rows += conv3x3_rows(dev, results)
    phase_bench(dev, results)
    # after every profiler timing: once the card has idled through long host
    # work (stat_fish's tail), torch.profiler drops the device records of
    # short windows and device_ms fails (runtime/devtime.py)
    phase_stat_fish(args, np.random.default_rng(args.seed + 7), dev, errors, results)
    phase_interseg(dev, results)  # draws no numbers: stat_fish's outputs and the demo trees
    phase_multidevice(args, dev, results)  # draws no numbers: the earlier phases' folders
    phase_quant(args, dev, results)  # its own generator
    phase_keras_import(args, dev, results)
    phase_keras_h5(args, dev, results)  # draws no numbers: the main path's and interseg's folders
    phase_tf_models(args, dev, results)  # draws no numbers: stat_fish's folder and seeded trees
    phase_train(args, dev, results)
    torch.cuda.empty_cache()  # this phase's, the studies' and the demo's command lines share the card
    phase_compare_archs(args, dev, results)  # its own generator
    torch.cuda.empty_cache()
    phase_studies(results)  # draws no numbers: each study seeds its own
    phase_demo(results)  # README's demo: command lines, and in-process on a copy
    wrapper_key = {names[1]: key for key, names in ALL_KERNELS.items()}
    for row in rows:  # stat_fish's launches and times beside B2's and B3's metaseg rows
        key = {"label": "label", "flood_from_border": "flood_border"}.get(row["name"])
        if key:
            row["stat_fish"] = results["stat_fish_kernels"][key]
            row["tf_models_launches"] = results["tf_models"]["launches"].get(key, 0)  # stat_fish from the converted checkpoints
        # the demo path's launches (its in-process run), beside the main path's
        row["demo_launches"] = sum(ln.get(wrapper_key.get(row["name"]), 0) for ln in results["demo"]["launches"].values())
        # compare_archs.evaluate's launches on one field (B1 and H1 only)
        row["compare_archs_launches"] = results["compare_archs"]["evaluate"]["launches"].get(wrapper_key.get(row["name"]), 0)
    print(json.dumps({"tile_count_ms_per_tile": per_tile, "card": smi}))
    print(json.dumps({"stages_s": results["stages"], "main_wall_s": results["main_wall_s"], "xl_forward_100_ms": xl_ms, "card": smi}))
    print(json.dumps({"grouped": results["grouped"], "host_post": results["host_post"], "quant": results["quant"], "card": smi}))
    print(json.dumps({"command_line": results["command_line"], "card": smi}))
    print(json.dumps({"meta_overlay": results["overlay"], "fish_distance": results["fish_distance"], "card": smi}))
    print(json.dumps({"stat_fish": results["stat_fish"], "card": smi}))
    print(json.dumps({"transfers": results["transfers"], "card": smi}))
    print(json.dumps({"interseg": results["interseg"], "keras_import": results["keras_import"], "keras_h5": results["keras_h5"], "card": smi}))
    print(json.dumps({"tf_models": results["tf_models"], "card": smi}))
    print(json.dumps({"train": results["train"], "card": smi}))
    print(json.dumps({"compare_archs": results["compare_archs"], "card": smi}))
    print(json.dumps({"multidevice": results["multidevice"], "card": smi}))
    print(json.dumps({"bench": results["bench"], "card": smi}))
    print(json.dumps({"demo": results["demo"], "card": smi}))
    print(json.dumps({"studies": results["studies"], "card": smi}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
