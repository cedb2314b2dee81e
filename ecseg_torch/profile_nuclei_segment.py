"""stat_fish's NuSeT segmentation split into its steps, host against device
(twin of ``scripts/profile_nuclei_segment.py``).

    python -m ecseg_torch.profile_nuclei_segment [--size S] [--reps R]

The JAX script's image (``make_image``: 26 discs of 190-239 on 12, seed 0,
2048^2) and NuSeT at scale 0.3 (``models/nuset.npz`` in the working
directory, as ``python -m ecseg_torch.make_demo_weights`` writes it, else
the same demo tree in memory).  Rows, steady state over ``--reps``
(default 3) after a first call:

| row | port step |
|---|---|
| ``nuclei_segment TOTAL`` | ``models/nuset_infer.nuclei_segment`` |
| ``rescale 0.3 (host)`` | ``ops/resize.rescale`` (``nuclei_segment_prepare``'s) |
| ``whole_image_norm (host)`` | ``ops/normalization.whole_image_norm`` |
| ``nuset pass 1 (device)`` | ``nuset_forward(pass_two=False)`` |
| ``foreground_norm (host)`` | ``ops/normalization.foreground_norm`` |
| ``nuset pass 2 + watershed`` | ``nuset_forward(pass_two=True)``, the watershed in ``ECSEG_FAST_WATERSHED``'s mode |
| ``cleanup_pass (device)`` | ``nuset_infer.cleanup_pass`` |
| ``clean_image (device)`` | ``ops/morphology_gpu.clean_image`` (B2 x3) |
| ``rescale back 1/0.3 (device)`` | ``ops/resize.resize_linear_matmul`` (the cleanup's resize back) |
| ``remove_small_objects (device)`` | ``ops/morphology_gpu.remove_small_objects`` (B2) |

The JAX script's cleanup rows ran its host chain; the port's
``nuclei_segment`` runs the device chain (``cleanup_pass``) unless
``ECSEG_DEVICE_PIPELINE=0``, so those rows time its parts, with the whole
pass beside them (the removal row takes the pass's min-max binarize,
``nuset_infer.binarize``, of the resized mask).  Host rows report the host wall only; device rows
``runtime/devtime.split``.  With the demo tree the RPN places no marker
above min_score 0.95, and the watershed is the reference's pass-through.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models import nuset_infer
from .models.nuset_infer import nuset_forward, output_shape
from .models.weights import load_nuset_model
from .ops.morphology_gpu import clean_image, remove_small_objects
from .ops.normalization import foreground_norm, whole_image_norm
from .ops.resize import rescale, resize_linear_matmul
from .runtime.hostmem import tune_host_allocator
from .runtime.study import Study, no_card, opt

SCALE = 0.3
NUCLEI_SIZE_T = 5000


def make_image(hw: int = 2048, seed: int = 0) -> np.ndarray:
    """``scripts/profile_nuclei_segment.py``'s image, in its draw order."""
    rng = np.random.default_rng(seed)
    img = np.zeros((hw, hw), np.uint8)
    yy, xx = np.mgrid[:hw, :hw]
    for _ in range(26):
        cy, cx = rng.integers(120, hw - 120, 2)
        r = int(rng.integers(45, 90))
        m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        img[m] = int(rng.integers(190, 240))
    img[img == 0] = 12
    return img


def _sum(x) -> dict:
    return {"foreground": int(np.count_nonzero(np.asarray(x)))}


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    tune_host_allocator()
    argv = sys.argv[1:] if argv is None else list(argv)
    if device is None and no_card("profile_nuclei_segment"):
        return 1
    dev = resolve_device(device)
    size = opt(argv, "--size", 2048)
    reps = opt(argv, "--reps", 3)
    study = Study("profile_nuclei_segment", dev)
    img = make_image(size)
    model = load_nuset_model(device=dev, resize_scale=SCALE)
    with torch.no_grad():
        study.device_row("nuclei_segment TOTAL", lambda: nuclei_segment(img, model), reps, report=_sum)
        scaled = study.host_row("rescale 0.3 (host)", lambda: rescale(img, SCALE, anti_aliasing=True), reps)
        h16, w16 = (d // 16 * 16 for d in scaled.shape)
        scaled = scaled[:h16, :w16]
        wn = study.host_row("whole_image_norm (host)", lambda: whole_image_norm(scaled), reps)
        m1 = study.device_row("nuset pass 1 (device)", lambda: nuset_forward(model, wn, pass_two=False), reps, report=_sum)
        fg = study.host_row("foreground_norm (host)", lambda: foreground_norm(scaled, m1), reps)
        mw = study.device_row("nuset pass 2 + watershed", lambda: nuset_forward(model, fg, pass_two=True), reps, report=_sum)
        out_hw = output_shape(mw.shape, SCALE)
        study.device_row("cleanup_pass (device)", lambda: nuset_infer.cleanup_pass(mw, out_hw, NUCLEI_SIZE_T, dev), reps,
                         report=_sum)
        mask = torch.from_numpy(np.asarray(mw) != 0).to(dev)
        cl = study.device_row("clean_image (device)", lambda: clean_image(mask), reps, report=lambda t: _sum(t.cpu()))
        up = study.device_row("rescale back 1/0.3 (device)", lambda: resize_linear_matmul(cl.float(), out_hw), reps)
        study.device_row("remove_small_objects (device)", lambda: remove_small_objects(nuset_infer.binarize(up), NUCLEI_SIZE_T), reps,
                         report=lambda t: _sum(t.cpu()))
    study.emit(size=size, scale=SCALE, nuset_input=[h16, w16])
    return 0


def nuclei_segment(img: np.ndarray, model) -> np.ndarray:
    return nuset_infer.nuclei_segment(img, model, NUCLEI_SIZE_T)


if __name__ == "__main__":
    sys.exit(main())
