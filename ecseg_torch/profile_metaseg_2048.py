"""metaseg on one 2048^2 image, host against device (twin of
``scripts/profile_metaseg_2048.py``).

    python -m ecseg_torch.profile_metaseg_2048 [--size S] [--reps R]

The JAX script's image (uint8 noise below 60 and 300 squares of 200, seed
0; ``make_image``) -> ``tiling.im2patches_overlap`` (100 patches at 2048^2)
-> ``pipelines/metaseg.segment_raw`` (forward, exact uint8 quantize and
argmax, stitch on B1) -> ``post_process`` (``meta_inference_gpu`` on B2-B6
in the form ``ECSEG_MC_LABEL``/``ECSEG_MC_MERGE`` select, the ecDNA count,
the 2-bit packed blob and its fetch), on the default-width U-Net with
seeded random weights.  Per
dtype (float32 under the parity flags, as metaseg runs it; bf16 weights,
as the JAX script and the bench run it) it prints the first
forward call's host seconds and ``runtime/devtime.split`` over ``--reps``
(default 3) calls of the image's parts: ``forward`` (upload, forward,
argmax), ``stitch`` (B1), ``post`` (``metaseg.post_blob``: meta_inference,
the count and the packing) and ``fetch`` (the blob's copy to the host and
its decode, as the JAX script's packed fetch); then, per dtype, of
steady-state images, with ``ok``, ``num_ec`` and the label classes, as the
script prints them.  The parts come first: an image over the post's
budgets is redone on the host, and that idle card spoils the profiler's
later short windows (``runtime/devtime.py``).
``--size`` shrinks the image (at least 256), and the tests narrow
``models/metaseg_unet``'s widths, which are read at each call.
"""

from __future__ import annotations

import copy
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models import metaseg_unet
from .models.metaseg_unet import MetasegUNet
from .ops import tiling
from .ops.cc_kernels import stitch_labels
from .ops.packing import fetch
from .pipelines.metaseg import decode_post_blob, post_blob, post_process, segment_raw
from .runtime.hostmem import tune_host_allocator
from .runtime.study import Study, no_card, opt

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_image(size: int = 2048, seed: int = 0) -> np.ndarray:
    """``scripts/profile_metaseg_2048.py``'s image, in its draw order."""
    rng = np.random.default_rng(seed)
    h = w = size
    img = (rng.random((h, w)) * 60).astype(np.uint8)
    for _ in range(300):
        y, x = rng.integers(0, h - 60), rng.integers(0, w - 60)
        r = int(rng.integers(3, 40))
        img[y : y + r, x : x + r] = 200
    return img


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    tune_host_allocator()
    argv = sys.argv[1:] if argv is None else list(argv)
    if device is None and no_card("profile_metaseg_2048"):
        return 1
    dev = resolve_device(device)
    size = opt(argv, "--size", 2048)
    reps = opt(argv, "--reps", 3)

    study = Study("profile_metaseg_2048", dev)
    img = make_image(size)
    _, patches, pos = tiling.im2patches_overlap(img[..., None])
    pos = tuple(map(tuple, pos))
    print(f"patches: {patches.shape}", flush=True)
    base = MetasegUNet(metaseg_unet.ENC_WIDTHS, metaseg_unet.BOTTLENECK, generator=torch.Generator().manual_seed(0))
    base = base.to(dev).eval()
    models = {name: base if dtype == torch.float32 else copy.deepcopy(base).to(dtype) for name, dtype in DTYPES.items()}
    first = {}
    with torch.no_grad():
        # the parts first: the whole image's host redo (an image over the
        # post's budgets) leaves the card idle long enough to spoil
        # torch.profiler's later short windows (runtime/devtime.py)
        for name, model in models.items():
            print(f"-- {name}: the parts", flush=True)

            def forward(model=model):
                return tiling.patch_labels(model(torch.from_numpy(patches).to(dev)))

            t0 = time.perf_counter()
            forward()
            first[name] = time.perf_counter() - t0 if study.timed else None
            if study.timed:
                print(f"compile+first (forward): {first[name]:.1f} s", flush=True)
            lp = study.device_row("forward", forward, reps, dtype=name)
            raw = study.device_row("stitch", lambda lp=lp: stitch_labels(lp, pos), reps, dtype=name)

            blob = study.device_row("post", lambda raw=raw: post_blob(raw), reps, dtype=name)
            study.device_row("fetch", lambda blob=blob, w=raw.shape[1]: decode_post_blob(fetch(blob), w), reps, dtype=name)
        for name, model in models.items():
            print(f"-- {name}: the image", flush=True)

            def image(model=model):
                return post_process(segment_raw(model, patches, pos))

            def classes(out):
                labels, num_ec, ok = out
                return {"ok": bool(ok), "num_ec": int(num_ec), "labels": list(labels.shape),
                        "classes": np.unique(labels).tolist()}

            out = study.device_row("steady-state image", image, reps, dtype=name, report=classes)
            print(f"ok={out[2]} num_ec={out[1]} labels={out[0].shape} classes={np.unique(out[0])}", flush=True)
    study.emit(patches=len(pos), size=size, first_call_s=first)
    return 0


if __name__ == "__main__":
    sys.exit(main())
