"""End-to-end stat_fish throughput on the card (twin of
``scripts/bench_stat_fish.py``).

    python -m ecseg_torch.bench_stat_fish [N_IMAGES] [--out PATH]

Drives ``ecseg_torch.pipelines.stat_fish.main`` over a folder of N (default
6) synthetic 2048^2 interphase FISH images (DAPI nuclei, some in touching
pairs for the min-cut, green and red FISH foci) at the fixed scale 0.3, with
the weights ``models/nuset.npz`` in the working directory holds (without
it, the crafted demo tree).  The first pass over the folder pays the
one-time set-up (cuDNN, the host C++ build); the second is the measurement.
Prints one JSON line on stdout:

    {"metric": "stat_fish 2048^2 images/s/chip (end-to-end: ...)", ...}

and the stage table of ``runtime/trace.py`` on stderr (``ECSEG_TRACE`` is
set on when it is unset), so the top stage stands beside the headline
number.  ``--out PATH`` also writes the line as a JSON file.  Runs on the
card; without one it exits non-zero.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .core import imgio
from .core.config import Config
from .device import DeviceLike, resolve_device
from .runtime.hostmem import tune_host_allocator


def make_images(d: str, n: int, hw: int = 2048, seed: int = 0) -> None:
    """``scripts/bench_stat_fish.py:32-68``'s images, in its draw order: a
    BGR uint8 array (DAPI in channel 0, the FISH foci in channels 1 and 2)
    written as ``cv2.imwrite`` writes it, so that ``imread_bgr8`` gives the
    array back."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw]
    for k in range(n):
        img = np.zeros((hw, hw, 3), np.uint8)
        img[..., 0] = 12  # DAPI background
        centers = []
        for _ in range(18):  # isolated nuclei
            cy = int(rng.integers(120, hw - 120))
            cx = int(rng.integers(120, hw - 120))
            r = int(rng.integers(45, 90))
            centers.append((cy, cx, r))
        for _ in range(4):  # touching pairs
            cy = int(rng.integers(160, hw - 160))
            cx = int(rng.integers(160, hw - 160))
            r = int(rng.integers(50, 80))
            centers.append((cy, cx, r))
            centers.append((cy + int(1.6 * r), cx, r))
        for cy, cx, r in centers:
            m = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[..., 0][m] = int(rng.integers(190, 240))
            for ch in (1, 2):  # FISH foci inside the nucleus: green, red
                for _ in range(int(rng.integers(1, 4))):
                    dy = int(rng.integers(-r // 2, r // 2))
                    dx = int(rng.integers(-r // 2, r // 2))
                    y, x = cy + dy, cx + dx
                    img[y - 2 : y + 3, x - 2 : x + 3, ch] = int(rng.integers(170, 250))
        imgio.imwrite(os.path.join(d, f"bench_{k:02d}.tif"), img)


def run_once(inpath: str, device: DeviceLike = None) -> float:
    """Seconds of one ``stat_fish.main`` over ``inpath``."""
    from .pipelines import stat_fish

    cfg = Config(raw={"stat_fish": {"inpath": inpath, "scale": 0.3, "use_min_cut": True, "nuclei_size_T": 5000}})
    t0 = time.perf_counter()
    rc = stat_fish.main(config=cfg, device=device)
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"stat_fish failed rc={rc}")
    return dt


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    tune_host_allocator()
    argv = sys.argv[1:] if argv is None else list(argv)
    if device is None and not torch.cuda.is_available():
        print("bench_stat_fish: no CUDA device is available; aborting without a result", file=sys.stderr, flush=True)
        return 1
    dev = resolve_device(device)
    os.environ.setdefault("ECSEG_TRACE", "1")
    from .runtime.trace import tracer

    pos = [a for i, a in enumerate(argv) if not a.startswith("--") and (i == 0 or argv[i - 1] != "--out")]
    n = int(pos[0]) if pos else 6
    with tempfile.TemporaryDirectory() as d:
        print(f"generating {n} synthetic 2048^2 images...", file=sys.stderr, flush=True)
        make_images(d, n)
        print("pass 1 (set-up)...", file=sys.stderr, flush=True)
        warm = run_once(d, dev)
        print(f"pass 1: {warm:.1f}s (incl. set-up)", file=sys.stderr, flush=True)
        tracer().reset()

        print("pass 2 (steady state)...", file=sys.stderr, flush=True)
        dt = run_once(d, dev)
        stages = {name: sum(ts) for name, ts in tracer().times().items()}
        top = max(stages, key=stages.get) if stages else "n/a"
        tracer().report(out=sys.stderr)
        tracer().reset()

    result = {
        "metric": "stat_fish 2048^2 images/s/chip (end-to-end: NuSeT x2 "
        "+ min-cut + matched filter + region stats + writes)",
        "value": round(n / dt, 3),
        "unit": "images/s/chip",
        "seconds_per_image": round(dt / n, 2),
        "n_images": n,
        "top_stage": f"{top} ({stages.get(top, 0):.1f}s of {dt:.1f}s)",
        "stages_s": {k: round(v, 2) for k, v in sorted(stages.items(), key=lambda kv: -kv[1])},
        "wall_s": round(dt, 2),
    }
    print(json.dumps(result), flush=True)
    if "--out" in argv:
        with open(argv[argv.index("--out") + 1], "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
