"""The NuSeT watershed's three paths on the card, with their agreement (twin
of ``scripts/profile_fast_watershed.py``).

    python -m ecseg_torch.profile_fast_watershed [--reps R]

Three cases of the JAX script's pass-2 scenario (``make_case``: 40
touching discs on 614^2, the 0.3-rescaled stat_fish geometry, one proposal
around each scored 0.97; seed 0), each path over the three cases, ms per
call:

- ``host``: the priority flood, ``ops/watershed.nuset_marker_watershed``
  (C++), host wall;
- ``device``: the ungated fast path,
  ``ops/watershed_gpu.nuset_marker_watershed_fast`` (the padded geometry),
  ``runtime/devtime.split``, and its agreement with the host per case;
- ``auto``: the certified path, ``nuset_marker_watershed_auto`` (stat_fish's
  default dispatch, the JAX package's ``watershed_tpu.py:344``): how many
  cases its certificate keeps, and its agreement with the host on those
  (the others are recomputed on the host by the caller);
- ``lex_flood``: ``watershed_gpu.lex_flood`` alone on case 0's inputs
  (``flood_inputs``): ``split``, whether it reached its fixpoint and the
  pixels it labelled.

Then one JSON line (``runtime/study.py``).
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.watershed import nuset_marker_watershed, nuset_place_markers
from .ops.watershed_gpu import flood_inputs, lex_flood, nuset_marker_watershed_auto, nuset_marker_watershed_fast
from .runtime.study import Study, no_card, opt

MIN_SCORE = 0.95
CASES = 3


def make_case(rng, H=614, W=614, n=40):
    """``scripts/profile_fast_watershed.py``'s case: (float32 mask, scores,
    proposals x1 y1 x2 y2), in its draw order."""
    mask = np.zeros((H, W), bool)
    centers = []
    while len(centers) < n:
        cy, cx = int(rng.integers(30, H - 30)), int(rng.integers(30, W - 30))
        r = int(rng.integers(14, 26))
        yy, xx = np.ogrid[:H, :W]
        mask |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        centers.append((cy, cx, r))
    pred = mask.astype(np.float32)
    props = np.array([[cx - r, cy - r, cx + r, cy + r] for cy, cx, r in centers], np.float32)
    scores = np.full(len(centers), 0.97, np.float32)
    return pred, scores, props


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if device is None and no_card("profile_fast_watershed"):
        return 1
    dev = resolve_device(device)
    reps = opt(argv, "--reps", 3)
    study = Study("profile_fast_watershed", dev)
    rng = np.random.default_rng(0)
    cases = [make_case(rng) for _ in range(CASES)]

    t0 = time.perf_counter()
    nuset_marker_watershed_fast(cases[0][1], cases[0][2], cases[0][0], MIN_SCORE, dev)
    if study.timed:
        print(f"device compile+first: {time.perf_counter() - t0:.1f} s", flush=True)

    host = study.host_row("host", lambda: [nuset_marker_watershed(s, p, m, min_score=MIN_SCORE) for m, s, p in cases],
                          reps, per=CASES)

    def agreement(outs):
        return {"agreement": [float((h == d).mean()) for h, d in zip(host, outs)]}

    study.device_row("device", lambda: [nuset_marker_watershed_fast(s, p, m, MIN_SCORE, dev) for m, s, p in cases],
                     reps, per=CASES, report=agreement)

    def kept(outs):
        keep = [(h, out) for h, (out, _) in zip(host, outs) if out is not None]
        return {"kept": len(keep), "cases": CASES, "certificates": [n for _, n in outs],
                "agreement_kept": [float((h == out).mean()) for h, out in keep]}

    study.device_row("auto", lambda: [nuset_marker_watershed_auto(s, p, m, MIN_SCORE, dev) for m, s, p in cases],
                     reps, per=CASES, report=kept)

    pred, scores, props = cases[0]
    mask = torch.from_numpy(pred != 0).to(dev)
    img, markers = flood_inputs(mask, torch.from_numpy(nuset_place_markers(scores, props, pred, MIN_SCORE)).to(dev))
    study.device_row("lex_flood", lambda: lex_flood(img, markers, mask), reps,
                     report=lambda out: {"converged": bool(out[3]), "labelled": int((out[2] > 0).sum())})
    study.emit(cases=CASES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
