"""How far the NuSeT fast watershed departs from the host priority flood
(twin of ``scripts/quantify_watershed_divergence.py``).

    python -m ecseg_torch.quantify_watershed_divergence [N]

Over N (default 24) cases of ``profile_fast_watershed.make_case`` (seed 0,
drawn one after another from one generator, as the JAX script draws them):
the host flood (``ops/watershed.nuset_marker_watershed``) against the
ungated fast path on the card (``ops/watershed_gpu.nuset_marker_watershed_fast``
with ``count_ties``: a second flood with the marker ids permuted, and the
contour pixels that flip).  Prints the JAX script's per-case lines and its
five summary lines letter for letter, then one JSON line
(``runtime/study.py``) with the per-case numbers and each case's host wall
(the host flood, then the fast path with its tie count; the card's clock,
ended by a sync).  The numbers are deterministic: on the card they equal
the CPU's, and on the CPU the JAX script's.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.watershed import nuset_marker_watershed
from .ops.watershed_gpu import nuset_marker_watershed_fast
from .profile_fast_watershed import MIN_SCORE, make_case
from .runtime.hostmem import tune_host_allocator
from .runtime.study import Study, no_card, positional


def _timed(study: Study, fn):
    t0 = time.perf_counter()
    out = fn()
    if not study.timed:
        return out, None
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    tune_host_allocator()
    argv = sys.argv[1:] if argv is None else list(argv)
    if device is None and no_card("quantify_watershed_divergence"):
        return 1
    dev = resolve_device(device)
    pos = positional(argv)
    n = int(pos[0]) if pos else 24
    study = Study("quantify_watershed_divergence", dev)
    rng = np.random.default_rng(0)

    agreements, tie_fracs, div_images = [], [], 0
    tot_px = tot_div = tot_tie = 0
    for k in range(n):
        pred, scores, props = make_case(rng)
        host, host_ms = _timed(study, lambda: nuset_marker_watershed(scores, props, pred, min_score=MIN_SCORE))
        (fast, tie_px), fast_ms = _timed(
            study, lambda: nuset_marker_watershed_fast(scores, props, pred, MIN_SCORE, dev, count_ties=True)
        )
        fg = int(np.count_nonzero(pred))
        div = int(np.count_nonzero(host != fast))
        agreements.append(1.0 - div / host.size)
        tie_fracs.append(tie_px / max(fg, 1))
        div_images += div > 0
        tot_px += fg
        tot_div += div
        tot_tie += tie_px
        print(
            f"case {k:2d}: fg={fg:7d} divergent_px={div:5d} "
            f"tie_px(proxy)={tie_px:5d} agreement={agreements[-1]:.6f}",
            flush=True,
        )
        study.row(f"case {k}", quiet=True, fg=fg, divergent_px=div, tie_px=tie_px, agreement=agreements[-1],
                  host_wall_ms=host_ms, fast_wall_ms=fast_ms)

    print()
    print(f"cases: {n} @ 614x614, ~40 touching nuclei each")
    print(
        f"pixel agreement: mean={np.mean(agreements):.6f} "
        f"min={np.min(agreements):.6f}"
    )
    print(
        f"images with any divergence: {div_images}/{n} "
        f"({100.0 * div_images / n:.0f}%)"
    )
    print(
        f"divergent px: {tot_div} / {tot_px} foreground "
        f"({100.0 * tot_div / tot_px:.4f}%)"
    )
    print(
        f"tie px (order-dependence proxy): {tot_tie} "
        f"({100.0 * tot_tie / tot_px:.4f}% of foreground; "
        f"per-image mean {np.mean(tie_fracs) * 100:.4f}%)",
        flush=True,
    )
    study.emit(cases=n, summary={
        "agreement_mean": float(np.mean(agreements)), "agreement_min": float(np.min(agreements)),
        "images_diverging": div_images, "divergent_px": tot_div, "foreground_px": tot_px, "tie_px": tot_tie,
        "tie_share_mean": float(np.mean(tie_fracs)),
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
