"""The device post's blocks, host against device (twin of
``scripts/profile_meta_post.py``).

    python -m ecseg_torch.profile_meta_post [N] [--size S [S ...]]

Runs on N (default 6) distinct seeded label maps (``_label_maps``, the JAX
script's generator, seed 0) at each side S (default 1024, the JAX script's
canvas and the bench's, and 2048, metaseg's image) and times each block of
``ops/meta_post_gpu.py`` over the N canvases with ``runtime/devtime.split``:
per canvas the host wall (ended by a sync), the device time, the device
operations and the host syncs.  The form is the one ``ECSEG_MC_LABEL`` and
``ECSEG_MC_MERGE`` select, as the post reads them.

| row | port block |
|---|---|
| ``label_pallas`` | B2, ``cc_kernels.label`` |
| ``flood_border`` | B3, ``cc_kernels.flood_from_border`` |
| ``fill_holes(flood form)`` | ``morphology_gpu.binary_fill_holes`` (on B3) |
| ``label+scatter_add(sizes)`` | ``meta_post_gpu._root_sizes`` of ``_flat_roots`` |
| ``label+nonzero(2048)`` | ``_centroids``' ``torch.nonzero`` of the sizes |
| ``component_sums(current)`` | ``_centroids`` (areas and coordinate sums) |
| ``size_thresh`` | ``_size_thresh`` |
| ``metaphase_removal`` | ``_metaphase_removal`` |
| ``merge_comp(1)`` | ``_merge_comp`` |
| ``fill_holes_class(1)`` | ``_fill_holes_class`` |
| ``meta_inference FULL`` | ``meta_inference_gpu`` |

The JAX script's amortizing ``lax.scan`` has no counterpart: an eager call
has no relay dispatch to hide, and its host cost is what this study
measures.  Not ported, each a probe of a TPU-only redesign or of
``ECSEG_GROUP_POST`` (deviation 12): ``label+compact_roots``,
``label+sort``, ``label+scatterLUT+gather1M``, ``label+eq-matmul-sums(5)``
and ``--vmap``.  Each row also reports a checksum of its integer outputs
over the N canvases, equal on the card and the CPU.  The stage rows
(``fill_holes_class``, ``size_thresh``, ``metaphase_removal``,
``merge_comp``) run on the raw canvases, not on each other's outputs; the
JSON line gives their device sum beside ``meta_inference FULL``'s.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .ops.cc_kernels import flood_from_border, label
from .ops.meta_post_gpu import (
    _centroids,
    _fill_holes_class,
    _flat_roots,
    _merge_comp,
    _metaphase_removal,
    _root_sizes,
    _size_thresh,
    meta_inference_gpu,
    use_fused_merge,
    use_multiclass,
)
from .ops.morphology_gpu import binary_fill_holes
from .runtime.hostmem import tune_host_allocator
from .runtime.study import Study, no_card, opt, positional

SIZES = (1024, 2048)
STAGE_ROWS = ("fill_holes_class(1)", "size_thresh", "metaphase_removal", "merge_comp(1)")


def _label_maps(rng, n, shape=(1024, 1024)):
    """``scripts/profile_meta_post.py``'s canvases: squares of classes 1-3
    (8 of side < 60, 40 < 12, 120 < 7) in its draw order."""
    out = np.zeros((n,) + shape, np.int32)
    for k in range(n):
        for lab, cnt, rmax in [(1, 8, 60), (2, 40, 12), (3, 120, 7)]:
            for _ in range(cnt):
                y = rng.integers(0, shape[0] - rmax)
                x = rng.integers(0, shape[1] - rmax)
                r = int(rng.integers(2, rmax))
                out[k, y : y + r, x : x + r] = lab
    return out


def checksum(out) -> int:
    """Sum of the integer and bool tensors of a block's result."""
    if isinstance(out, (tuple, list)):
        return sum(checksum(o) for o in out)
    if isinstance(out, torch.Tensor) and not out.is_floating_point():
        return int(out.long().sum())
    return 0


def blocks(hw: int, w: int, mc: bool, fused: bool):
    """(row, block on a mask or a class map, takes the class map)."""

    def nonzero_roots(m):
        return torch.nonzero(_root_sizes(_flat_roots(m), hw)).reshape(-1)

    return [
        ("label_pallas", label, False),
        ("flood_border", lambda m: flood_from_border(~m), False),
        ("fill_holes(flood form)", binary_fill_holes, False),
        ("label+scatter_add(sizes)", lambda m: _root_sizes(_flat_roots(m), hw), False),
        ("label+nonzero(2048)", nonzero_roots, False),
        ("component_sums(current)", lambda m: _centroids(_flat_roots(m), hw, w), False),
        ("size_thresh", lambda x: _size_thresh(x, hw, mc)[0], True),
        ("metaphase_removal", lambda x: _metaphase_removal(x, hw, mc)[0], True),
        ("merge_comp(1)", lambda x: _merge_comp(x, 1, hw, fused), True),
        ("fill_holes_class(1)", lambda x: _fill_holes_class(x, 1), True),
        ("meta_inference FULL", lambda x: meta_inference_gpu(x)[0], True),
    ]


def main(argv: Optional[Sequence[str]] = None, device: DeviceLike = None) -> int:
    tune_host_allocator()
    argv = sys.argv[1:] if argv is None else list(argv)
    if device is None and no_card("profile_meta_post"):
        return 1
    dev = resolve_device(device)
    sizes = opt(argv, "--size", list(SIZES), many=True)
    pos = positional(argv)
    n_iter = int(pos[0]) if pos else 6
    mc, fused = use_multiclass(), use_fused_merge()
    study = Study("profile_meta_post", dev)
    print(f"form: ECSEG_MC_LABEL {'on' if mc else 'off'}, ECSEG_MC_MERGE {'on' if fused else 'off'}; {n_iter} canvases", flush=True)
    sums = {}
    for side in sizes:
        rng = np.random.default_rng(0)
        imgs = [torch.from_numpy(a).to(dev).long() for a in _label_maps(rng, n_iter, (side, side))]
        masks = [x == 1 for x in imgs]
        print(f"-- {side}x{side}", flush=True)
        for name, fn, on_classes in blocks(side * side, side, mc, fused):
            xs = imgs if on_classes else masks

            def run(fn=fn, xs=xs):
                return [fn(x) for x in xs]

            study.device_row(name, run, reps=3, per=n_iter, size=side, report=lambda out: {"checksum": checksum(out)})
        rows = {r["name"]: r for r in study.rows if r["size"] == side}
        if study.timed:
            sums[side] = {"stage_rows_device_ms": sum(rows[k]["device_ms"] for k in STAGE_ROWS),
                          "full_device_ms": rows["meta_inference FULL"]["device_ms"]}
            print(f"stage rows' device sum {sums[side]['stage_rows_device_ms']:.3f} ms beside meta_inference FULL's "
                  f"{sums[side]['full_device_ms']:.3f} ms a canvas", flush=True)
    study.emit(canvases=n_iter, form={"mc_label": mc, "mc_merge": fused}, sums=sums)
    return 0


if __name__ == "__main__":
    sys.exit(main())
