"""Analytic roofline of the metaseg U-Net forward on one card (twin of
``scripts/roofline_forward.py``).

    python -m ecseg_torch.roofline_forward [--arch default|xl]

Per layer: FLOPs = 2 * K * K * S * Cin * Cout; memory traffic = the bf16
activations in and out (the weights are negligible), the least any
implementation moves, since each conv reads its input once and writes its
output once.  Layer time >= max(FLOPs / peak FLOP/s, bytes / bandwidth).
The per-layer maxima sum to the per-patch floor; 25 patches per 1024^2
tile give the tiles/s ceiling.  The rows (:func:`layers`) are the JAX
script's: the same names, FLOPs and bytes, the pools, the stride-2
transpose convs at the 9/4 multiply-adds an output pixel that they do (the
port's cuDNN and B11 transpose convs do as many), and the epilogue.

The peaks are the card's from ``peaks.PEAKS`` (the H100 SXM's: 989 TFLOP/s
dense bf16, 3.35 TB/s), named on the first line.  Columns and totals are
the script's; a compute-bound layer is marked ``TC`` (tensor cores) where
the script marks ``MXU``, and the floors print to the microsecond (the
default width's is 0.946 ms a tile; two decimals would show 0.95).
A layer's floor for ``profile_layers``' chunk of 800 patches is
max(t_flop_us, t_bw_us) * 800 / 1000 ms.  Pure arithmetic: it needs no
device.  ``bench``'s ``forward_mfu`` counts the transpose convs
at all 9 taps (``metaseg_unet.flops_per_patch``), 28.5 % more work than
these rows at the default widths.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

from .models import metaseg_unet as mu
from .peaks import H100, PEAKS

PATCHES_PER_TILE = 25  # 1024x1024 at stride 206


def layers(widths: Sequence[int], bottleneck: int, num_classes: int = 4, patch: int = 256,
           in_ch: int = 1) -> List[Tuple[str, int, int]]:
    """(name, flops, bytes) for every layer of the forward, one patch."""
    s = patch * patch
    c = in_ch
    out = []

    def conv(name, s, cin, cout, k=3, bytes_scale=2):
        out.append((name, 2 * k * k * s * cin * cout, bytes_scale * s * (cin + cout)))  # bf16 in + out

    for i, w in enumerate(widths, 1):
        conv(f"enc{i}_1", s, c, w)
        conv(f"enc{i}_2", s, w, w)
        out.append((f"pool{i}", 0, 2 * (s + s // 4) * w))
        c = w
        s //= 4
    conv("bott_1", s, c, bottleneck)
    conv("bott_2", s, bottleneck, bottleneck)
    c = bottleneck
    for i, w in zip(range(len(widths), 0, -1), reversed(widths)):
        s *= 4
        # the transpose conv at output resolution, 9/4 multiply-adds an output pixel
        out.append((f"up{i}", 2 * 9 * s * c * w // 4, 2 * (s // 4 * c + s * w)))
        conv(f"dec{i}_1", s, 2 * w, w)
        conv(f"dec{i}_2", s, w, w)
        c = w
    conv("head", s, c, num_classes, k=1)
    # the float32 softmax, exact quantize and argmax: reads and writes
    out.append(("epilogue", 0, s * num_classes * (4 + 4) + s * 4))
    return out


def totals(rows, peak_flops: float, peak_bw: float) -> dict:
    """The script's totals: GFLOP a patch, the pure-compute and roofline
    floors in ms a tile, the ceiling in tiles/s, the share of compute time
    at the ceiling (``mfu``) and the share of layer time bound by
    bandwidth."""
    tot_f = sum(f for _, f, _ in rows)
    tot_compute = sum(f / peak_flops for _, f, _ in rows)
    tot_t = sum(max(f / peak_flops, b / peak_bw) for _, f, b in rows)
    per_tile = tot_t * PATCHES_PER_TILE
    return {
        "gflop_per_patch": tot_f / 1e9,
        "compute_floor_ms_per_tile": tot_compute * PATCHES_PER_TILE * 1e3,
        "floor_ms_per_tile": per_tile * 1e3,
        "ceiling_tiles_per_s": 1 / per_tile,
        "mfu": tot_compute / tot_t,
        "bandwidth_share": sum(max(0, b / peak_bw - f / peak_flops) for _, f, b in rows) / tot_t,
    }


def total_lines(t: dict) -> List[str]:
    """The script's two closing lines for :func:`totals`' ``t``."""
    return [
        f"total {t['gflop_per_patch']:.1f} GFLOP/patch; pure-compute floor {t['compute_floor_ms_per_tile']:.3f} "
        f"ms/tile; roofline floor {t['floor_ms_per_tile']:.3f} ms/tile -> ceiling "
        f"{t['ceiling_tiles_per_s']:.1f} tiles/s/chip",
        f"effective MFU at the roofline ceiling: {t['mfu']:.3f} (bandwidth share {t['bandwidth_share']:.1%})",
    ]


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ecseg_torch.roofline_forward")
    ap.add_argument("--arch", default="default", choices=["default", "xl"])
    args = ap.parse_args(argv)
    widths, bott = (mu.ENC_WIDTHS_XL, mu.BOTTLENECK_XL) if args.arch == "xl" else (mu.ENC_WIDTHS, mu.BOTTLENECK)
    peak = PEAKS[H100]
    peak_flops, peak_bw = peak["bfloat16"], peak["hbm_bytes_per_s"]
    print(f"peaks of {H100} ({peak['part']}): {peak_flops / 1e12:g} TFLOP/s dense bf16, "
          f"{peak_bw / 1e12:g} TB/s; arch {args.arch}")
    rows = layers(widths, bott)
    print(f"{'layer':10s} {'GFLOP':>8s} {'MB':>8s} {'t_flop_us':>10s} {'t_bw_us':>8s} {'bound':>6s}")
    for name, f, b in rows:
        tf_, tb = f / peak_flops, b / peak_bw
        print(f"{name:10s} {f / 1e9:8.2f} {b / 1e6:8.2f} {tf_ * 1e6:10.1f} {tb * 1e6:8.1f} {'BW' if tb > tf_ else 'TC':>6s}")
    print()
    for line in total_lines(totals(rows, peak_flops, peak_bw)):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
