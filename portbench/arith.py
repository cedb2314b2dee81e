"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of each configuration's forward, counted from its published shapes.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity); the
float32 forwards run with TF32 off, so their peak is the 67 TFLOP/s of the
CUDA cores.  Counts: a 3x3 'SAME' conv is 2 * 9 * S * Cin * Cout FLOPs;
a stride-2 3x3 transpose conv does 9/4 multiply-adds an output pixel (the
taps that meet a zero of the dilated input are no work), as
``roofline_forward`` counts them; bytes are each layer's input read once
and output written once, at the forward's element size.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

H100 = "NVIDIA H100 80GB HBM3"
PEAKS = {H100: {"float32": 67e12, "bfloat16": 989e12, "hbm_bytes_per_s": 3.35e12}}
ELEM_BYTES = {"float32": 4, "bfloat16": 2}

Row = Tuple[str, int, int]  # (layer, FLOPs, bytes)


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The card's peaks; None for a device not in the table (a share of a
    peak is then not reported)."""
    return PEAKS.get(device_name)


def metaseg_rows(cfg: Dict) -> List[Row]:
    """One 256^2 patch of the metaseg U-Net (``roofline_forward.layers``,
    its bf16 bytes scaled to the configuration's element size)."""
    eb = ELEM_BYTES[cfg["dtype"]]
    s, c = cfg["patch"] ** 2, cfg["in_channels"]
    rows: List[Row] = []

    def conv(name, s, cin, cout, k=3):
        rows.append((name, 2 * k * k * s * cin * cout, eb * s * (cin + cout)))

    for i, w in enumerate(cfg["widths"], 1):
        conv(f"enc{i}_1", s, c, w)
        conv(f"enc{i}_2", s, w, w)
        rows.append((f"pool{i}", 0, eb * (s + s // 4) * w))
        c, s = w, s // 4
    conv("bott_1", s, c, cfg["bottleneck"])
    conv("bott_2", s, cfg["bottleneck"], cfg["bottleneck"])
    c = cfg["bottleneck"]
    for i, w in zip(range(len(cfg["widths"]), 0, -1), reversed(cfg["widths"])):
        s *= 4
        rows.append((f"up{i}", 2 * 9 * s * c * w // 4, eb * (s // 4 * c + s * w)))
        conv(f"dec{i}_1", s, 2 * w, w)
        conv(f"dec{i}_2", s, w, w)
        c = w
    conv("head", s, c, cfg["num_classes"], k=1)
    rows.append(("epilogue", 0, s * cfg["num_classes"] * (4 + 4) + s * 4))  # float32 softmax, quantize, argmax
    return rows


def flops(rows: List[Row]) -> int:
    return sum(f for _, f, _ in rows)


def floor_s(rows: List[Row], peak_flops: float, peak_bw: float) -> float:
    """The least time: each layer's max of FLOPs / peak and bytes / bandwidth."""
    return sum(max(f / peak_flops, b / peak_bw) for _, f, b in rows)


def patch_count(h: int, w: int, overlap: int = 25, scw: int = 256) -> int:
    """metaseg's overlap patches of an (h, w) image (src/image_tools.py:156-178)."""
    spw = scw - 2 * overlap
    qh, rh = divmod(h - 2 * overlap, spw)
    qw, rw = divmod(w - 2 * overlap, spw)
    return (qh + (rh > 0)) * (qw + (rw > 0))
