"""The operations and bytes of NuSeT's step, counted from its published
shapes as ``arith.py`` counts metaseg's: a k x k 'SAME' conv is 2 * k * k
* S * Cin * Cout FLOPs; a stride-2 3x3 transpose conv 9/4 multiply-adds an
output pixel; bytes are each layer's input read once and output written
once at the configuration's element size.

An image is two U-Net passes at the prep's shape (the input rescaled by
``scale_ratio`` and cropped to multiples of 16: 608^2 at 2048^2 and 0.3)
and one RPN head on the foreground pass's feature (1/16 of that side).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.arith import ELEM_BYTES, Row, flops


def prep_shape(h: int, w: int, scale: float) -> Tuple[int, int]:
    """The U-Net's input shape: the rescale's rounding, then the crop to /16."""
    return tuple(max(int(round(d * scale)), 1) // 16 * 16 for d in (h, w))


def unet_rows(cfg: Dict, h: int, w: int, tag: str = "") -> List[Row]:
    """One U-Net pass on an (h, w) input, with its argmax to a mask."""
    eb = ELEM_BYTES[cfg["dtype"]]
    s, c = h * w, cfg["in_channels"]
    rows: List[Row] = []

    def conv(name, s, cin, cout, k=3):
        rows.append((tag + name, 2 * k * k * s * cin * cout, eb * s * (cin + cout)))

    widths, n = cfg["widths"], len(cfg["widths"])
    for i, wd in enumerate(widths, 1):
        conv(f"conv{i}-1", s, c, wd)
        conv(f"conv{i}-2", s, wd, wd)
        rows.append((f"{tag}pool{i}", 0, eb * (s + s // 4) * wd))
        c, s = wd, s // 4
    conv("conv5-1", s, c, cfg["bottleneck"])
    conv("conv5-2", s, cfg["bottleneck"], cfg["bottleneck"])
    c = cfg["bottleneck"]
    for i, wd in zip(range(n, 0, -1), reversed(widths)):
        s *= 4
        rows.append((f"{tag}deconv{i}", 2 * 9 * s * c * wd // 4, eb * (s // 4 * c + s * wd)))
        conv(f"conv{i}-3", s, wd if (i == n and not cfg["level4_skip"]) else 2 * wd, wd)
        conv(f"conv{i}-4", s, wd, wd)
        c = wd
    conv("final", s, c, cfg["num_classes"])
    rows.append((tag + "argmax", 0, s * (eb * cfg["num_classes"] + 1)))  # the logits read, a bool mask written
    return rows


def rpn_rows(cfg: Dict, h: int, w: int) -> List[Row]:
    """The RPN head on the (h/16, w/16) feature of an (h, w) input."""
    eb = ELEM_BYTES[cfg["dtype"]]
    s, c, r = (h // 16) * (w // 16), cfg["widths"][-1], cfg["rpn_width"]
    a = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    return [("rpn_conv", 2 * 9 * s * c * r, eb * s * (c + r)),
            ("rpn_cls_score", 2 * s * r * 2 * a, eb * s * (r + 2 * a)),
            ("rpn_bbox_pred", 2 * s * r * 4 * a, eb * s * (r + 4 * a))]


def forward_rows(cfg: Dict, h: int, w: int) -> List[Row]:
    """Both passes of an image, as the stage ``nuset.forward`` runs them."""
    return unet_rows(cfg, h, w, "whole.") + unet_rows(cfg, h, w, "fg.")


def image_flops(cfg: Dict, h: int, w: int) -> int:
    """Both passes and the RPN head of an image at the U-Net's input (h, w)."""
    return flops(forward_rows(cfg, h, w)) + flops(rpn_rows(cfg, h, w))
