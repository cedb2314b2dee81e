"""Useful forward FLOPs (transpose convs at 9/4 taps) of the window's patches, over the window, over the float32 peak, in %."""

from portbench import arith


def read(ctx):
    p = arith.peaks(ctx["device_name"])
    if p is None:
        return None
    work = arith.flops(ctx["rows"]) * ctx["patches_per_image"] * ctx["images"]
    return 100.0 * work / ctx["window_s"] / p[ctx["cfg"]["dtype"]]
