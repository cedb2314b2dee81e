"""Useful FLOPs of NuSeT's step (both U-Net passes with transpose convs at 9/4 taps, and the RPN head) of the window's
images, over the window, over the float32 peak, in %."""

from portbench import arith


def read(ctx):
    p = arith.peaks(ctx["device_name"])
    if p is None or "nuset_flops_per_image" not in ctx:
        return None
    return 100.0 * ctx["nuset_flops_per_image"] * ctx["images"] / ctx["window_s"] / p[ctx["cfg"]["dtype"]]
