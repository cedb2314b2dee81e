"""The U-Net passes' share of their roofline: each layer's least time (max of FLOPs over the float32 peak and bytes over
the bandwidth) of both passes, times the window's images, over the ``nuset.forward`` self time, in %."""

from portbench import arith


def read(ctx):
    t = ctx["stages"].get("nuset.forward")
    p = arith.peaks(ctx["device_name"])
    if not t or p is None or "nuset_forward_rows" not in ctx:
        return None
    floor = arith.floor_s(ctx["nuset_forward_rows"], p[ctx["cfg"]["dtype"]], p["hbm_bytes_per_s"])
    return 100.0 * floor * ctx["images"] / sum(t)
