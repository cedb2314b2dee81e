"""The forward's share of its roofline: each layer's least time (max of FLOPs over the float32 peak and bytes over the
bandwidth), summed over the window's patches, over the ``metaseg.forward`` self time, in %."""

from portbench import arith


def read(ctx):
    t = ctx["stages"].get("metaseg.forward")
    if not t:
        return None
    p = arith.peaks(ctx["device_name"])
    if p is None:
        return None
    floor = arith.floor_s(ctx["rows"], p[ctx["cfg"]["dtype"]], p["hbm_bytes_per_s"])
    return 100.0 * floor * ctx["patches_per_image"] * ctx["images"] / sum(t)
