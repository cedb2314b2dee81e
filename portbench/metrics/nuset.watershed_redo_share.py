"""Watersheds recomputed by the host flood (their certificate was not clean; ``runtime/fallbacks``) over the window's images, in %; only where the watershed ran."""


def read(ctx):
    if not ctx["stages"].get("stat_fish.watershed"):
        return None
    return 100.0 * ctx["fallbacks"].get("fast_watershed_host_recompute", 0) / ctx["images"]
