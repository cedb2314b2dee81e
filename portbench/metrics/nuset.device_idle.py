"""Share of the profiled steady stretch in which no device operation ran, in %; only where the NuSeT passes ran."""


def read(ctx):
    p = ctx["profile"]
    if not p or "nuset_forward_rows" not in ctx:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
