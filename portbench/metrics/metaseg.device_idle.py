"""Share of the profiled steady stretch in which no device operation ran, in %."""


def read(ctx):
    p = ctx["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p else None
