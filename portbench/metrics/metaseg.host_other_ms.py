"""The main thread's window time outside every program stage (the wait on the reader threads, the bucketing), ms an image."""


def read(ctx):
    if not ctx["stages"]:
        return None
    inside = sum(sum(t) for t in ctx["stages"].values())
    return 1e3 * (ctx["window_s"] - inside) / ctx["images"]
