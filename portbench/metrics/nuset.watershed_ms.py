"""Self time of the program's ``stat_fish.watershed`` stage (the marker watershed: the certified device pass, and the host flood where its certificate is not clean; on stat_fish's watershed worker beside the next image's passes), ms an image."""


def read(ctx):
    t = ctx["stages"].get("stat_fish.watershed")
    return 1e3 * sum(t) / ctx["images"] if t else None
