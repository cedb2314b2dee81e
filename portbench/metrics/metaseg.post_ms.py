"""Self time of the program's ``metaseg.post`` stage (the device post, the blob's copy and host decode), ms an image."""


def read(ctx):
    t = ctx["stages"].get("metaseg.post")
    return 1e3 * sum(t) / ctx["images"] if t else None
