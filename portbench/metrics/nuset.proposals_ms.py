"""Self time of the program's ``nuset.proposals`` stage (the anchor size, the RPN head, decode, the top-6000 sort, the
suppression matrix and its fetch, the greedy NMS, the clip), ms an image."""


def read(ctx):
    t = ctx["stages"].get("nuset.proposals")
    return 1e3 * sum(t) / ctx["images"] if t else None
