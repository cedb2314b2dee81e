"""Self time of the program's ``nuset.prep`` stage (NuSeT's prep: the 8-bit DAPI channel to the card, the anti-aliased rescale, the crop, the whole-image norm), ms an image."""


def read(ctx):
    t = ctx["stages"].get("nuset.prep")
    return 1e3 * sum(t) / ctx["images"] if t else None
