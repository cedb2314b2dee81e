"""Self time of the program's ``stat_fish.cleanup`` stage (clean_image, the resize back, the binarize, the small objects' removal, the mask's fetch; on stat_fish's watershed worker), ms an image."""


def read(ctx):
    t = ctx["stages"].get("stat_fish.cleanup")
    return 1e3 * sum(t) / ctx["images"] if t else None
