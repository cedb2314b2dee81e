"""Self time of the program's ``stat_fish.decode_wait`` stage (the main thread's wait on the reader threads that decode the next images), ms an image."""


def read(ctx):
    t = ctx["stages"].get("stat_fish.decode_wait")
    return 1e3 * sum(t) / ctx["images"] if t else None
