"""Self time of the program's ``nuset.forward`` stage (each U-Net pass with its argmax and its 1-bit mask's fetch; two an image), ms an image."""


def read(ctx):
    t = ctx["stages"].get("nuset.forward")
    return 1e3 * sum(t) / ctx["images"] if t else None
