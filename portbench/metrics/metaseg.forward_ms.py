"""Self time of the program's ``metaseg.forward`` stage (patches to the card, the float32 U-Net, quantize and argmax), ms an image."""


def read(ctx):
    t = ctx["stages"].get("metaseg.forward")
    return 1e3 * sum(t) / ctx["images"] if t else None
