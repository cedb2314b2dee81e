"""Bytes the program copied from the card to the host in the window (``ops/packing.fetch``'s count), an image."""


def read(ctx):
    return ctx["fetch"]["bytes"] / ctx["images"] if ctx["fetch"]["copies"] else None
