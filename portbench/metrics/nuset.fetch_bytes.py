"""Bytes the program copied from the card to the host in the window (``ops/packing.fetch``'s count: the masks, the NMS's
suppression matrix, the proposals), an image; only where the NuSeT passes ran."""


def read(ctx):
    if not ctx["stages"].get("nuset.forward") or not ctx["fetch"]["copies"]:
        return None
    return ctx["fetch"]["bytes"] / ctx["images"]
