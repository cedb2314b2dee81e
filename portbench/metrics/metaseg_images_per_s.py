"""Images whose labels and ecDNA count ``segment_folder`` yielded in the window, over the window's seconds."""


def read(ctx):
    return ctx["images"] / ctx["window_s"]
