"""Set-up: process start to the window's first unit of work (weights, inputs, the program's objects, the warm-up)."""


def read(ctx):
    return ctx["setup_s"]
