"""The device's idle time in the profiled stretch while the host was in the program's ``metaseg.post`` stage or one of its ``metaseg.post.*`` ranges (the device post, the host decode), ms an image of the stretch."""

NAME = "metaseg.post"


def read(ctx):
    p = ctx["profile"]
    if not p:
        return None
    return 1e3 * sum(s for name, s in p["idle_gaps"] if name == NAME or name.startswith(NAME + ".")) / p["images"]
