"""span.image_gather_ms: rank 0's device ms a whole-image readback in
the port's ``gather`` span (the readback's collectives and the joining
of the slices, ``Renderer.read_image`` on a mesh) over its ``gathers``
counter, in the program's traced run of its own
(renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "sharded":
        return None
    got = program.report(ctx)
    if got is None:
        return None
    win = got["window"]
    n = win["counters"].get("gathers")
    rec = win["spans"].get("gather", {})
    if not n or "device_ms" not in rec:
        return None
    return rec["device_ms"] / n
