"""span.shade_ms_per_spp.sharded: rank 0's device ms per sample in the
self time of the program's ``bounce`` spans (``span.shade_ms_per_spp``'s
quantity: the bounce less its traversal, sorts, hit data and shadow
rays), on its slice of the image, in the sharded driver's cells.  From
the program's own stamps in a traced run of its own
(renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "sharded":
        return None
    return program.per_sample(ctx, "bounce", "self_ms")
