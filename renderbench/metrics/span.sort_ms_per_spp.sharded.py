"""span.sort_ms_per_spp.sharded: rank 0's device ms per sample inside
the program's ``sort`` span (``span.sort_ms_per_spp``'s quantity: the
per-bounce ray sorts and the permutations around them), on its slice of
the image, in the sharded driver's cells.  From the program's own stamps
in a traced run of its own (renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "sharded":
        return None
    return program.per_sample(ctx, "sort")
