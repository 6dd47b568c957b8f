"""span.sort_ms_per_spp: device ms per progressive sample inside the
program's ``sort`` span: the per-bounce ray sorts (ops/sort.py) and the
permutations of the traced rays and their results
(render/integrator.py), wherever they nest.  From the program's own
stamps in a traced run of its own (renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "progressive":
        return None
    return program.per_sample(ctx, "sort")
