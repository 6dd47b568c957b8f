"""span.shade_ms_per_spp: device ms per progressive sample in the
self time of the program's ``bounce`` spans: the bounce less its
traversal, sorts, hit data and shadow rays, that is the RNG draws, the
environment NEE, the Disney sample, eval and pdf, MIS and the path
update (render/integrator.py, ops/disney.py, ops/hdri.py).  From the
program's own stamps (renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "progressive":
        return None
    return program.per_sample(ctx, "bounce", "self_ms")
