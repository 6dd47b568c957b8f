"""span.hitdata_ms_per_spp: device ms per progressive sample inside the
program's ``hitdata`` span: the hit's triangle rows and the hit itself
(ops/intersect.py), its material rows and its texture taps
(ops/texture.py), the normal map and the albedo shaders
(render/integrator.py _generate_hitdata).  From the program's own
stamps (renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "progressive":
        return None
    return program.per_sample(ctx, "hitdata")
