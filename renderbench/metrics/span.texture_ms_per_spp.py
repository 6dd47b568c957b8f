"""span.texture_ms_per_spp: device ms per progressive sample inside the
program's ``hitdata.texture`` span: the texture taps of the mapped
slots and the normal map (ops/texture.py sample_filtered,
sample_nearest).  From the program's own stamps
(renderbench/program.py); a scene without textures has no such span."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "progressive":
        return None
    return program.per_sample(ctx, "hitdata.texture")
