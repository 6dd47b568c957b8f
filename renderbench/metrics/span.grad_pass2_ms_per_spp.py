"""span.grad_pass2_ms_per_spp: device ms per accumulated sample inside
the program's ``grad.pass2`` span: pass 2 of the two-pass gradient, each
sample's forward again from its record and its vector-Jacobian product
(render/grad.py _accum_bwd_chunked), over the samples pass 1 rendered.
From the program's own stamps (renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "inverse":
        return None
    return program.per_sample(ctx, "grad.pass2")
