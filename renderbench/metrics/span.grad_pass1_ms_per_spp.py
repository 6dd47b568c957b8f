"""span.grad_pass1_ms_per_spp: device ms per accumulated sample inside
the program's ``grad.pass1`` span: pass 1 of the two-pass gradient,
the forward samples replayed with their trace records
(render/grad.py _accum_fwd_chunked), over the samples it rendered.
From the program's own stamps (renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "inverse":
        return None
    return program.per_sample(ctx, "grad.pass1")
