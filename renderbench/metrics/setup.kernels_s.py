"""setup.kernels_s: host seconds of the set-up in the program's
``kernels.build`` and ``kernels.load`` spans: compiling the kernel
libraries that are not built yet and loading them (kernels.py), in the
program's traced run of its own (renderbench/program.py), a fresh
process on the same cell and seed.  That run comes after the run's own
set-up, which builds what is missing, so it reads the loads of built
libraries."""

from renderbench import program


def read(ctx):
    got = program.report(ctx)
    if got is None:
        return None
    spans = got["setup"]["spans"]
    return sum(spans.get(k, {}).get("host_s", 0.0)
               for k in ("kernels.build", "kernels.load"))
