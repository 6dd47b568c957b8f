"""kernels_per_spp.sharded: device operations (kernels, copies, sets) in
the traced unit's trace per whole-image sample, in the sharded driver's
cells: rank 0's sample graph on its slice of the image, and the one
all-reduce of the harness's completion mark."""


def read(ctx):
    s = ctx["summary"]
    if ctx["driver"] != "sharded" or not s["launches"]:
        return None
    return s["launches"] / ctx["units"]
