"""kernels_per_spp.inverse: device operations (kernels, copies, sets) in
the traced unit's trace per sample it rendered, in the inverse driver's
cells."""


def read(ctx):
    s = ctx["summary"]
    if ctx["driver"] != "inverse" or not s["launches"]:
        return None
    return s["launches"] / ctx["units"]
