"""kernels_per_spp.progressive: device operations (kernels, copies, sets) in
the traced unit's trace per sample it rendered, in the progressive driver's
cells."""


def read(ctx):
    s = ctx["summary"]
    if ctx["driver"] != "progressive" or not s["launches"]:
        return None
    return s["launches"] / ctx["units"]
