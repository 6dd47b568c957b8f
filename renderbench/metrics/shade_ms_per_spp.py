"""shade_ms_per_spp: device ms per progressive sample outside the
traversal, sort and gather kernel families (renderbench/trace.group):
the wavefront's elementwise shading, sampling and reductions."""

OUTSIDE = ("traversal", "sort", "gather")


def read(ctx):
    s = ctx["summary"]
    if ctx["driver"] != "progressive" or not s["launches"]:
        return None
    sec = sum(v for g, v in s["by_group"].items() if g not in OUTSIDE)
    return sec * 1e3 / ctx["units"]
