"""gather_ms_per_spp: device ms per progressive sample in the gather
and scatter kernel family (renderbench/trace.group): texture, material,
triangle and light rows fetched by index."""


def read(ctx):
    s = ctx["summary"]
    if ctx["driver"] != "progressive" or "gather" not in s["by_group"]:
        return None
    return s["by_group"]["gather"] * 1e3 / ctx["units"]
