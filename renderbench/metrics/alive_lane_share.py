"""alive_lane_share: the share of the bounce lanes the program launched
that carried a live path: its ``alive_lanes`` counter (a device sum of
each bounce's alive mask, the sum ``count_rays`` adds) over its
``lanes`` counter (the lanes of each bounce launched), over the
progressive samples of the program's traced run of its own
(renderbench/program.py).  Compacting the wavefront would raise it."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "progressive":
        return None
    got = program.report(ctx)
    if got is None:
        return None
    counters = got["window"]["counters"]
    if not counters.get("lanes") or "alive_lanes" not in counters:
        return None
    return counters["alive_lanes"] / counters["lanes"]
