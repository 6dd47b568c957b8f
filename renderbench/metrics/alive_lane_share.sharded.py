"""alive_lane_share.sharded: the share of the bounce lanes that carried
a live path over the whole image in the sharded driver's cells: every
rank's ``alive_lanes`` counter summed over every rank's ``lanes``
counter (``alive_lane_share``'s quantity), from the ranks' totals that
the port's report on a mesh gathers (``ranks``), in the program's traced
run of its own (renderbench/program.py)."""

from renderbench import program


def read(ctx):
    if ctx["driver"] != "sharded":
        return None
    got = program.report(ctx)
    if got is None:
        return None
    every = got["window"].get("ranks")
    if not every:
        return None
    lanes = sum(r["lanes"] for r in every)
    if not lanes:
        return None
    return sum(r["alive_lanes"] for r in every) / lanes
