"""idle_pct.sharded: the share of the traced unit's span on rank 0's
device (its first operation's start to its last one's end) in which no
operation ran, in the sharded driver's cells: 100 - 100 x (the union of
the device events' intervals) / (the span).  The unit ends in the
completion mark's all-reduce, which runs on the device until the
slowest rank's sample is done, so rank 0's wait for the other bands
counts as busy here; ``rank_balance`` reads that wait."""


def read(ctx):
    s = ctx["summary"]
    if ctx["driver"] != "sharded" or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
