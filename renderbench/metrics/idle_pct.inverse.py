"""idle_pct.inverse: the share of the traced unit's span on the device
(its first operation's start to its last one's end) in which no
operation ran: 100 - 100 x (the union of the device events' intervals)
/ (the span), in the inverse driver's cells.  The session's edges, which
the timed window's next queued unit hides, are left out."""


def read(ctx):
    s = ctx["summary"]
    if ctx["driver"] != "inverse" or s["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
