"""rank_balance: how evenly the pixel mesh's ranks share a sample's
work: the mean over the ranks of each rank's ``sample`` span device ms
a sample over the slowest rank's, from every rank's totals that the
port's report on a mesh gathers (``ranks``), in the program's traced run
of its own (renderbench/program.py).  1 when every rank's slice costs
the same; the whole image waits for the slowest."""

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
    per = [r["sample"]["device_ms"] / r["sample"]["device_count"]
           for r in every if r["sample"]["device_count"]]
    if len(per) != len(every) or not max(per):
        return None
    return sum(per) / len(per) / max(per)
