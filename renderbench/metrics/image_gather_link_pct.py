"""image_gather_link_pct: the readback gather's share of its roofline,
in %: the least time of one whole-image readback's bytes over the link
(renderbench/linkcount.py: what rank 0 receives, at an H100 SXM's
NVLink bandwidth in one direction) over ``span.image_gather_ms``."""

from renderbench import linkcount, manifest, program

PASSES = 5  # beauty, normal, tangent, bitangent, the denoiser's albedo


def read(ctx):
    if ctx["driver"] != "sharded":
        return None
    got = program.report(ctx)
    ms = manifest.reader("span.image_gather_ms")(ctx)
    if got is None or not ms:
        return None
    ranks = got["window"]["counters"].get("ranks")
    if not ranks:
        return None
    raw = ctx["raw"]
    least = linkcount.least_seconds(ranks, PASSES,
                                    raw["x_res"] * raw["y_res"])
    return 100.0 * least / (ms / 1e3)
