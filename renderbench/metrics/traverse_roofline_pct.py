"""traverse_roofline_pct: the least time of a sample's traversal over
the device time of the traversal kernels in the traced sample, in %.

The least time (renderbench/walkcount.py) is the larger of the fp32
operations over 67 TFLOP/s and the bytes over 3.35 TB/s that a plain
binary walk of a binned-SAH tree needs for the rays a sample casts: the
reference's own first sample over every STRIDE-th pixel each way, its
path rays while alive (closest hit) and its shadow rays where the
next-event estimate needs them (any hit), scaled to the whole image.
The peaks are an H100 SXM's at 700 W.  The walk's counts a ray go to
standard error."""

import json
import sys

from renderbench import walkcount


def read(ctx):
    s = ctx["summary"]
    trav = s["by_group"].get("traversal")
    if ctx["driver"] != "progressive" or not trav:
        return None
    raw = ctx["raw"]
    closest, any_hit, scale = walkcount.rays_of_a_sample(raw, ctx["device"])
    tree = walkcount.sah_tree(raw["mesh"]["verts"], ctx["device"])
    walks = {"closest": walkcount.count(tree, *closest),
             "any_hit": walkcount.count(tree, *any_hit)}
    least = walkcount.least_seconds(walks["closest"], walks["any_hit"],
                                    scale, 2 * max(raw["bounces"], 1))
    per_ray = {k: {n: w[n] / max(w["rays"], 1)
                   for n in ("visits", "leaves", "tests")} | {"rays": w["rays"]}
               for k, w in walks.items()}
    print(f"traverse walk: {json.dumps(per_ray)}; least "
          f"{json.dumps({k: least[k] for k in ('seconds', 'by')})}",
          file=sys.stderr)
    return 100.0 * least["seconds"] / (trav / ctx["units"])
