"""How ``correct`` is decided: the timed path's outputs against the
plain reference (``renderbench/reference``), number by number, each
against the cell's limit (``renderbench/limits/<cell>.json``).

Progressive cells.  ``check_pixels`` pixels drawn from the seed; for
each, its gap: the largest, over the five passes and three channels, of
|program - reference| / max(|reference|, FLOOR), and infinite where the
two sample counts differ.  Compared: ``pixels_off_share``, the share of
those pixels whose gap passes ``PIXEL_TOL``, and ``gap_p90``, the gaps'
90th percentile.

Inverse cells.  The loss of each of the first ``checked_steps`` steps,
the first gradient as Adam got it (its first moment after one step over
1 - b1) and the parameters' change over those steps, each against the
reference's; and the loss of each of the window's last
``window_checked_steps`` steps and the change over them, against the
reference's steps from the program's parameters and optimiser state
before them: ``loss_gap`` the largest relative gap of a step's loss,
``grad_norm_gap`` and ``update_norm_gap`` the gap between the two norms
of the worst leaf (of either change), over the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of the change.
"""

from __future__ import annotations

import numpy as np
import torch

FLOOR = 1e-3
PIXEL_TOL = 1e-5


def pixels(run) -> torch.Tensor:
    """The checked pixels, drawn from the seed, in increasing order."""
    x_res, y_res = run["raw"]["x_res"], run["raw"]["y_res"]
    rng = np.random.default_rng(run["seed"])
    pick = rng.choice(x_res * y_res, run["mix"]["check_pixels"],
                      replace=False)
    return torch.tensor(np.sort(pick), dtype=torch.int64)


def verdict(readings: dict, limits: dict) -> tuple:
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in readings.items()}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def pixel_readings(got_passes, got_samples, ref_passes, ref_samples) -> dict:
    gap = ((got_passes - ref_passes).abs()
           / ref_passes.abs().clamp(min=FLOOR)).amax(dim=(0, 2))
    gap = torch.where(got_samples == ref_samples, gap,
                      torch.full_like(gap, float("inf")))
    gap = torch.nan_to_num(gap, nan=float("inf"))
    return {"pixels_off_share": float((gap > PIXEL_TOL).float().mean()),
            "gap_p90": float(torch.quantile(gap.clamp(max=1e30), 0.9))}


def reference_pixels(run, pix, n_samples, q=None, fault=None):
    from .reference import render
    dev = run["device"]
    ref = render.prepare(run["raw"], dev, q)
    p, s = render.render_pixels(ref, pix.to(dev), n_samples, q, fault)
    return p.cpu(), s.cpu()


def progressive(run, out) -> tuple:
    # A pixel that did not take every sample the renderer ran is off
    # whatever its values; where those alone fail the limit, the
    # reference need not render (a step that does nothing would
    # otherwise leave it tens of thousands of samples to follow).
    short = float((out["samples"] != out["n_samples"]).float().mean())
    if short > run["limits"]["pixels_off_share"]:
        return verdict({"pixels_off_share": short, "gap_p90": float("inf")},
                       run["limits"])
    ref_p, ref_s = reference_pixels(run, out["pix"], out["n_samples"])
    return verdict(pixel_readings(out["passes"], out["samples"], ref_p,
                                  ref_s), run["limits"])


def _leaf_gaps(got: list, ref: list) -> float:
    """The worst leaf's gap between norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    norms = [float(r.norm()) for r in ref]
    median = float(np.median(norms))
    gaps = [abs(float(g.norm()) - n) / max(n, median, 1e-30)
            for g, n in zip(got, norms)]
    return max(gaps) if gaps else 0.0


def training_readings(got: dict, ref: dict) -> dict:
    """``got`` and ``ref``: {"losses": [...], "grad1": [leaves],
    "change": [leaves]}, and where both have it "tail": {"losses",
    "change"} of the window's last steps, whose gaps join the losses' and
    the changes' readings."""
    def loss_gap(a, b):
        return max((abs(g - r) / max(abs(r), 1e-30) for g, r in zip(a, b)),
                   default=0.0)

    g_norms = [float(x.norm()) for x in ref["grad1"]]
    median = float(np.median(g_norms))
    moved = [i for i, n in enumerate(g_norms) if n >= 1e-3 * median]

    def change_gap(a, b):
        return _leaf_gaps([a["change"][i] for i in moved],
                          [b["change"][i] for i in moved])

    loss = loss_gap(got["losses"], ref["losses"])
    update = change_gap(got, ref)
    if "tail" in got and "tail" in ref:
        loss = max(loss, loss_gap(got["tail"]["losses"],
                                  ref["tail"]["losses"]))
        update = max(update, change_gap(got["tail"], ref["tail"]))
    return {"loss_gap": loss,
            "grad_norm_gap": _leaf_gaps(got["grad1"], ref["grad1"]),
            "update_norm_gap": update}


def inverse(run, out) -> tuple:
    from .reference import grad
    ref = grad.descend(run, out["steps"], tail=out.get("tail"))
    return verdict(training_readings(out, ref), run["limits"])
