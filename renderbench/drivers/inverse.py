"""The inverse-rendering driver: whole optimiser steps on a material's
albedo, one after another.

A step is the port's two-pass accumulated gradient,
``render/grad.render_loss_and_grad_accum`` (``samples_per_step``
samples at ``chunk``, every sample from the same streams, as each step
of ``inverse_demo.albedo_stage(accum=True)``), the gradient masked to
material row ``row``, one step of ``inverse_demo.Adam`` at ``lr`` and a
clip to [0, 1].  The target image is the harness's, drawn on the card
from the seed.  Set-up builds the optimiser and runs the first
``checked_steps`` steps through the same call (the first one warms up
and captures the gradient path's graphs); they are the steps the
reference follows from the start.  The window then runs whole steps
with at most ``in_flight`` queued; before each, it keeps a copy of the
parameters and the optimiser's state (made on the card, in the stream's
order), so that the reference can follow the window's last
``window_checked_steps`` steps from the program's state before them.

- ``grad_spp_per_s``: the accumulated samples of the steps completed in
  the window over the host-clock seconds from the first step's
  queueing to the last one's completion.
"""

from __future__ import annotations

import time
from collections import deque

import torch

from .. import check
from ..clock import Mark, sync


def target(run) -> torch.Tensor:
    """The target image [npix, 3], uniform in [low, high) from the
    seed, made on the card."""
    spec = run["mix"]["target"]
    npix = run["raw"]["x_res"] * run["raw"]["y_res"]
    gen = torch.Generator(device=run["device"])
    gen.manual_seed(run["seed"])
    img = torch.rand((npix, 3), generator=gen, device=run["device"])
    return img * (spec["high"] - spec["low"]) + spec["low"]


def setup(run) -> dict:
    from elevenrender_tpu_torch.inverse_demo import Adam
    mix = run["mix"]
    run["target"] = target(run)
    albedo = run["ir"]["materials"]["albedo"]
    mask = torch.zeros_like(albedo)
    mask[mix["row"]] = 1.0
    params = {"materials": {"albedo": albedo.clone()}}
    st = {"opt": Adam(mix["lr"], params), "params": params, "mask": mask,
          "start": albedo.clone(), "losses": []}
    for i in range(mix["checked_steps"]):
        st["losses"].append(step(st, run))
        if i == 0:
            st["grad1"] = (st["opt"].mu["materials"]["albedo"]
                           / (1 - st["opt"].B1)).clone()
    st["after"] = st["params"]["materials"]["albedo"].clone()
    sync(run["device"])
    return st


def step(st, run):
    from elevenrender_tpu_torch.render import grad as grad_mod
    mix = run["mix"]
    loss, grads = grad_mod.render_loss_and_grad_accum(
        run["config"], run["ir"], st["params"], run["target"],
        mix["samples_per_step"], chunk=mix["chunk"], device=run["device"])
    masked = {"materials": {"albedo": grads["materials"]["albedo"]
                            * st["mask"]}}
    params = st["opt"].step(st["params"], masked)
    params["materials"]["albedo"] = torch.clamp(
        params["materials"]["albedo"], 0.0, 1.0)
    st["params"] = params
    return loss


def snapshot(st) -> dict:
    """The parameters and the optimiser's state before a step."""
    opt = st["opt"]
    return {"albedo": st["params"]["materials"]["albedo"].clone(),
            "mu": opt.mu["materials"]["albedo"].clone(),
            "nu": opt.nu["materials"]["albedo"].clone(),
            "count": opt.count}


def window(st, run, seconds: float) -> dict:
    depth = run["mix"]["in_flight"]
    dev = run["device"]
    done = []
    tail = deque(maxlen=run["mix"]["window_checked_steps"])
    sync(dev)
    t0 = time.perf_counter()
    while True:
        if len(done) >= depth:
            done[-depth].synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        before = snapshot(st)
        tail.append((before, step(st, run)))
        done.append(Mark(dev).record())
    sync(dev)
    st["tail"] = list(tail)
    elapsed = time.perf_counter() - t0
    n = run["mix"]["samples_per_step"]
    return {"attempted": len(done), "failed": 0,
            "metrics": {"grad_spp_per_s": len(done) * n / elapsed},
            "notes": {"steps": len(done), "window_s": elapsed}}


def outputs(st, run) -> dict:
    first = st["tail"][0][0]
    return {"steps": run["mix"]["checked_steps"],
            "losses": [float(x) for x in st["losses"]],
            "grad1": [st["grad1"].cpu()],
            "change": [(st["after"] - st["start"]).cpu()],
            "tail": {"start": {k: v.cpu() if torch.is_tensor(v) else v
                               for k, v in first.items()},
                     "losses": [float(x) for _, x in st["tail"]],
                     "change": [(st["params"]["materials"]["albedo"]
                                 - first["albedo"]).cpu()]}}


def unit(st, run):
    """One traced unit: one whole step."""
    return (lambda: step(st, run)), run["mix"]["samples_per_step"]


def release(st) -> None:
    st.clear()


def judge(run, out) -> tuple:
    return check.inverse(run, out)
