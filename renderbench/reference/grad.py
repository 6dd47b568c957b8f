"""The plain reference of the inverse cell: the same optimiser steps on
the albedo, by autograd straight through the reference's render.

Each step renders every pixel ``samples_per_step`` times from the start
of its streams (``render.sample_radiance``), takes the progressive mean,
the loss ``mean((image - target)^2)`` and its gradient by
``torch.autograd.grad`` through all the samples at once, pixel block by
pixel block (each pixel's samples depend on that pixel alone), masks it
to the material row, and steps Adam: a frozen copy, as of the
benchmark's first version, of ``elevenrender_tpu_torch/inverse_demo.Adam``
(optax's ``adam`` in its order of operations), then the clip to [0, 1].
The ray casting of a pixel's samples does not depend on the material
table, so the reference casts them in the first step and reuses its own
results in the later ones.
"""

from __future__ import annotations

import numpy as np
import torch

from . import render
from .vec import init_rng

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, lr: float, p):
        self.lr = lr
        self.mu = torch.zeros_like(p)
        self.nu = torch.zeros_like(p)
        self.count = 0

    def step(self, p, g):
        self.count += 1
        self.mu = (1 - B1) * g + B1 * self.mu
        self.nu = (1 - B2) * (g * g) + B2 * self.nu
        one = np.float32(1)
        bc1 = float(one - np.float32(B1) ** self.count)
        bc2 = float(one - np.float32(B2) ** self.count)
        return p + (-self.lr) * ((self.mu / bc1)
                                 / (torch.sqrt(self.nu / bc2) + EPS))


def loss_and_grad(ref, albedo, target, n_samples, block, casts, q=None,
                  fault=None):
    """(loss, d loss / d albedo) of the n-sample progressive mean over
    every pixel.  ``casts`` (a dict, filled on first use): each block's
    ray-casting results per sample.  ``fault(block start, radiance)``
    plants a fault: it returns the radiance altered, or None to leave
    the block out of the loss (the mean taken over the rest)."""
    q = q or (lambda x: x)
    dev = target.device
    npix = target.shape[0]
    rest = ref["table"][:, 3:]
    total = torch.zeros((), dtype=torch.float64, device=dev)
    grad = torch.zeros_like(albedo)
    counted = 0
    for s in range(0, npix, block):
        pix = torch.arange(s, min(s + block, npix), device=dev)
        leaf = albedo.detach().clone().requires_grad_()
        table = torch.cat([leaf, rest], dim=1)
        with torch.enable_grad():
            passes = torch.zeros((render.PASSES, pix.shape[0], 3), device=dev)
            samples = torch.zeros(pix.shape[0], dtype=torch.int64, device=dev)
            rng = init_rng(pix)
            skip = False
            for i in range(n_samples):
                rec = casts.get((s, i))
                light, ok, aov, rng, cast = render.sample_radiance(
                    ref, rng, pix, q, table, rec)
                if rec is None:
                    casts[(s, i)] = {k: v for k, v in cast.items()
                                     if v and v[0] is not None}
                if fault is not None:
                    light = fault(s, light)
                    if light is None:
                        skip = True
                        break
                passes, samples = render.accumulate(passes, samples, light,
                                                    ok, aov)
            if skip:
                continue
            se = ((q(passes[0]) - target[s:s + block]) ** 2).sum()
            g, = torch.autograd.grad(se, leaf)
        total += se.detach().double()
        grad += g
        counted += pix.shape[0]
    n = counted * 3
    return float(total / n), grad / n


def descend(run, steps: int, q=None, fault=None, tail=None) -> dict:
    """The first ``steps`` steps from the configuration's albedo:
    {"losses", "grad1" [leaves], "change" [leaves]}.  With ``tail`` (a
    run's later steps: {"start": the albedo and Adam's state before them,
    "losses": one a step}), also those steps from that start, under
    "tail": {"losses", "change" [leaves]}."""
    mix = run["mix"]
    ref = render.prepare(run["raw"], run["device"], q)
    albedo = ref["table"][:, 0:3].clone()
    start = albedo.clone()
    mask = torch.zeros_like(albedo)
    mask[mix["row"]] = 1.0
    opt = Adam(mix["lr"], albedo)
    casts, losses, grad1 = {}, [], None
    for i in range(steps):
        loss, g = loss_and_grad(ref, albedo, run["target"],
                                mix["samples_per_step"],
                                mix["reference_block"], casts, q, fault)
        g = g * mask
        if i == 0:
            grad1 = g.clone()
        albedo = torch.clamp(opt.step(albedo, g), 0.0, 1.0)
        losses.append(loss)
    out = {"losses": losses, "grad1": [grad1.cpu()],
           "change": [(albedo - start).cpu()]}
    if tail is not None:
        dev = run["device"]
        first = tail["start"]
        albedo = first["albedo"].to(dev)
        start = albedo.clone()
        opt = Adam(mix["lr"], albedo)
        opt.mu, opt.nu = first["mu"].to(dev), first["nu"].to(dev)
        opt.count = first["count"]
        later = []
        for _ in tail["losses"]:
            loss, g = loss_and_grad(ref, albedo, run["target"],
                                    mix["samples_per_step"],
                                    mix["reference_block"], casts, q, fault)
            albedo = torch.clamp(opt.step(albedo, g * mask), 0.0, 1.0)
            later.append(loss)
        out["tail"] = {"losses": later, "change": [(albedo - start).cpu()]}
    return out
