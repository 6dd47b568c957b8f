"""The bench's config-5 stage: the port's counterpart of the JAX repo's
``scripts/bench_config5.py``.

    python3 -m elevenrender_tpu_torch.bench_config5 [--device cuda]

``scene/demo.py textured_heightfield_scene(grid=BENCH_GRID5, res=BENCH_RES)``
(999,698 tris at grid 708: a bilinear checker albedo map, a flat normal
map, the HDRI sky and one point light), native mode, without
``bench.py``'s A/B knobs (``BENCH_ORDER``, ``BENCH_DIRMAJOR``,
``BENCH_SHADOW_SUB``), as the JAX stage reads none of them:

- forward: ``render/dispatch.render_samples_jit(..., 1)``, one sample a
  call, ``BENCH_C5_STEPS`` samples;
- alive fraction: ``count_rays=True`` over one sample, read after it;
- fwd+bwd: ``render/grad.fwd_bwd_step_accum`` over ``BENCH_C5_GRAD_SPP``
  samples, ``chunk=1``, with ``remat_bounces=True`` (each bounce
  recomputed in the backward pass, as the JAX stage runs it).

Timed as ``bench.py`` times (one warm-up call, ``bench.REPS`` timed
repetitions, the median; ``config5_spread`` [slowest, fastest]).
Prints ONE JSON line; ``bench.py`` runs this in a subprocess and folds
the line into its ``extra``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from .bench import rates, timed


def main(device="cuda") -> dict:
    """Run the stage on ``device``, print the line and return it."""
    from .render.dispatch import graph_device, render_samples_jit
    from .render.grad import fwd_bwd_step_accum
    from .render.integrator import init_state, resolve_trace_mode
    from .scene.demo import textured_heightfield_scene

    dev = graph_device(device)
    res = int(os.environ.get("BENCH_RES", "1024"))
    grid = int(os.environ.get("BENCH_GRID5", "708"))
    steps = int(os.environ.get("BENCH_C5_STEPS", "2"))
    grad_spp = int(os.environ.get("BENCH_C5_GRAD_SPP", "2"))

    _, config, ir = textured_heightfield_scene(grid=grid, res=res,
                                               compat=False, device=dev)
    n_tris = int(ir["tris"]["verts"].shape[0])
    mode = resolve_trace_mode(config, ir)
    rays_per_sample = 2.0 * config.max_bounces * res * res
    spread = {}

    # ---- fwd, 1 sample per call -----------------------------------------
    state = render_samples_jit(config, ir, init_state(config, dev), 1,
                               device=dev)

    def forward():
        nonlocal state
        for _ in range(steps):
            state = render_samples_jit(config, ir, state, 1, device=dev)

    fwd_rate, spread["config5_rays_per_sec"] = rates(
        rays_per_sample * steps, timed(forward, dev))
    print(f"[c5] fwd {fwd_rate:.0f} rays/s "
          f"({rays_per_sample / fwd_rate * 1e3:.1f} ms/sample, mode={mode})",
          file=sys.stderr, flush=True)

    # ---- alive accounting -----------------------------------------------
    cfg_count = config.replace(count_rays=True)
    st = render_samples_jit(cfg_count, ir, init_state(cfg_count, dev), 1,
                            device=dev)
    alive_fraction = float(st["ray_count"]) / rays_per_sample
    del state, st

    # ---- fwd+bwd accumulated, chunk=1, each bounce recomputed -----------
    config = config.replace(remat_bounces=True)
    target = torch.zeros((res * res, 3), device=dev)

    def accum():
        return fwd_bwd_step_accum(config, ir, target, grad_spp, chunk=1,
                                  device=dev)

    loss, grads = accum()  # the warm-up and the captures
    if not (torch.isfinite(loss)
            and torch.isfinite(grads["materials"]["albedo"]).all()):
        raise RuntimeError("config 5 fwd_bwd_step_accum: the loss or the "
                           "albedo gradient is not finite")
    bwd_rate, spread["config5_fwd_bwd_rays_per_sec"] = rates(
        rays_per_sample * grad_spp, timed(accum, dev))
    print(f"[c5] fwd+bwd {bwd_rate:.0f} rays/s", file=sys.stderr, flush=True)

    line = {
        "config5_tris": n_tris,
        "config5_trace_mode": mode,
        "config5_rays_per_sec": round(fwd_rate, 1),
        "config5_fwd_bwd_rays_per_sec": round(bwd_rate, 1),
        "config5_ms_per_sample": round(rays_per_sample / fwd_rate * 1e3, 1),
        "config5_alive_fraction": round(alive_fraction, 4),
        "config5_alive_rays_per_sec": round(fwd_rate * alive_fraction, 1),
        "config5_spread": {k: [round(x, 1) for x in v]
                           for k, v in spread.items()},
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
