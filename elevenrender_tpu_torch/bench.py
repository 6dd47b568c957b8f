"""Benchmark of the port: rays/s on one card, the JAX repo's ``bench.py``
read the same way.

    python3 -m elevenrender_tpu_torch.bench [--device cuda]

Prints ONE JSON line on stdout:

    {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
     "extra": {...}}

Stage lines go to stderr as they land, so a crash in a later stage does
not lose the earlier numbers.

A "ray" is one wavefront path or shadow segment: the lockstep integrator
launches ``2 * max_bounces`` rays per pixel per sample, masked lanes
included, so rays/s is ``2 * max_bounces * res**2 * samples / s``
whatever the scene does.  The stages, in ``bench.py``'s order, on
``scene/demo.py heightfield_scene(grid=BENCH_GRID, res=BENCH_RES)``
(65,522 tris at grid 182), native mode, 5 bounces:

- ``extra.fwd_rays_per_sec``: forward progressive sampling,
  ``render/dispatch.render_samples_jit`` in chunks of ``BENCH_CHUNK``
  samples (graph replays on a card), over ``BENCH_STEPS`` samples;
- ``extra.alive_rays_per_sec`` / ``alive_fraction``: the lanes that
  needed a trace result, counted by ``count_rays=True`` over 2 samples
  and read after the run;
- ``value``, the headline: ``render/grad.fwd_bwd_step_accum`` (render,
  MSE loss and material gradients by the two-pass accumulator) over
  ``BENCH_GRAD_SPP`` (default ``BENCH_SPP``, 64) samples in chunks of
  ``BENCH_ACCUM_CHUNK``;
- ``extra.fwd_bwd_1spp_rays_per_sec``: ``render_loss_and_grad`` at one
  sample, ``BENCH_GRAD_STEPS`` calls;
- ``extra.config5_*``: ``bench_config5`` (the 999,698-tri textured,
  lit scene) in a subprocess, folded in; ``config5_error`` when it
  fails.  ``BENCH_CONFIG5=0`` leaves it out.

``BENCH_ORDER`` (trace_order), ``BENCH_DIRMAJOR`` (sort_dir_major) and
``BENCH_SHADOW_SUB`` (shadow_pallas_sub) set the main scene's config as
``bench.py``'s A/B knobs do; the config-5 stage reads none of them, as
``scripts/bench_config5.py`` reads none.

Timing: every timed stage makes one warm-up call (which captures the
CUDA graphs), then ``REPS`` timed repetitions, each on the host clock
around work that ends in a device synchronisation; the median is the
number and ``extra.spread`` gives each stage's [slowest, fastest]
rays/s.  ``extra.device`` is the card's name and power limit
(``nvidia-smi``), or "cpu".

``vs_baseline`` is the headline over ``fwd_bwd_rays_per_sec`` in
``bench_baseline.json`` beside this module: the port's first full run
on the card, recorded with that card's name and power limit; 1.0 where
the file is absent.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import torch

# Timed repetitions of every stage, after its warm-up call.
REPS = 3

BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench_baseline.json")


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit`` prints them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device, reps: int = REPS) -> list:
    """Host-clock seconds of each of ``reps`` calls of ``fn``, each from
    a synchronised device to the end of its device work."""
    out = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        out.append(time.perf_counter() - t0)
    return out


def rates(work: float, seconds: list) -> tuple:
    """(median of ``work / s`` over the repetitions, [slowest,
    fastest])."""
    r = [work / s for s in seconds]
    return statistics.median(r), [min(r), max(r)]


def config5_stage(dev: torch.device) -> dict:
    """``bench_config5`` in a subprocess on ``dev``: its line's keys, or
    {"config5_error": why} when it fails."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "elevenrender_tpu_torch.bench_config5",
             "--device", str(dev)], cwd=root, capture_output=True,
            text=True, timeout=3600)
    except subprocess.TimeoutExpired as e:
        return {"config5_error": repr(e)[:200]}
    sys.stderr.write(proc.stderr)
    line = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode == 0 and line.startswith("{"):
        return json.loads(line)
    return {"config5_error": f"exit {proc.returncode}: {line[:200]}"}


def main_scene(dev: torch.device, res: int, spp: int, grid: int) -> dict:
    """The stages on the main path's scene, in ``bench.py``'s order:
    their numbers, with each timed stage's [slowest, fastest] rays/s
    under "spread".  The scene and its captures are freed on return."""
    from .render.dispatch import render_samples_jit
    from .render.grad import fwd_bwd_step, fwd_bwd_step_accum
    from .render.integrator import init_state
    from .scene.demo import heightfield_scene

    _, config, ir = heightfield_scene(grid=grid, res=res, spp=spp,
                                      compat=False, device=dev)
    # bench.py's A/B knobs, which its config-5 stage does not read.
    order = os.environ.get("BENCH_ORDER")
    if order:
        config = config.replace(trace_order=order)
    if os.environ.get("BENCH_DIRMAJOR"):
        config = config.replace(sort_dir_major=True)
    ssub = int(os.environ.get("BENCH_SHADOW_SUB", "0"))
    if ssub:
        config = config.replace(shadow_pallas_sub=ssub)
    rays_per_sample = 2.0 * config.max_bounces * res * res
    out = {"spread": {}}

    # ---- forward only: chunked progressive sampling by replay ----------
    chunk = int(os.environ.get("BENCH_CHUNK", "8"))
    state = render_samples_jit(config, ir, init_state(config, dev), chunk,
                               device=dev)
    n_bench = min(max(spp - chunk, chunk),
                  int(os.environ.get("BENCH_STEPS", "16")))
    n_bench -= n_bench % chunk

    def forward():
        nonlocal state
        for _ in range(n_bench // chunk):
            state = render_samples_jit(config, ir, state, chunk, device=dev)

    fwd, out["spread"]["fwd_rays_per_sec"] = rates(
        rays_per_sample * n_bench, timed(forward, dev))
    print(f"[stage] fwd {fwd:.0f} rays/s "
          f"({rays_per_sample / fwd * 1e3:.1f} ms/sample)", file=sys.stderr,
          flush=True)

    # ---- alive-ray accounting (counted, not timed) ----------------------
    cfg_count = config.replace(count_rays=True)
    st = render_samples_jit(cfg_count, ir, init_state(cfg_count, dev), 2,
                            device=dev)
    alive_fraction = float(st["ray_count"]) / 2.0 / rays_per_sample

    # ---- fwd+bwd: the headline at its own shape -------------------------
    target = torch.zeros((res * res, 3), device=dev)
    grad_spp = int(os.environ.get("BENCH_GRAD_SPP", str(spp)))
    accum_chunk = int(os.environ.get("BENCH_ACCUM_CHUNK", "8"))

    def accum():
        return fwd_bwd_step_accum(config, ir, target, grad_spp,
                                  chunk=accum_chunk, device=dev)

    loss, grads = accum()  # the warm-up and the captures
    if not (torch.isfinite(loss)
            and torch.isfinite(grads["materials"]["albedo"]).all()):
        raise RuntimeError("fwd_bwd_step_accum: the loss or the albedo "
                           "gradient is not finite")
    value, out["spread"]["value"] = rates(rays_per_sample * grad_spp,
                                          timed(accum, dev))
    print(f"[stage] fwd+bwd {grad_spp}spp {value:.0f} rays/s",
          file=sys.stderr, flush=True)

    # ---- the 1-spp direct-AD step ---------------------------------------
    fwd_bwd_step(config, ir, target, 1, device=dev)
    n_grad = int(os.environ.get("BENCH_GRAD_STEPS", "4"))

    def direct():
        for _ in range(n_grad):
            fwd_bwd_step(config, ir, target, 1, device=dev)

    fwdbwd_1spp, out["spread"]["fwd_bwd_1spp_rays_per_sec"] = rates(
        rays_per_sample * n_grad, timed(direct, dev))
    print(f"[stage] fwd+bwd 1spp {fwdbwd_1spp:.0f} rays/s", file=sys.stderr,
          flush=True)
    out.update(value=value, grad_spp=grad_spp, fwd_rays_per_sec=fwd,
               fwd_bwd_1spp_rays_per_sec=fwdbwd_1spp,
               alive_rays_per_sec=alive_fraction * fwd,
               alive_fraction=alive_fraction, fwd_samples_per_dispatch=chunk)
    return out


def main(device="cuda") -> dict:
    """Run the stages on ``device``, print the line and return it."""
    from .render.dispatch import graph_device

    dev = graph_device(device)
    res = int(os.environ.get("BENCH_RES", "1024"))
    spp = int(os.environ.get("BENCH_SPP", "64"))
    grid = int(os.environ.get("BENCH_GRID", "182"))
    got = main_scene(dev, res, spp, grid)

    # ---- the config-5 stage, in a subprocess ----------------------------
    config5 = {}
    if os.environ.get("BENCH_CONFIG5", "1") != "0":
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()  # the main scene's graph pools
        config5 = config5_stage(dev)
        print(f"[stage] config5 {config5}", file=sys.stderr, flush=True)

    vs = 1.0
    if os.path.exists(BASELINE):
        with open(BASELINE) as f:
            base = json.load(f).get("fwd_bwd_rays_per_sec")
        if base:
            vs = got["value"] / base

    line = {
        "metric": f"rays/sec/chip fwd+bwd, {(grid-1)*(grid-1)*2//1000}k tris "
                  f"at {res}x{res}, {got['grad_spp']} spp accumulated",
        "value": round(got["value"], 1),
        "unit": "rays/s",
        "vs_baseline": round(vs, 4),
        "extra": {
            "fwd_rays_per_sec": round(got["fwd_rays_per_sec"], 1),
            "fwd_bwd_1spp_rays_per_sec": round(
                got["fwd_bwd_1spp_rays_per_sec"], 1),
            "alive_rays_per_sec": round(got["alive_rays_per_sec"], 1),
            "alive_fraction": round(got["alive_fraction"], 4),
            "fwd_samples_per_dispatch": got["fwd_samples_per_dispatch"],
            "device": card_name(dev),
            "spread": {k: [round(x, 1) for x in v]
                       for k, v in got["spread"].items()},
            **config5,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
