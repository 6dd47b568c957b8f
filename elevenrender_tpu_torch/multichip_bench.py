"""Multi-device scaling of the sharded render step: rays/s, rays/s per
device and the scaling efficiency against one device, the instrument
for BASELINE.md:24's goal of >= 80%.

    RES=1024 GRID=182 SPP=4 python3 -m elevenrender_tpu_torch.multichip_bench [--device cpu --devices N]

Port of ``scripts/multichip_bench.py``, with its settings and defaults
from the environment: ``RES`` (1024), ``GRID`` (182), ``SPP`` (4), the
heightfield ``scene/demo.heightfield_scene(grid=GRID, res=RES,
compat=False)``.  The port renders one rank per device
(``parallel/mesh.py``), so for each count N of 1, 2, 4, ... that divides
the pixels and is at most the devices it may use, it spawns N ranks
(``parallel/dryrun.run_ranks``): NCCL on cards, one rank a card, or
gloo with ``--device cpu`` and ``--devices N`` (CPU ranks share the
host's cores, so their rows test the harness, not scaling).  A count
above the cards is refused: ranks that share a card measure no scaling.

Each rank builds the scene and steps a ``Renderer`` on its mesh
(``render/renderer.py``: this rank's slice, the sample captured at its
pixel offset): one warm-up sample (on a card the eager sample and the
capture), then, after a barrier, ``SPP`` timed samples (replays) from
that state.  A sample of the image takes as long as its slowest rank.
The JAX script's row is printed for each N (``rays_per_sample = 2 *
max_bounces * RES^2``), then its summary line, with ``platform`` "gpu"
or "cpu" and, beside its keys, rank 0's closest-hit and any-hit
traversal launches for each N (the launch accounting, warm-up
included).  The script exits non-zero if the harness fails, not on a
low efficiency.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from .core.device import resolve_device
from .ops import traverse as traverse_ops
from .parallel.dryrun import run_ranks
from .render.renderer import Renderer
from .scene.demo import heightfield_scene

# The device counts the JAX script tries, in its order.
COUNTS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# A rank that has not reported this long after the spawn is lost.
RANK_TIMEOUT_S = 600.0


def device_counts(npix: int, available: int) -> list:
    """The counts N to measure: at most ``available`` and dividing the
    pixels, as the JAX script chooses them."""
    return [n for n in COUNTS if n <= available and npix % n == 0]


def scaling_row(n: int, seconds: float, rays_per_sample: float,
                base_rate: float | None):
    """(the JAX script's row for ``n`` devices at ``seconds`` a sample,
    its rays/s): the efficiency is against ``base_rate``, the rays/s of
    the first row (this row's own when None)."""
    rate = rays_per_sample / seconds
    base = rate if base_rate is None else base_rate
    return {"devices": n, "ms_per_sample": round(seconds * 1e3, 1),
            "rays_per_sec": round(rate, 1),
            "rays_per_sec_per_device": round(rate / n, 1),
            "scaling_efficiency_vs_1": round(rate / (base * n), 4)}, rate


def bench_rank(mesh, task: dict) -> dict:
    """One rank's part of a row: the warm-up sample, a barrier, ``spp``
    timed samples.  Returns the slowest rank's s per sample (every rank
    the same), this rank's launches and the scene's rays per sample."""
    _, config, ir = heightfield_scene(grid=task["grid"], res=task["res"],
                                      spp=task["spp"], compat=False,
                                      device=mesh.device)
    renderer = Renderer(config, ir, mesh=mesh)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    traverse_ops.reset_counts()
    renderer.step(1)
    sync()
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    renderer.step(task["spp"])
    sync()
    seconds = (time.perf_counter() - t0) / task["spp"]
    every = [None] * mesh.world
    dist.all_gather_object(every, seconds, group=mesh.group)
    return {"s_per_sample": max(every),
            "launches": [traverse_ops.launches
                         - traverse_ops.any_hit_launches,
                         traverse_ops.any_hit_launches],
            "rays_per_sample": 2.0 * config.max_bounces * task["res"] ** 2}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=None,
                    help="the devices to use: on the card at most the "
                         "cards (default all), on the CPU the ranks "
                         "(default 1)")
    args = ap.parse_args(argv)
    res = int(os.environ.get("RES", "1024"))
    grid = int(os.environ.get("GRID", "182"))
    spp = int(os.environ.get("SPP", "4"))
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cards = torch.cuda.device_count() if cuda else None
    available = args.devices or (cards if cuda else 1)
    if cuda and available > cards:
        raise ValueError(f"{available} devices asked for, {cards} cards: "
                         f"ranks that share a card measure no scaling")
    platform = "gpu" if cuda else "cpu"
    counts = device_counts(res * res, available)
    print(f"devices={available} ({platform}) grid={grid} res={res} "
          f"spp={spp}", file=sys.stderr, flush=True)
    task = {"grid": grid, "res": res, "spp": spp}
    base_rate = None
    rows, launches = [], {}
    for n in counts:
        rank0 = run_ranks(task, n, dev.type, timeout=RANK_TIMEOUT_S,
                          work=bench_rank)[0]
        row, rate = scaling_row(n, rank0["s_per_sample"],
                                rank0["rays_per_sample"], base_rate)
        if base_rate is None:
            base_rate = rate
        rows.append(row)
        launches[str(n)] = rank0["launches"]
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "summary": "multichip scaling",
        "platform": platform,
        "max_devices": counts[-1] if counts else 0,
        "efficiency_at_max": (rows[-1]["scaling_efficiency_vs_1"] if rows
                              else None),
        "goal": ">=0.80 on cards joined by NVLink (BASELINE.md:24)",
        "launches_rank0": launches,
    }), flush=True)
    return rows


if __name__ == "__main__":
    main()
