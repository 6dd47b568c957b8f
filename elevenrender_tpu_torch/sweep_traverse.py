"""A/B of the traversal kernels on one card: the binary walk, its first
version, the frontier-K walk and the 8-wide collapsed BVH on the same
rays.

    python3 -m elevenrender_tpu_torch.sweep_traverse [--grids 182,708]
        [--res 1024] [--frontiers 2,4,8] [--reps 20] [--seed 0]
        [--device cuda|cpu]

The port's counterpart of the JAX package's ``scripts/sweep_trav_kernels.py``
and ``scripts/sweep_frontier.py`` in one module.  Each scene comes from
the real construction path (``scene/demo.heightfield_scene`` ->
``build_ir``): grid 182 is the main path's 65,522 tris, grid 708 the
999,698 tris of config 5's terrain.  Ray sets, res x res rays each:
  coherent           camera rays through the pixel centres, in pixel order;
  sorted-incoherent  those rays shuffled (numpy ``default_rng(seed)``),
                     then Morton-sorted by ``ops/sort.sort_for_packets``;
  recorded bounce 1  the second closest-hit launch of one render sample;
  recorded shadow    its any-hit launch (binary, binary-v1 and frontier-4
                     only: the wide walk has no any-hit mode).
"binary-v1" is the binary kernel's first version (``csrc/bvh_traverse_v1.cu``,
one thread per ray), held to the binary kernel exactly: ids, t and
counters equal on every ray.
Per (kernel, ray set) it prints the time per launch (CUDA events, the
median of ``--reps`` launches, the kernels taking turns inside one round
so that a drifting clock touches all alike), Mrays/s, the mean per-ray
counters from the kernel's own ``count_steps`` launch, the bound those
counters give, and the agreement with the binary kernel: the same rays
hit, t bit-equal but for counted near ties (``NEAR_TIE_RTOL``), ids equal
up to equal-t ties, the any-hit flag exact.  A disagreement, or a frontier
push refused by a full stack, raises.  The
last line is one JSON object with every row.

With ``--device cpu`` the same code runs the kernels' plain versions, for
the tests, at a small size (``--grids 12 --res 32``); its times are host
times of PyTorch on the CPU and say nothing about the card.

``chip_smoke.py`` calls the functions below with scenes it has already
built, so the loops exist once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .experiments import bvh_wide
from .ops import traverse as tr
from .ops.camera import camera_ray
from .ops.sort import sort_for_packets

# fp32 peak outside the tensor cores and HBM rate of one H100 SXM
# (NVIDIA's data sheet).
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# fp32 operations per unit of traversal work, as the kernels spend them (a
# compare or select counts as one): a slab test is 6 sub, 6 mul, 10
# min/max and 3 compares; a binary visit makes two, a wide visit eight; a
# triangle test is 46 arithmetic ops and 9 compares.
OPS_PER_SLAB = 25
OPS_PER_VISIT = 2 * OPS_PER_SLAB
OPS_PER_WIDE_VISIT = 8 * OPS_PER_SLAB
OPS_PER_TEST = 55

BINARY = "binary"
V1 = "binary-v1"
WIDE = "wide"
ANY_HIT_FRONTIER = 4  # the frontier timed on shadow rays


def frontier_name(k: int) -> str:
    return f"frontier={k}"


def make_walk(ir: dict, depth: int) -> dict:
    """What every kernel of the sweep reads, on ``ir``'s device: the
    binary tables (``ir["kernel"]``), the wide tables built from the same
    flat BVH, the depth and the scene's box."""
    tables = ir["kernel"]
    dev = tables["boxes"].device
    bvh = {k: v.cpu().numpy() for k, v in ir["bvh"].items()}
    wide = ir.get("wide") or {
        k: torch.tensor(v, device=dev)
        for k, v in bvh_wide.pack_bvh_wide({**bvh, "depth": depth}).items()}
    return dict(tables=tables, wide=wide, depth=depth,
                bounds=(ir["bvh"]["node_bmin"][0], ir["bvh"]["node_bmax"][0]))


def run(walk: dict, kernel: str, o, d, exclude=None, t_max=None,
        count_steps: bool = False):
    """One launch of ``kernel`` ("binary", "binary-v1", "frontier=K" or
    "wide") through its public wrapper: the CUDA kernel on CUDA rays, the
    plain version on CPU rays."""
    if kernel == V1:
        return tr.traverse_v1(walk["tables"], o, d, walk["depth"], exclude,
                              t_max, count_steps)
    if kernel == WIDE:
        if exclude is not None:
            raise ValueError("the wide walk has no any-hit mode")
        return bvh_wide.traverse_wide(
            walk["wide"]["nodes8"], walk["wide"]["leaf8"],
            walk["tables"]["tris"], o, d, walk["depth"], count_steps)
    frontier = 1 if kernel == BINARY else int(kernel.split("=")[1])
    return tr.traverse(walk["tables"], o, d, walk["depth"], exclude, t_max,
                       count_steps=count_steps, frontier=frontier)


def camera_rays(ir: dict, res: int):
    """res x res camera rays through the pixel centres, no bokeh."""
    dev = ir["kernel"]["boxes"].device
    pix = torch.arange(res * res, device=dev)
    half = torch.full((res * res,), 0.5, device=dev)
    cam = dict(ir["camera"])
    cam["bokeh"] = False
    o, d = camera_ray(cam, res, res, pix % res, pix // res, *([half] * 5))
    return o.contiguous(), d.contiguous()


def incoherent_rays(walk: dict, o, d, seed: int):
    """The rays shuffled by ``default_rng(seed)``, then Morton-sorted."""
    perm = torch.tensor(np.random.default_rng(seed).permutation(o.shape[0]),
                        device=o.device)
    o, d = o[perm], d[perm]
    order, _ = sort_for_packets(o, d, *walk["bounds"])
    return o[order].contiguous(), d[order].contiguous()


def recorded_launches(cfg, ir, device) -> dict:
    """The rays of one render sample's first launches, as the integrator
    hands them to ``ops.traverse.traverse`` (sorted, masked lanes
    replaced): {"closest_b0", "closest_b1", "any_hit_b1"} ->
    (o, d, exclude, t_max)."""
    from .render.renderer import Renderer
    calls = []
    launch = tr.traverse

    def record(tables, o, d, depth, exclude=None, t_max=None, **kw):
        if len(calls) < 4:
            calls.append((o.clone(), d.clone(),
                          None if exclude is None else exclude.clone(),
                          None if t_max is None else t_max.clone()))
        return launch(tables, o, d, depth, exclude, t_max, **kw)

    tr.traverse = record
    try:
        Renderer(cfg, ir, device=device).step(1)
    finally:
        tr.traverse = launch
    if len(calls) < 4:
        raise RuntimeError(f"one sample made {len(calls)} traversal launches; "
                           f"the recording needs two bounces")
    return {"closest_b0": calls[0], "closest_b1": calls[2],
            "any_hit_b1": calls[3]}


def bound_of(read, counts, any_hit: bool, ops_per_visit: int = OPS_PER_VISIT):
    """The least time the card could take for one launch, from the
    kernel's per-ray counters [N, 4]: fp32 operations (visits and tri
    tests) over the fp32 peak, or every table the launch reads (``read``,
    a list of tensors) plus rays in and results out over the memory rate.
    A bound may count too little work but never too much."""
    n = counts.shape[0]
    visits, _, _, tests = (int(c) for c in counts.sum(dim=0))
    ops = visits * ops_per_visit + tests * OPS_PER_TEST
    nbytes = (sum(t.numel() * t.element_size() for t in read)
              + n * (24 + 8) + (n * 8 if any_hit else 0))
    ops_ms = ops / FP32_PEAK * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                visits=visits, tests=tests, ops=ops, bytes=nbytes)


def kernel_bound(walk: dict, kernel: str, counts, any_hit: bool):
    """``bound_of`` with the tables and the cost of a visit of ``kernel``."""
    t = walk["tables"]
    if kernel == WIDE:
        read = [walk["wide"]["nodes8"], walk["wide"]["leaf8"], t["tris"]]
        return bound_of(read, counts, any_hit, OPS_PER_WIDE_VISIT)
    return bound_of([t["boxes"], t["leaves"], t["tris"]], counts, any_hit)


# A walk that prunes in another order may, on a rare ray, find a tri that
# the binary walk cut: the slab test's rounding is not conservative against
# the triangle test's, so a box whose entry distance rounds to just above
# best_t can hold a tri whose t rounds to just below it.  Such a near tie
# moves t by rounding only; this is how far it may (the JAX package's own
# tests hold these walks to each other at the same tolerance).
NEAR_TIE_RTOL = 1e-5
NEAR_TIE_ATOL = 1e-6


def agreement(walk: dict, label: str, ref, got, o, d, any_hit: bool) -> dict:
    """Holds one walk's (idx, t) to the binary kernel's on the same rays:
    the same rays hit; t bit-equal, except on near ties (see
    ``NEAR_TIE_RTOL``), which are counted; any-hit t (-inf or t_max)
    bit-equal on every ray; closest-hit ids equal except where the other
    tri gives exactly the t reported for it.  Returns {"ties", "near_ties",
    "near_tie_gap"}; raises on anything else."""
    (ri, rt), (gi, gt) = ref, got
    if not torch.equal(ri >= 0, gi >= 0):
        raise RuntimeError(f"{label}: hit flag differs from the binary "
                           f"kernel's on {int(((ri >= 0) != (gi >= 0)).sum())} "
                           f"rays")
    near = (rt != gt).nonzero()[:, 0]
    gap = 0.0
    if near.numel():
        a, b = rt[near], gt[near]
        if any_hit or not bool(((a - b).abs() <= NEAR_TIE_ATOL
                                + NEAR_TIE_RTOL * a.abs()).all()):
            raise RuntimeError(f"{label}: t differs from the binary kernel's "
                               f"on {near.numel()} rays, beyond a near tie")
        gap = float(((a - b).abs() / a.abs().clamp(min=1e-30)).max())
    if any_hit:  # which occluder is found first depends on the order
        return dict(ties=0, near_ties=0, near_tie_gap=0.0)
    diff = (ri != gi).nonzero()[:, 0]
    if diff.numel():
        _, t_alt = tr._mt(walk["tables"]["tris"][gi[diff].long()], o[diff],
                          d[diff])
        if not torch.equal(t_alt, gt[diff]):
            raise RuntimeError(f"{label}: a reported id does not give the "
                               f"reported t")
    return dict(ties=int(diff.numel()) - int(near.numel()),
                near_ties=int(near.numel()), near_tie_gap=gap)


def same_walk(label: str, ref, got) -> None:
    """Two kernels of the same walk (the binary kernel and a version or
    build of it) on the same rays: (idx, t, counters) equal on every ray,
    t bit for bit; raises otherwise."""
    for name, a, b in zip(("ids", "t", "counters"), ref, got):
        if not torch.equal(a, b):
            bad = (a != b) if a.dim() == 1 else (a != b).any(dim=1)
            raise RuntimeError(f"{label}: {name} differ from the binary "
                               f"kernel's on {int(bad.sum())} rays")


def spread(times) -> tuple:
    """(10th, 90th percentile) of a list of times."""
    return (float(np.percentile(times, 10)), float(np.percentile(times, 90)))


def times_in_turns(fns: dict, reps: int, on_card: bool) -> dict:
    """name -> the ms of each of ``reps`` calls; round by round, every
    function once.  CUDA events on the card, the host clock on the CPU."""
    times = {name: [] for name in fns}
    for name, fn in fns.items():
        for _ in range(3 if on_card else 0):  # warm-up
            fn()
    for _ in range(reps):
        for name, fn in fns.items():
            if on_card:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                fn()
                b.record()
                b.synchronize()
                times[name].append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                fn()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def sweep_ray_set(walk: dict, scene: str, ray_set: str, rays, kernels,
                  reps: int = 20) -> list:
    """Every kernel of ``kernels`` (the binary walk first) on one ray set
    (o, d, exclude, t_max): checked against the binary kernel, counted,
    timed in turns.  Prints one line per kernel and returns the rows."""
    o, d, exclude, t_max = rays
    any_hit = exclude is not None
    on_card = o.device.type == "cuda"
    if kernels[0] != BINARY:
        raise ValueError("the binary walk leads: the others are held to it")
    n = o.shape[0]
    rows = []
    ref = None
    for kernel in kernels:
        label = f"{scene} {ray_set} {kernel}"
        idx, t, counts = run(walk, kernel, o, d, exclude, t_max,
                             count_steps=True)
        if kernel == V1:
            same_walk(label, (*ref, ref_counts), (idx, t, counts))
        row = dict(scene=scene, ray_set=ray_set, kernel=kernel, rays=n,
                   mode="any-hit" if any_hit else "closest",
                   device=str(o.device.type))
        if kernel.startswith("frontier"):
            row["stack_deepest"] = tr.frontier_stack["deepest"]
            row["stack_rows"] = tr.frontier_stack_rows(
                int(kernel.split("=")[1]), walk["depth"])
            if tr.frontier_stack["refused"]:
                raise RuntimeError(
                    f"{label}: {tr.frontier_stack['refused']} pushes were "
                    f"refused by a full stack of {row['stack_rows']}")
        if ref is None:
            ref, ref_counts = (idx, t), counts
            row.update(ties=0, near_ties=0, near_tie_gap=0.0)
        else:
            row.update(agreement(walk, label, ref, (idx, t), o, d, any_hit))
        row["counters"] = [round(float(c), 2)
                           for c in counts.float().mean(dim=0)]
        row.update(kernel_bound(walk, kernel, counts, any_hit))
        rows.append(row)
    timed = times_in_turns(
        {k: (lambda k=k: run(walk, k, o, d, exclude, t_max)) for k in kernels},
        reps, on_card)
    timed = {k: float(np.median(v)) for k, v in timed.items()}
    for row in rows:
        ms = timed[row["kernel"]]
        row["ms"] = ms
        row["mrays_per_s"] = n / ms / 1e3
        row["vs_binary"] = ms / timed[BINARY]
        what = ("ms/launch" if on_card
                else "ms (the plain version on the CPU)")
        print(f"[sweep] {row['scene']} {ray_set} {row['mode']} "
              f"{row['kernel']}: {ms:.3f} {what}, "
              f"{row['mrays_per_s']:.1f} Mrays/s, {row['vs_binary']:.2f}x "
              f"the binary walk; per ray [visits, leaf visits, groups, tri "
              f"tests] {row['counters']}; bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); against the binary kernel t bit-equal "
              f"but for {row['near_ties']} near ties (largest gap "
              f"{row['near_tie_gap']:.3g} relative), {row['ties']} equal-t "
              f"id ties"
              + (f"; deepest stack {row['stack_deepest']} of "
                 f"{row['stack_rows']}" if "stack_rows" in row else ""))
    return rows


def sweep_scene(walk: dict, scene: str, ray_sets: dict, frontiers,
                reps: int = 20) -> list:
    """``sweep_ray_set`` over ``ray_sets`` (name -> (o, d, exclude,
    t_max)): closest-hit sets get the binary walk, binary-v1, every
    frontier of ``frontiers`` and the wide walk; any-hit sets the binary
    walk, binary-v1 and frontier ``ANY_HIT_FRONTIER``."""
    closest = ([BINARY, V1] + [frontier_name(k) for k in frontiers]
               + [WIDE])
    rows = []
    for name, rays in ray_sets.items():
        kernels = (closest if rays[2] is None
                   else [BINARY, V1, frontier_name(ANY_HIT_FRONTIER)])
        rows += sweep_ray_set(walk, scene, name, rays, kernels, reps)
    return rows


def standard_ray_sets(walk: dict, ir, res: int, seed: int, recorded: dict):
    """The four ray sets of the module's note for one scene; ``recorded``
    from ``recorded_launches``."""
    o, d = camera_rays(ir, res)
    return {"coherent": (o, d, None, None),
            "sorted-incoherent": (*incoherent_rays(walk, o, d, seed), None,
                                  None),
            "recorded bounce 1": recorded["closest_b1"],
            "recorded shadow": recorded["any_hit_b1"]}


def main(argv=None) -> list:
    from .core.device import resolve_device
    from .scene.demo import heightfield_scene

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grids", default="182,708")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--frontiers", default="2,4,8")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    frontiers = [int(k) for k in args.frontiers.split(",")]
    if dev.type == "cuda":
        print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
    rows = []
    for grid in (int(g) for g in args.grids.split(",")):
        t0 = time.time()
        _, config, ir = heightfield_scene(grid=grid, res=args.res,
                                          compat=False, device=dev)
        # Two bounces give the recording its four launches; a deeper path
        # would not change their rays.
        cfg = config.replace(max_bounces=2, compat=False)
        n_tris = ir["tris"]["verts"].shape[0]
        scene = f"{n_tris} tris"
        print(f"[scene] {scene}, bvh depth {cfg.bvh_depth}, max leaf "
              f"{cfg.bvh_max_leaf}, wide levels "
              f"{bvh_wide.wide_levels(cfg.bvh_depth)}, built in "
              f"{time.time() - t0:.1f} s")
        walk = make_walk(ir, cfg.bvh_depth)
        recorded = recorded_launches(
            cfg.replace(x_res=args.res, y_res=args.res), ir, dev)
        sets = standard_ray_sets(walk, ir, args.res, args.seed, recorded)
        rows += sweep_scene(walk, scene, sets, frontiers, args.reps)
    print(json.dumps({"sweep": rows}))
    return rows


if __name__ == "__main__":
    main()
