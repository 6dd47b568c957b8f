"""Where the time of one render step goes, on the card.

    python3 -m elevenrender_tpu_torch.profile_step [--scene heightfield]
        [--res 1024] [--samples 4] [--grad]

Renders one scene in native mode, 5 bounces: ``heightfield`` is the main
path's (65,522 tris), ``config5`` the 999,698-tri textured heightfield
with a point light.  It reports, over ``--samples`` progressive samples
after one warm-up, for what ``Renderer.step`` runs (replays of the
sample's CUDA graph, ``render/dispatch.py``) and beside it for the eager
loop of ``render_sample`` from the same state: the host-clock time per
sample, and from ``torch.profiler`` the kernels per sample and the
device time by kernel, grouped into the BVH traversal kernel, sorting,
gathers/scatters and the rest, with the device's busy and idle share of
the wall time.  With ``--grad`` it profiles one accumulated forward and
backward pass instead (``render.grad.fwd_bwd_step_accum`` over
``--samples`` samples): pass 1 (forward only, recording the traces) and
pass 2 (each sample replayed and differentiated) apart, each with its
kernels per sample, its device time by group and the device's busy share,
and the peak device memory of the whole step.  Needs a CUDA card; without
one it exits non-zero.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def _group(name: str) -> str:
    n = name.lower()
    if "bvh_traverse" in n:
        return "traversal kernel"
    if "sort" in n or "radix" in n:
        return "sort"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather/scatter"
    if "reduce" in n:
        return "reductions"
    return "elementwise and other"


def device_events(prof) -> list:
    """The profiled span's device events (kernels, copies, memsets) as
    ``key_averages`` gives them, those with device time."""
    import torch
    return [e for e in prof.key_averages()
            if getattr(e, "device_time_total", 0) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]


def device_totals(profs) -> dict:
    """{kernel name: [device us, calls]} summed over the profiled
    spans."""
    totals: dict = {}
    for prof in profs:
        for e in device_events(prof):
            t = totals.setdefault(e.key, [0.0, 0])
            t[0] += e.device_time_total
            t[1] += e.count
    return totals


def busy_union_ms(prof) -> float:
    """The profiled span's device busy time: the union of its device
    events' intervals (so kernels that overlap count once)."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    return busy_us / 1e3


def _report(profs, label: str, wall_ms: float, samples: int, top: int,
            plain_ms: float) -> dict | None:
    """Print the profiled spans' device time per sample by group and by
    kernel, and the device's busy share: the union of the device events'
    intervals over the spans' wall time (``wall_ms`` per sample, under
    the profiler).  Beside it, the device time over the unprofiled wall
    time (``plain_ms``), a ratio: the profiler slows the host and may
    lengthen kernels, so it can pass 100%.  Returns the numbers (device
    ms and kernels per sample, the busy share, the ratio, ms by group),
    None when the profiler recorded no device time."""
    totals = device_totals(profs)
    if not totals:
        print(f"{label}: the profiler recorded no device time: no breakdown")
        return None
    total_us = sum(us for us, _ in totals.values()) / samples
    n_kernels = sum(n for _, n in totals.values()) / samples
    busy = sum(busy_union_ms(p) for p in profs) / samples / wall_ms
    ratio = total_us / 1e3 / plain_ms
    print(f"{label}: device time {total_us / 1e3:.2f} ms/sample in "
          f"{n_kernels:.0f} kernels/sample; busy {busy * 100:.1f}%, idle "
          f"{(1 - busy) * 100:.1f}% of the profiled wall time "
          f"({wall_ms:.2f} ms/sample; busy = the union of the device "
          f"events' intervals); device time / unprofiled wall time "
          f"({plain_ms:.2f} ms/sample) {ratio * 100:.1f}%")
    groups: dict[str, float] = {}
    for key, (us, _) in totals.items():
        g = _group(key)
        groups[g] = groups.get(g, 0.0) + us / samples
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:24s} {us / 1e3:8.3f} ms/sample "
              f"{us / total_us * 100:5.1f}%")
    print(f"top {top} kernels by device time (ms/sample, calls/sample):")
    for key, (us, n) in sorted(totals.items(), key=lambda kv: -kv[1][0])[
            :top]:
        print(f"  {us / samples / 1e3:8.3f} {n / samples:6.0f}  {key[:90]}")
    return {"device_ms": total_us / 1e3, "kernels": n_kernels,
            "busy": busy, "device_over_unprofiled": ratio,
            "ms_by_group": {g: us / 1e3 for g, us in groups.items()}}


def _profile_grad(config, ir, args) -> int:
    """One accumulated fwd+bwd: unprofiled for its time and peak memory,
    then pass 1 and pass 2 under the profiler, one after the other."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .render import grad, integrator
    from .ops import traverse

    n = args.samples
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        st = integrator.render_sample(config, ir, integrator.init_state(config))
    target = st["passes"][integrator.BEAUTY, :, :3] * 1.5 + 0.1
    grad.fwd_bwd_step_accum(config, ir, target, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    traverse.reset_counts()
    t0 = time.time()
    loss, _ = grad.fwd_bwd_step_accum(config, ir, target, n)
    torch.cuda.synchronize()
    dt = time.time() - t0
    print(f"fwd_bwd_step_accum, {n} samples: {dt:.3f} s unprofiled, "
          f"{2 * config.max_bounces * args.res ** 2 * n / dt:.4g} rays/s, "
          f"loss {float(loss):.6f}, {traverse.launches} traversal launches, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

    # The accumulator's own two passes, each called as it calls them.
    params = {"materials": grad.float_subtree(ir["materials"])}
    dev = target.device

    def pass1():
        return grad._accum_fwd(config, ir, params, target, n, True, dev)

    def pass2(fwd):
        _, seed, caches = fwd
        return grad._accum_bwd(config, ir, params, seed, caches, n, dev)

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.time()
        res = fn(*a)
        torch.cuda.synchronize()
        return res, (time.time() - t0) / n * 1e3

    fwd, plain1 = timed(pass1)
    _, plain2 = timed(pass2, fwd)
    with profile(activities=acts) as prof1:
        fwd, wall1 = timed(pass1)
    with profile(activities=acts) as prof2:
        _, wall2 = timed(pass2, fwd)
    ok1 = _report([prof1], "pass 1 (forward, record)", wall1, n, args.top,
                  plain1)
    ok2 = _report([prof2], "pass 2 (replay, forward + backward)", wall2, n,
                  args.top, plain2)
    return 0 if ok1 is not None and ok2 is not None else 1


def profile_forward(config, ir, samples: int, top: int = 15) -> dict:
    """``Renderer.step`` (graph replays) and the eager loop of
    ``render_sample`` from the same state, ``samples`` each after one
    warm-up step: unprofiled ms/sample in turns (eager, graph, graph,
    eager), then each under the profiler, one sample to a profiling
    session (a session over several back-to-back replays loses device
    records), reported by ``_report`` (the ratio against the faster
    unprofiled turn).  Returns {"graph": ..., "eager": ...}:
    ``_report``'s numbers with the two unprofiled ms/sample, or None
    where the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .render.integrator import render_sample
    from .render.renderer import Renderer

    renderer = Renderer(config, ir)
    renderer.step(1)  # the eager warm-up sample and the capture
    start = renderer.state

    def graph(n):
        renderer.state = start
        renderer.step(n)

    def eager(n):
        st = start
        with torch.no_grad():
            for _ in range(n):
                st = render_sample(config, ir, st)

    def wall(fn, n):
        torch.cuda.synchronize()
        t0 = time.time()
        fn(n)
        torch.cuda.synchronize()
        return (time.time() - t0) / n * 1e3

    turns = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        turns[name].append(wall(graph if name == "graph" else eager,
                                samples))
    out = {}
    for name, fn, label in (
            ("graph", graph, "Renderer.step (graph replays)"),
            ("eager", eager, "eager render_sample loop")):
        profs, prof_ms = [], 0.0
        for _ in range(samples):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_ms += wall(fn, 1) / samples
            profs.append(prof)
        print(f"{label}: {turns[name]} ms/sample unprofiled, in turns")
        res = _report(profs, label, prof_ms, samples, top,
                      sorted(turns[name])[0])
        out[name] = res and {**res, "ms_per_sample": turns[name]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("heightfield", "config5"),
                    default="heightfield")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--grad", action="store_true",
                    help="profile one accumulated forward+backward pass")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA card", file=sys.stderr)
        return 1
    from .scene.demo import heightfield_scene, textured_heightfield_scene

    if args.scene == "config5":
        _, config, ir = textured_heightfield_scene(grid=708, res=args.res,
                                                   compat=False)
    else:
        _, config, ir = heightfield_scene(grid=182, res=args.res,
                                          compat=False)
    config = config.replace(max_bounces=5)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip() or torch.cuda.get_device_name(0)}")
    print(f"scene {args.scene}: {ir['tris']['verts'].shape[0]} tris; "
          f"{args.res}x{args.res}, 5 bounces, native")
    if args.grad:
        return _profile_grad(config, ir, args)
    out = profile_forward(config, ir, args.samples, args.top)
    return 0 if all(v is not None for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
