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
``--samples`` samples), by replay of its captured graphs and beside it
by the eager loops of its two passes: s per fwd+bwd in turns, then pass 1
(forward only, recording the traces) and pass 2 (each sample replayed
and differentiated) apart, each with its ms/sample, kernels and
traversal launches per sample, its device time by group and the
device's busy share, and the peak device memory of the graph step, and
pass 2 tracing again by replay.  Needs a CUDA card; without one it
exits non-zero.  The profiling runs in a child process
(``core/child.py``), which builds its own captures from a CPU copy of
the IR: the session never opens in the caller's process, which may
hold CUDA graphs.
"""

from __future__ import annotations

import argparse
import contextlib
import re
import subprocess
import sys
import time

from .core import child


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


def walk_launches(events):
    """(closest-hit, any-hit) launches of the binary traversal kernel
    among a profiler's device events, by the kernel's name (demangled, or
    mangled: bvh_traverse_walk<kAny, ...>)."""
    got = [0, 0]
    for e in events:
        m = re.search(r"bvh_traverse_walk(?:<(true|false)|ILb([01])E)", e.key)
        if m:
            got[m.group(1) == "true" or m.group(2) == "1"] += e.count
    return tuple(got)


def wall(fn, *a, **kw):
    """(fn's result, host-clock seconds to the end of its device
    work)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    res = fn(*a, **kw)
    torch.cuda.synchronize()
    return res, time.time() - t0


# Profiling sessions per pass of ``profile_grad``, one sample each.
GRAD_SESSIONS = 2


def _device_of(ir):
    return next(t for leaves in ir.values() for t in leaves.values()).device


def profile_grad(config, ir, samples: int, top: int = 15) -> dict:
    """``_profile_grad_here``, traced in a child process on a card
    (``core/child.py``), from a CPU copy of the IR."""
    dev = _device_of(ir)
    if child.traces_in_child(dev):
        return child.call_in_child(_profile_grad_child, config,
                                   child.to_cpu(ir), dev, samples, top)
    return _profile_grad_here(config, ir, samples, top)


def _profile_grad_child(config, ir, device, samples: int, top: int) -> dict:
    from .convert import ir_to
    return _profile_grad_here(config, ir_to(ir, device), samples, top)


def profile_forward(config, ir, samples: int, top: int = 15) -> dict:
    """``_profile_forward_here``, traced in a child process on a card
    (``core/child.py``), from a CPU copy of the IR."""
    dev = _device_of(ir)
    if child.traces_in_child(dev):
        return child.call_in_child(_profile_forward_child, config,
                                   child.to_cpu(ir), dev, samples, top)
    return _profile_forward_here(config, ir, samples, top)


def _profile_forward_child(config, ir, device, samples: int,
                           top: int) -> dict:
    from .convert import ir_to
    return _profile_forward_here(config, ir_to(ir, device), samples, top)


def _profile_grad_here(config, ir, samples: int, top: int = 15) -> dict:
    """One accumulated forward and backward pass of ``samples`` samples
    (``render.grad.fwd_bwd_step_accum``), by graph replay and by the
    eager loops of its two passes (``_accum_fwd``, ``_accum_bwd``) from
    the same inputs, after one warm-up call (which captures): s per
    fwd+bwd unprofiled, in turns (eager, graph, graph, eager), and each
    pass's ms/sample unprofiled; then each pass under the profiler over
    ``GRAD_SESSIONS`` samples, one sample to a profiling session (a session
    over several back-to-back replays loses device records), reported by
    ``_report`` (against the pass's unprofiled ms/sample) with the
    traversal launches per sample by kernel name, those of the session
    that saw the most device events (one that saw fewer lost records).
    By replay also pass 2 tracing again (``cache_traces=False``: its own
    graph, captured by one unprofiled call first).  Also the peak device
    memory of one graph call.
    Returns {"graph" | "eager": {"s": [...], "pass1" | "pass2" (and
    "pass2_retrace" by replay): _report's numbers with "ms_per_sample"
    and "launches"}, "peak_mib": ...}; a pass's entry is None where the
    profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .render import grad, integrator

    n = samples
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.no_grad():
        st = integrator.render_sample(config, ir,
                                      integrator.init_state(config))
    target = st["passes"][integrator.BEAUTY, :, :3] * 1.5 + 0.1
    dev = target.device
    params = {"materials": grad.float_subtree(ir["materials"])}
    buffers = grad.static_params(ir, params, dev)
    merged = grad._merge(ir, buffers)
    grad.fwd_bwd_step_accum(config, ir, target, n)  # warm-up and captures

    def eager(n_):
        loss, seed, caches, _ = grad._accum_fwd(config, ir, params, target,
                                                n_, True, dev)
        return grad._accum_bwd(config, ir, params, seed, caches, n_, dev)

    def graph(n_):
        return grad.fwd_bwd_step_accum(config, ir, target, n_)

    out = {"graph": {"s": []}, "eager": {"s": []}}
    for name in ("eager", "graph", "graph", "eager"):
        out[name]["s"].append(wall(eager if name == "eager" else graph,
                                    n)[1])
    torch.cuda.reset_peak_memory_stats()
    graph(n)
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20

    # Each pass alone, unprofiled, then one sample a profiling session.
    (_, seed, caches, _), s1 = wall(
        grad._accum_fwd_chunked, config, merged, target, n, n, True, dev)
    _, s2 = wall(grad._accum_bwd_chunked, config, ir, buffers, seed,
                  caches, n, n, dev)
    grad._accum_bwd_chunked(config, ir, buffers, seed, [], 1, 1, dev)
    _, s2r = wall(grad._accum_bwd_chunked, config, ir, buffers, seed, [],
                   n, n, dev)
    (_, e_seed, e_caches, e_state), e1 = wall(
        grad._accum_fwd, config, ir, params, target, n, True, dev)
    _, e2 = wall(grad._accum_bwd, config, ir, params, e_seed, e_caches, n,
                  dev)
    rng = integrator.init_state(config, dev)["rng"]
    tree, flat = grad._as_parameters(params)
    e_merged = grad._merge(ir, tree)
    state = {k: v.clone() for k, v in e_state.items()}
    units = {
        ("graph", "pass1"): lambda i: grad._accum_fwd_chunk_record(
            config, merged, state, 1, dev),
        ("graph", "pass2"): lambda i: grad._accum_bwd_chunk(
            config, ir, buffers, seed, rng, 1,
            {k: v[i:i + 1] for k, v in caches[0].items()}, dev),
        ("graph", "pass2_retrace"): lambda i: grad._accum_bwd_chunk(
            config, ir, buffers, seed, rng, 1, None, dev),
        ("eager", "pass1"): lambda i: integrator.render_sample(
            config, e_merged, state, record=True),
        ("eager", "pass2"): lambda i: grad._vjp_sample(
            config, e_merged, flat, rng, e_seed, e_caches[i]),
    }
    labels = {"pass1": "pass 1 (forward, record)",
              "pass2": "pass 2 (replay, forward + backward)",
              "pass2_retrace": "pass 2 (tracing again, forward + backward)"}
    plain = {("graph", "pass1"): s1, ("graph", "pass2"): s2,
             ("graph", "pass2_retrace"): s2r,
             ("eager", "pass1"): e1, ("eager", "pass2"): e2}
    k = min(GRAD_SESSIONS, n)
    for (name, part), unit in units.items():
        profs, prof_ms = [], 0.0
        for i in range(k):
            with torch.no_grad() if part == "pass1" else \
                    contextlib.nullcontext():
                with profile(activities=acts) as prof:
                    prof_ms += wall(unit, i)[1] * 1e3 / k
            profs.append(prof)
        ms = plain[(name, part)] * 1e3 / n
        print(f"{name} {labels[part]}: {ms:.2f} ms/sample unprofiled")
        res = _report(profs, f"{name} {labels[part]}", prof_ms, k, top, ms)
        fullest = max(profs, key=lambda p: sum(
            e.count for e in device_events(p)))
        out[name][part] = res and {
            **res, "ms_per_sample": ms,
            "launches": list(walk_launches(device_events(fullest)))}
    g, e = out["graph"], out["eager"]
    rays = 2 * config.max_bounces * config.x_res * config.y_res * n
    print(f"fwd_bwd_step_accum, {n} samples, s per fwd+bwd in turns (eager, "
          f"graph, graph, eager): graph {[round(x, 4) for x in g['s']]}, "
          f"eager {[round(x, 4) for x in e['s']]}; {rays / min(g['s']):.4g} "
          f"rays/s by replay, {rays / min(e['s']):.4g} eager; peak memory "
          f"{out['peak_mib']:.0f} MiB by replay")
    return out


def _profile_forward_here(config, ir, samples: int, top: int = 15) -> dict:
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

    def ms_per_sample(fn, n):
        torch.cuda.synchronize()
        t0 = time.time()
        fn(n)
        torch.cuda.synchronize()
        return (time.time() - t0) / n * 1e3

    turns = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        turns[name].append(ms_per_sample(
            graph if name == "graph" else eager, samples))
    out = {}
    for name, fn, label in (
            ("graph", graph, "Renderer.step (graph replays)"),
            ("eager", eager, "eager render_sample loop")):
        profs, prof_ms = [], 0.0
        for _ in range(samples):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prof_ms += ms_per_sample(fn, 1) / samples
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
        out = profile_grad(config, ir, args.samples, args.top)
        return 0 if all(out[k][p] is not None for k in ("graph", "eager")
                        for p in ("pass1", "pass2")) else 1
    out = profile_forward(config, ir, args.samples, args.top)
    return 0 if all(v is not None for v in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
