"""Where the time of one render step goes, on the card.

    python3 -m elevenrender_tpu_torch.profile_step [--scene heightfield]
        [--res 1024] [--samples 4] [--grad]

Renders one scene in native mode, 5 bounces: ``heightfield`` is the main
path's (65,522 tris), ``config5`` the 999,698-tri textured heightfield
with a point light.  It reports, over ``--samples`` progressive samples after one
warm-up: the host-clock time per sample, and from ``torch.profiler`` the
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


def _report(prof, label: str, wall_ms: float, samples: int, top: int,
            plain_ms: float) -> bool:
    """Print one profiled span's device time per sample by group and by
    kernel, and the device's busy share of the span's wall time per
    sample, profiled (``wall_ms``) and unprofiled (``plain_ms``: the
    profiler slows the host, not the card); False when the profiler
    recorded no device time."""
    import torch
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        print(f"{label}: the profiler recorded no device time: no breakdown")
        return False
    total_us = sum(e.device_time_total for e in events) / samples
    n_kernels = sum(e.count for e in events) / samples
    busy = total_us / 1e3 / wall_ms
    print(f"{label}: device time {total_us / 1e3:.2f} ms/sample in "
          f"{n_kernels:.0f} kernels/sample; busy {busy * 100:.1f}%, idle "
          f"{(1 - busy) * 100:.1f}% of the profiled wall time "
          f"({wall_ms:.2f} ms/sample); {total_us / 10 / plain_ms:.1f}% of "
          f"the unprofiled {plain_ms:.2f} ms/sample")
    groups: dict[str, float] = {}
    for e in events:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + e.device_time_total / samples
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:24s} {us / 1e3:8.3f} ms/sample "
              f"{us / total_us * 100:5.1f}%")
    print(f"top {top} kernels by device time (ms/sample, calls/sample):")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:top]:
        print(f"  {e.device_time_total / samples / 1e3:8.3f} "
              f"{e.count / samples:6.0f}  {e.key[:90]}")
    return True


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
    ok1 = _report(prof1, "pass 1 (forward, record)", wall1, n, args.top,
                  plain1)
    ok2 = _report(prof2, "pass 2 (replay, forward + backward)", wall2, n,
                  args.top, plain2)
    return 0 if ok1 and ok2 else 1


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
    from torch.profiler import ProfilerActivity, profile

    from .render.renderer import Renderer
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
    renderer = Renderer(config, ir)
    renderer.step(1)
    torch.cuda.synchronize()

    t0 = time.time()
    renderer.step(args.samples)
    torch.cuda.synchronize()
    wall_plain = (time.time() - t0) / args.samples * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        renderer.step(args.samples)
        torch.cuda.synchronize()
        wall_prof = (time.time() - t0) / args.samples * 1e3

    return 0 if _report(prof, "forward step", wall_prof, args.samples,
                        args.top, wall_plain) else 1


if __name__ == "__main__":
    sys.exit(main())
