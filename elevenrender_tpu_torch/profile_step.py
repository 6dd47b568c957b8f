"""Where the time of one render step goes, on the card.

    python3 -m elevenrender_tpu_torch.profile_step [--scene heightfield]
        [--res 1024] [--samples 4]

Renders one scene in native mode, 5 bounces: ``heightfield`` is the main
path's (65,522 tris), ``config5`` the 999,698-tri textured heightfield
with a point light.  It reports, over ``--samples`` progressive samples after one
warm-up: the host-clock time per sample, and from ``torch.profiler`` the
device time by kernel, grouped into the BVH traversal kernel, sorting,
gathers/scatters and the rest, with the device's busy and idle share of
the wall time.  Needs a CUDA card; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", choices=("heightfield", "config5"),
                    default="heightfield")
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--top", type=int, default=15)
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
    renderer = Renderer(config.replace(max_bounces=5), ir)
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

    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.device_time_total for e in events) / args.samples
    n_kernels = sum(e.count for e in events) / args.samples
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"scene {args.scene}: {ir['tris']['verts'].shape[0]} tris; "
          f"{args.res}x{args.res}, 5 bounces, native: {wall_plain:.2f} "
          f"ms/sample unprofiled, {wall_prof:.2f} ms/sample profiled")
    if not events:
        print("the profiler recorded no device time: no breakdown")
        return 1
    busy = total_us / 1e3 / wall_prof
    print(f"device time {total_us / 1e3:.2f} ms/sample in {n_kernels:.0f} "
          f"kernels/sample; busy {busy * 100:.1f}%, idle "
          f"{(1 - busy) * 100:.1f}% of the profiled wall time")
    groups: dict[str, float] = {}
    for e in events:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + e.device_time_total / args.samples
    for g, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {g:24s} {us / 1e3:8.3f} ms/sample "
              f"{us / total_us * 100:5.1f}%")
    print(f"top {args.top} kernels by device time (ms/sample, calls/sample):")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:args.top]:
        print(f"  {e.device_time_total / args.samples / 1e3:8.3f} "
              f"{e.count / args.samples:6.0f}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
