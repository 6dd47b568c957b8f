#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure ends the run non-zero and no
result line is printed):
 1. environment: torch and CUDA versions, the card's name and power limit;
 2. build: every CUDA kernel of the port, from the sources in this tree;
 3. the BVH traversal kernel against its plain PyTorch version on the
    65,522-tri heightfield: camera rays, random rays, and the random rays
    as any-hit queries;
 4. the main path: the native forward render step on that scene at
    1024x1024, 5 bounces, through Renderer.step (1 warm-up sample, then 8
    timed), with the kernel's launch counts;
 5. the same scene at 64x64, one sample, on the card and on the CPU;
 6. at the main path's shapes (rays recorded from one sample): the
    kernel against its plain version again, its time per launch, the
    plain version's time, and the bound from the plain version's work
    counts.
The last two lines are one JSON object with the kernels' numbers and one
with the result: {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

# fp32 peak outside the tensor cores and HBM rate of one H100 SXM
# (NVIDIA's data sheet).
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# fp32 operations per unit of traversal work, as the kernel spends them
# (csrc/bvh_traverse.cu; a compare or select counts as one): two slab
# tests per interior visit (6 sub, 6 mul, 10 min/max, 3 compares each),
# and per triangle test 46 arithmetic ops and 9 compares.
OPS_PER_VISIT = 50
OPS_PER_TEST = 55


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    import numpy as np

    from elevenrender_tpu_torch import kernels
    from elevenrender_tpu_torch.convert import ir_to
    from elevenrender_tpu_torch.ops import traverse as tr
    from elevenrender_tpu_torch.ops.camera import camera_ray
    from elevenrender_tpu_torch.render.renderer import Renderer
    from elevenrender_tpu_torch.scene.demo import heightfield_scene

    t_start = time.time()

    # ---- 1. environment ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(card)

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    kernels.build_all()
    print(f"[build] {time.time() - t0:.1f} s for {len(kernels.LIBRARIES)} "
          f"librar{'y' if len(kernels.LIBRARIES) == 1 else 'ies'}")
    for name, info in kernels.build_info.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # ---- 3. kernel against its plain version -----------------------------
    t0 = time.time()
    scene, config, ir = heightfield_scene(grid=182, res=1024, compat=False)
    n_tris = ir["tris"]["verts"].shape[0]
    if n_tris != 65522:
        fail(f"heightfield has {n_tris} tris, expected 65522")
    print(f"[scene] {n_tris} tris, bvh depth {config.bvh_depth}, max leaf "
          f"{config.bvh_max_leaf}, built in {time.time() - t0:.1f} s")
    tables, depth = ir["kernel"], config.bvh_depth
    dev = tables["boxes"].device

    nr = 65536
    gen = np.random.default_rng(0)
    cam = dict(ir["camera"])
    cam["bokeh"] = False
    pix = torch.arange(nr, device=dev)
    r = torch.tensor(gen.uniform(size=(5, nr)).astype(np.float32),
                     device=dev)
    cam_o, cam_d = camera_ray(cam, 256, 256, pix % 256, pix // 256, *r)
    lo = ir["bvh"]["node_bmin"][0].cpu().numpy()
    hi = ir["bvh"]["node_bmax"][0].cpu().numpy()
    rnd_o = gen.uniform(lo - 0.5, hi + 0.5, (nr, 3)).astype(np.float32)
    rnd_d = gen.normal(size=(nr, 3)).astype(np.float32)
    rnd_d /= np.linalg.norm(rnd_d, axis=-1, keepdims=True)
    rnd_o = torch.tensor(rnd_o, device=dev)
    rnd_d = torch.tensor(rnd_d, device=dev)

    def tri_t(ids, o, d):
        _, t = tr._mt(tables["tris"][ids.long()], o, d)
        return t

    errs = {"closest": [], "any_hit": []}

    def check(label, o, d, exclude=None, t_max=None, plain=None):
        """The kernel through its wrapper against the plain version on
        the same rays.  Tolerance: closest-hit ids equal except equal-t
        ties (the two tris' t within 1e-6 relative), t within rtol 1e-6
        on hits; any-hit occlusion flag equal on every ray."""
        ki, kt = tr.traverse(tables, o, d, depth, exclude, t_max)
        pi, pt = plain if plain is not None else tr.traverse_plain(
            tables, o, d, depth, exclude, t_max)
        torch.cuda.synchronize()
        n = o.shape[0]
        if exclude is not None:
            flag_mis = int(((ki >= 0) != (pi >= 0)).sum())
            print(f"[kernel] any-hit {label}: {n} rays, "
                  f"{int((pi >= 0).sum())} occluded, flag mismatches "
                  f"{flag_mis}")
            if flag_mis:
                fail(f"any-hit {label}: occlusion flag differs on "
                     f"{flag_mis} rays")
            errs["any_hit"].append(float(flag_mis))
            return pi
        hit_k, hit_p = ki >= 0, pi >= 0
        if not torch.equal(hit_k, hit_p):
            fail(f"{label}: hit/miss differs on "
                 f"{int((hit_k != hit_p).sum())} rays")
        diff = (ki != pi).nonzero()[:, 0]
        if diff.numel():
            tk = tri_t(ki[diff], o[diff], d[diff])
            tp = tri_t(pi[diff], o[diff], d[diff])
            ties = int(((tk - tp).abs() <= 1e-6 * tp.abs()).sum())
            if ties != diff.numel():
                fail(f"{label}: {diff.numel() - ties} id mismatches that "
                     f"are not equal-t ties")
        err = 0.0
        if bool(hit_p.any()):
            gap = (kt[hit_p] - pt[hit_p]).abs()
            rel = float((gap / pt[hit_p].abs().clamp(min=1e-30)).max())
            if rel > 1e-6:
                fail(f"{label}: t differs by {rel:.3g} relative")
            err = float(gap.max())
        errs["closest"].append(err)
        print(f"[kernel] closest-hit {label}: {n} rays, {int(hit_p.sum())} "
              f"hits, id mismatches {diff.numel()} (all equal-t ties), max "
              f"|t - t_plain| {err:.3g}")
        return pi

    check("camera rays", cam_o.contiguous(), cam_d.contiguous())
    closest = check("random rays", rnd_o, rnd_d)
    t_max = torch.tensor(np.where(gen.uniform(size=nr) < 0.5, np.inf,
                                  gen.uniform(0.05, 4.0, nr)
                                  ).astype(np.float32), device=dev)
    check("random rays", rnd_o, rnd_d, closest.to(torch.int32), t_max)

    # ---- 4. the main path at full width ----------------------------------
    res, n_timed = 1024, 8
    cfg = config.replace(max_bounces=5, compat=False)
    torch.cuda.reset_peak_memory_stats()
    renderer = Renderer(cfg, ir)
    renderer.step(1)  # warm-up
    torch.cuda.synchronize()
    tr.reset_counts()
    t0 = time.time()
    renderer.step(n_timed)
    torch.cuda.synchronize()
    dt = time.time() - t0
    main_launches = tr.launches
    main_any_hit = tr.any_hit_launches
    main_closest = main_launches - main_any_hit
    per_sample = main_launches / n_timed
    rays_per_sample = 2 * cfg.max_bounces * res * res
    beauty = renderer.get_pass("beauty").reshape(res, res, 4)[..., :3]
    print(f"[main] heightfield {n_tris} tris {res}x{res} native "
          f"{cfg.max_bounces} bounces: {dt / n_timed * 1e3:.1f} ms/sample, "
          f"{rays_per_sample * n_timed / dt:.4g} rays/s, "
          f"{per_sample:g} kernel launches/sample ({main_closest} closest, "
          f"{main_any_hit} any-hit over {n_timed} samples), peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    print(f"[main] beauty mean {float(beauty.mean()):.5f}, finite "
          f"{bool(np.isfinite(beauty).all())}, samples "
          f"{renderer.get_render_info()['samples']}")
    if main_closest != 5 * n_timed or main_any_hit != 5 * n_timed:
        fail(f"expected 10 kernel launches per sample, got {per_sample}")
    if not np.isfinite(beauty).all() or not beauty.mean() > 0:
        fail("beauty pass is not finite with a positive mean")
    del renderer

    # ---- 5. card against CPU ---------------------------------------------
    small = cfg.replace(x_res=64, y_res=64)
    images = {}
    for name in ("cuda", "cpu"):
        r_ = Renderer(small, ir_to(ir, name), device=name)
        r_.step(1)
        images[name] = r_.get_pass("beauty").reshape(64, 64, 4)[..., :3]
    close = np.isclose(images["cuda"], images["cpu"], rtol=1e-4,
                       atol=1e-5).all(axis=-1).mean()
    print(f"[parity] 64x64 native 1 sample, card vs CPU: "
          f"{close * 100:.2f}% of pixels within rtol 1e-4 / atol 1e-5, "
          f"means {images['cuda'].mean():.6f} / {images['cpu'].mean():.6f}")
    if close < 0.99:
        fail(f"card and CPU renders agree on only {close * 100:.2f}% of "
             f"pixels")

    # ---- 6. kernel timing at the main path's shapes ------------------------
    calls = []
    launch = tr.traverse

    def record(tables_, o, d, depth_, exclude=None, t_max=None):
        if len(calls) < 4:
            calls.append((o.clone(), d.clone(),
                          None if exclude is None else exclude.clone(),
                          None if t_max is None else t_max.clone()))
        return launch(tables_, o, d, depth_, exclude, t_max)

    tr.traverse = record
    try:
        Renderer(cfg, ir).step(1)
    finally:
        tr.traverse = launch
    shapes = {"closest_b0": calls[0], "closest_b1": calls[2],
              "any_hit_b1": calls[3]}
    table_bytes = sum(t.numel() * t.element_size() for t in tables.values())

    def time_kernel(o, d, ex, tm, reps=20):
        for _ in range(3):
            tr._launch(tables, o, d, depth, ex, tm)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            tr._launch(tables, o, d, depth, ex, tm)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    timing = {}
    for key, (o, d, ex, tm) in shapes.items():
        ms = time_kernel(o, d, ex, tm)
        pi, pt, cnt = tr.traverse_plain(tables, o, d, depth, ex, tm,
                                        counters=True)
        check(f"main path {key}", o, d, ex, tm, plain=(pi, pt))
        torch.cuda.synchronize()
        t0 = time.time()
        tr.traverse_plain(tables, o, d, depth, ex, tm)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        visits = int(cnt["visits"].sum())
        tests = int(cnt["tests"].sum())
        n = o.shape[0]
        ops = visits * OPS_PER_VISIT + tests * OPS_PER_TEST
        nbytes = table_bytes + n * (24 + 8) + (n * 8 if ex is not None else 0)
        ops_ms = ops / FP32_PEAK * 1e3
        bytes_ms = nbytes / HBM_RATE * 1e3
        bound = max(ops_ms, bytes_ms)
        timing[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                           bound_by="operations" if ops_ms >= bytes_ms
                           else "bytes")
        print(f"[timing] {key}: {n} rays, kernel {ms:.3f} ms/launch, plain "
              f"{plain_ms:.1f} ms, bound {bound:.4f} ms "
              f"({timing[key]['bound_by']}: {visits / n:.1f} visits and "
              f"{tests / n:.1f} tri tests per ray, {ops:.4g} ops, "
              f"{nbytes / 2**20:.1f} MiB), {bound / ms * 100:.1f}% of bound")

    src = "elevenrender_tpu_torch/csrc/bvh_traverse.cu"
    kern = [
        dict(name="bvh_traverse closest-hit", route="cuda", source=src,
             replaces="elevenrender_tpu/ops/bvh_pallas.py:102",
             launches=main_closest, max_abs_err=max(errs["closest"]),
             ms=timing["closest_b1"]["ms"],
             plain_ms=timing["closest_b1"]["plain_ms"],
             bound_ms=timing["closest_b1"]["bound_ms"],
             bound_by=timing["closest_b1"]["bound_by"], library_ms=None,
             ms_bounce0=timing["closest_b0"]["ms"]),
        dict(name="bvh_traverse any-hit", route="cuda", source=src,
             replaces="elevenrender_tpu/ops/bvh_pallas.py:102",
             launches=main_any_hit, max_abs_err=max(errs["any_hit"]),
             ms=timing["any_hit_b1"]["ms"],
             plain_ms=timing["any_hit_b1"]["plain_ms"],
             bound_ms=timing["any_hit_b1"]["bound_ms"],
             bound_by=timing["any_hit_b1"]["bound_by"], library_ms=None),
    ]
    print(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
