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
    counts;
 7. config 5: the 999,698-tri textured heightfield with a point light
    (build time, BVH depth and largest leaf), and the kernel against its
    plain version there, as in phase 3; its tri table (45.8 MiB) no
    longer fits beside the rest in the card's 50 MB L2;
 8. the config-5 path: its native forward step at 1024x1024, 5 bounces
    (1 warm-up sample, then 4 timed), 5 closest-hit launches of 1M rays
    and 5 merged any-hit launches of 2M rays per sample, peak memory;
 9. a small textured, lit heightfield at 64x64, one sample, card against
    CPU;
10. at config 5's recorded shapes: the kernel against its plain version,
    with its times and bound, as in phase 6.
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
CONFIG5_TRIS = 999698


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
    from elevenrender_tpu_torch.scene.demo import (heightfield_scene,
                                                   textured_heightfield_scene)

    t_start = time.time()

    def phase_done(name, t0):
        print(f"[time] {name}: {time.time() - t0:.1f} s")

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

    errs = {"closest": [], "any_hit": []}

    def check(tables, depth, label, o, d, exclude=None, t_max=None,
              plain=None):
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
            _, tk = tr._mt(tables["tris"][ki[diff].long()], o[diff], d[diff])
            _, tp = tr._mt(tables["tris"][pi[diff].long()], o[diff], d[diff])
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

    def check_scene(ir, depth, label):
        """Camera rays, random rays around the scene's box, and those as
        any-hit queries with half of them under a finite t_max."""
        tables = ir["kernel"]
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
        check(tables, depth, f"{label} camera rays", cam_o.contiguous(),
              cam_d.contiguous())
        closest = check(tables, depth, f"{label} random rays", rnd_o, rnd_d)
        t_max = torch.tensor(np.where(gen.uniform(size=nr) < 0.5, np.inf,
                                      gen.uniform(0.05, 4.0, nr)
                                      ).astype(np.float32), device=dev)
        check(tables, depth, f"{label} random rays", rnd_o, rnd_d,
              closest.to(torch.int32), t_max)

    def drive(label, cfg, ir, n_timed):
        """Renderer.step at full width: 1 warm-up sample, then n_timed
        with the launch counts set to 0 just before and read just
        after.  Fails unless every sample made 5 closest-hit and 5
        any-hit launches and the beauty pass is finite and positive."""
        res = cfg.x_res
        torch.cuda.reset_peak_memory_stats()
        renderer = Renderer(cfg, ir)
        renderer.step(1)  # warm-up
        torch.cuda.synchronize()
        tr.reset_counts()
        t0 = time.time()
        renderer.step(n_timed)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches, any_hit = tr.launches, tr.any_hit_launches
        closest = launches - any_hit
        rays_per_sample = 2 * cfg.max_bounces * res * res
        beauty = renderer.get_pass("beauty").reshape(res, res, 4)[..., :3]
        print(f"[{label}] {res}x{res} native {cfg.max_bounces} bounces: "
              f"{dt / n_timed * 1e3:.1f} ms/sample, "
              f"{rays_per_sample * n_timed / dt:.4g} rays/s, "
              f"{launches / n_timed:g} kernel launches/sample ({closest} "
              f"closest, {any_hit} any-hit over {n_timed} samples), peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        print(f"[{label}] beauty mean {float(beauty.mean()):.5f}, finite "
              f"{bool(np.isfinite(beauty).all())}, samples "
              f"{renderer.get_render_info()['samples']}")
        if closest != 5 * n_timed or any_hit != 5 * n_timed:
            fail(f"{label}: expected 10 kernel launches per sample, got "
                 f"{launches / n_timed:g}")
        if not np.isfinite(beauty).all() or not beauty.mean() > 0:
            fail(f"{label}: beauty pass is not finite with a positive mean")
        return closest, any_hit

    def card_vs_cpu(label, cfg, ir):
        res = cfg.x_res
        images = {}
        for name in ("cuda", "cpu"):
            r_ = Renderer(cfg, ir_to(ir, name), device=name)
            r_.step(1)
            images[name] = r_.get_pass("beauty").reshape(res, res, 4)[..., :3]
        close = np.isclose(images["cuda"], images["cpu"], rtol=1e-4,
                           atol=1e-5).all(axis=-1).mean()
        print(f"[parity] {label} {res}x{res} native 1 sample, card vs CPU: "
              f"{close * 100:.2f}% of pixels within rtol 1e-4 / atol 1e-5, "
              f"means {images['cuda'].mean():.6f} / "
              f"{images['cpu'].mean():.6f}")
        if close < 0.99:
            fail(f"{label}: card and CPU renders agree on only "
                 f"{close * 100:.2f}% of pixels")

    def timing_at_recorded_shapes(label, cfg, ir, depth):
        """Records the first four launches of one sample (bounce 0 and 1,
        closest then any-hit), then times the kernel on the closest-hit
        bounce-0 and bounce-1 rays and the bounce-1 any-hit rays, checks
        it against its plain version there, and times the plain
        version."""
        tables = ir["kernel"]
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
        table_bytes = sum(t.numel() * t.element_size()
                          for t in tables.values())
        print(f"[timing] {label}: kernel tables {table_bytes / 2**20:.1f} "
              f"MiB (tris {tables['tris'].numel() * 4 / 2**20:.1f} MiB)")

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
            check(tables, depth, f"{label} {key}", o, d, ex, tm,
                  plain=(pi, pt))
            torch.cuda.synchronize()
            t0 = time.time()
            tr.traverse_plain(tables, o, d, depth, ex, tm)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            visits = int(cnt["visits"].sum())
            tests = int(cnt["tests"].sum())
            n = o.shape[0]
            ops = visits * OPS_PER_VISIT + tests * OPS_PER_TEST
            nbytes = (table_bytes + n * (24 + 8)
                      + (n * 8 if ex is not None else 0))
            ops_ms = ops / FP32_PEAK * 1e3
            bytes_ms = nbytes / HBM_RATE * 1e3
            bound = max(ops_ms, bytes_ms)
            timing[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                               bound_by="operations" if ops_ms >= bytes_ms
                               else "bytes")
            print(f"[timing] {label} {key}: {n} rays, kernel {ms:.3f} "
                  f"ms/launch, plain {plain_ms:.1f} ms, bound {bound:.4f} ms "
                  f"({timing[key]['bound_by']}: {visits / n:.1f} visits "
                  f"and {tests / n:.1f} tri tests per ray, {ops:.4g} ops, "
                  f"{nbytes / 2**20:.1f} MiB; ops {ops_ms:.4f} ms, bytes "
                  f"{bytes_ms:.4f} ms), {bound / ms * 100:.1f}% of bound")
        return timing

    # ---- 3. kernel against its plain version -----------------------------
    t0 = time.time()
    scene, config, ir = heightfield_scene(grid=182, res=1024, compat=False)
    n_tris = ir["tris"]["verts"].shape[0]
    if n_tris != 65522:
        fail(f"heightfield has {n_tris} tris, expected 65522")
    print(f"[scene] {n_tris} tris, bvh depth {config.bvh_depth}, max leaf "
          f"{config.bvh_max_leaf}, built in {time.time() - t0:.1f} s")
    depth = config.bvh_depth
    check_scene(ir, depth, "heightfield")
    phase_done("phase 3", t0)

    # ---- 4. the main path at full width ----------------------------------
    t0 = time.time()
    cfg = config.replace(max_bounces=5, compat=False)
    main_closest, main_any_hit = drive("main", cfg, ir, 8)
    phase_done("phase 4", t0)

    # ---- 5. card against CPU ---------------------------------------------
    t0 = time.time()
    card_vs_cpu("heightfield", cfg.replace(x_res=64, y_res=64), ir)
    phase_done("phase 5", t0)

    # ---- 6. kernel timing at the main path's shapes ------------------------
    t0 = time.time()
    timing = timing_at_recorded_shapes("main path", cfg, ir, depth)
    phase_done("phase 6", t0)
    del scene, ir
    err12 = {k: max(v) for k, v in errs.items()}
    errs = {"closest": [], "any_hit": []}

    # ---- 7. config 5: build, kernel against its plain version -----------
    t0 = time.time()
    _, config5, ir5 = textured_heightfield_scene(grid=708, res=1024,
                                                 compat=False)
    n5 = ir5["tris"]["verts"].shape[0]
    if n5 != CONFIG5_TRIS:
        fail(f"config 5 has {n5} tris, expected {CONFIG5_TRIS}")
    if config5.n_lights != 1 or config5.tex_uniform_filter != -1:
        fail("config 5 lost its point light or its mixed-filter atlas")
    print(f"[config5] {n5} tris, bvh depth {config5.bvh_depth}, max leaf "
          f"{config5.bvh_max_leaf}, built in {time.time() - t0:.1f} s")
    depth5 = config5.bvh_depth
    check_scene(ir5, depth5, "config5")
    phase_done("phase 7", t0)

    # ---- 8. the config-5 path at full width -------------------------------
    t0 = time.time()
    cfg5 = config5.replace(max_bounces=5, compat=False)
    c5_closest, c5_any_hit = drive("config5", cfg5, ir5, 4)
    phase_done("phase 8", t0)

    # ---- 9. card against CPU on a small textured, lit scene --------------
    t0 = time.time()
    _, small5, ir_small = textured_heightfield_scene(grid=64, res=64,
                                                     compat=False)
    card_vs_cpu("textured heightfield (7,938 tris, point light)",
                small5.replace(max_bounces=5), ir_small)
    phase_done("phase 9", t0)

    # ---- 10. kernel timing at config 5's shapes -----------------------------
    t0 = time.time()
    timing5 = timing_at_recorded_shapes("config5", cfg5, ir5, depth5)
    phase_done("phase 10", t0)

    src = "elevenrender_tpu_torch/csrc/bvh_traverse.cu"
    row12 = "elevenrender_tpu/ops/bvh_pallas.py:102"
    row3 = "elevenrender_tpu/ops/bvh_pallas.py:102 (stream=True)"

    def entry(name, replaces, launches, err, t, extra=None):
        e = dict(name=name, route="cuda", source=src, replaces=replaces,
                 launches=launches, max_abs_err=err, ms=t["ms"],
                 plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                 bound_by=t["bound_by"], library_ms=None)
        e.update(extra or {})
        return e

    kern = [
        entry("bvh_traverse closest-hit", row12, main_closest,
              err12["closest"], timing["closest_b1"],
              {"ms_bounce0": timing["closest_b0"]["ms"]}),
        entry("bvh_traverse any-hit", row12, main_any_hit, err12["any_hit"],
              timing["any_hit_b1"]),
        entry("bvh_traverse closest-hit, stream residency (config 5)", row3,
              c5_closest, max(errs["closest"]), timing5["closest_b1"],
              {"ms_bounce0": timing5["closest_b0"]["ms"]}),
        entry("bvh_traverse any-hit, stream residency (config 5, merged "
              "2N-ray shadow launch)", row3, c5_any_hit,
              max(errs["any_hit"]), timing5["any_hit_b1"]),
    ]
    print(f"[done] {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
