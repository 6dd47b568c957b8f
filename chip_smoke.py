#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (each prints its lines; any failure ends the run non-zero and no
result line is printed):
 1. environment: torch and CUDA versions, the card's name and power limit;
 2. build: every CUDA kernel of the port, from the sources in this tree,
    with each entry function's registers, stack frame and spills (ptxas),
    and, at the same time, the host runtime (csrc/elevenrt.cpp: the C++
    SAH build and OBJ tokenizer) with the host compiler;
 3. the BVH traversal kernel (csrc/bvh_traverse.cu: persistent warps with
    ray refill, while-while leaf rounds, warp-shared leaf scans, the stack
    in shared memory) against its plain PyTorch version on the 65,522-tri
    heightfield: camera rays, random rays, and the random rays as any-hit
    queries; then the first 65,535, 33, 31 and 1 random rays, closest-hit
    and any-hit with count_steps (ray counts that leave the last run of 32
    short, or most of the persistent grid without rays): ids, t and
    counters equal;
 4. the main path: the native forward render step on that scene at
    1024x1024, 5 bounces, through Renderer.step (1 warm-up sample, eager,
    which captures the sample as a CUDA graph; then 8 timed replays),
    with the kernel's launch counts (a replay adds what its capture
    counted), then 8 more replays, each under the profiler, whose kernel
    names count the launches (the count the result line carries); then
    Renderer.profile(path, 4), which traces in a child process (as
    profile_step's entry points do on a card: the port's tracing entry
    points open no profiling session in the caller's process, which may
    hold CUDA graphs; this script's own CUDA-only launch-counting sessions, in
    phases 4, 8, 17, 18 and 20 (c), do open in its main process): the
    trace.json it writes holds 4 x 5 + 5 traversal launches by kernel
    name and 4 x the kernels of one replay of the same graph profiled in
    this process, and the renderer is the samples further on;
 5. the same scene at 64x64, one sample, on the card and on the CPU;
 6. at the main path's shapes (rays recorded from one sample): the
    kernel against its plain version again, its time per launch in turns
    with its first version (csrc/bvh_traverse_v1.cu, "binary-v1", which no
    render path launches) and each one's 10-90% spread, the plain
    version's time, and the bound from the kernel's own counters;
 7. config 5: the 999,698-tri textured heightfield with a point light
    (set-up time with the C++ SAH build, beside the numpy build's 47.9 s
    on the card's host in the run that first built it; BVH depth and
    largest leaf), and the kernel against its
    plain version there, as in phase 3, ragged ray counts included; its
    tri table (45.8 MiB) no
    longer fits beside the rest in the card's 50 MB L2;
 8. the config-5 path: its native forward step at 1024x1024, 5 bounces
    (1 warm-up sample, then 4 timed replays and 4 profiled, as in phase
    4), 5 closest-hit launches of 1M rays and 5 merged any-hit launches
    of 2M rays per sample, peak memory;
 9. card against CPU: (a) a small textured, lit heightfield at 64x64,
    one sample; (b) config 5 at full width (999,698 tris, 1024x1024, 5
    bounces), two rows of its image rendered eagerly on both, sample by
    sample: after each, the share of pixels that agree and the share
    whose RNG state is equal (gate: >= 99% agree after the first);
10. at config 5's recorded shapes: the kernel against its plain version,
    with its times and bound, as in phase 6;
11. the kernel's variants (order near/sign x leaf_aabb 0/1/2, the
    noscan/skip probes, count_steps) against the plain version under the
    same flags: at 65,522 tris on 65,536 camera rays, 65,536 random rays
    (each closest-hit and any-hit) and the recorded bounce-1 and shadow
    launches; at 999,698 tris on the random rays closest-hit and every
    4th ray of the two recorded launches (262,144 and 524,288 rays): ids
    equal, t bit-equal, the four per-ray counters
    equal; leaf_aabb is a pure cull; sign gives near's hits up to equal-t
    ties;
12. the variants timed at both paths' recorded shapes beside the default
    kernel, their mean counters per ray, and each bound from the
    kernel's own counters; the noscan/skip probes keep the default's
    schedule and grid, so they split its time into walk and scans;
13. the gradient path at 64x64, 5 bounces, card (by replay of its CUDA
    graphs, render/grad.py) against CPU, on the untextured and the
    textured, lit scene: fwd_bwd_step_accum over 4 samples, loss and
    every material gradient leaf, a replayed pass 2 equal to a re-traced
    one exactly and launching no traversal; render_loss_and_grad over 2
    samples (one graph of the whole forward and backward): its replay
    against its first call and against the CPU, 20 launches a replay;
14. the gradient path at full width, in the main process, by replay of
    its graphs against the eager loops of its two passes from the same
    inputs: fwd_bwd_step_accum at 1024x1024, 5 bounces, 8 samples on the
    65,522-tri scene, default RenderConfig (pass 1 records, pass 2
    replays the records).  Gates: pass 1's state, loss and every record
    bit-equal to eager; pass 2's gradients within 1e-5 of each leaf's
    largest entry (an atomic order may move) and its final RNG state
    bit-equal; the same for chunk = 1, 3 and 8 and for
    cache_traces=False; 5 + 5 launches a pass-1 replay, 0 a pass-2 replay
    and 5 + 5 a re-traced one, by the accounting of this process's
    replays, and the same by the profiler (one replay to a session) in
    profile_step.profile_grad's child process, which rebuilds the IR
    and captures its own graphs of the same programs; the albedo halved
    replays the same captures and equals eager for those values;
    remat_bounces at 64x64 agrees.
    Reported: each pass's first call s (warm-up, capture, replays), the
    reserved memory each capture keeps, s per fwd+bwd and rays/s in turns
    (eager, graph, graph, eager), each pass's ms/sample, busy share and
    device time over the unprofiled wall (profile_step.profile_grad, in a
    child process),
    peak memory (64 samples, bench.py's headline shape, is phase 21's
    bench); then 2 samples by replay under each other (order, leaf_aabb)
    variant: the same loss; then config 5 (999,698 tris, textures, a point
    light), 4 samples by replay: finite, non-zero gradients, 5 + 5
    launches a sample over both passes by the accounting, s and peak
    memory (its profile by pass is profile_step --scene config5 --grad,
    left out of this run for its length);
15. the frontier-K walk (csrc/bvh_frontier.cu, every K = 2..8,
    closest-hit and any-hit), the 8-wide walk (csrc/bvh_wide.cu; both
    one ray per lane tile, the warp's leaf scans pooled) and binary-v1
    (closest-hit and any-hit) against their plain versions on a
    65,536-ray strided subset of the recorded bounce-1 and shadow
    launches at 65,522 and 999,698 tris; at 65,522 tris also on 65,536
    camera rays, 65,536 random rays, the main path's full recorded
    launches (K = 2, 4, 8 and the wide walk closest-hit, K = 4 any-hit),
    and the random rays cut to 65,535, 33, 31 and 1 (every K and the wide
    walk: the persistent grid's hand-out): ids equal, t bit-equal,
    counters equal with and without count_steps, the same deepest stack,
    no push refused;
16. the traversal A/B sweep (elevenrender_tpu_torch/sweep_traverse.py) at
    full width, 1,048,576 rays per launch, on both scenes: coherent
    camera rays, those shuffled and Morton-sorted, and the recorded
    bounce-1 and shadow launches; every walk held to the binary kernel
    (the same rays hit, t bit-equal but for counted near ties within 1e-5
    relative, ids up to equal-t ties, the any-hit flag exact; binary-v1
    exactly: ids, t and counters), timed in turns beside it, with its
    counters and bound;
17. sort_impl="counting": counting_order on the card equals it on the CPU
    for the recorded bounce-1 rays' keys, and Renderer.step at 1024x1024,
    5 bounces renders with it (10 launches per sample, by the counters
    and by the profiler on one replay), timed in turns beside
    sort_impl="argsort";
18. the render server (elevenrender_tpu_torch/server/) on the card,
    through the client over localhost: get_sycl_info (the card first,
    probed compatible, the CPU last); a config of 1024x1024, 16 samples,
    native, with no device named (so cuda:0); the main path's camera and
    terrain material as wire JSON, the 32x16 sky as float data, the
    65,522-tri heightfield as OBJ text (14.9 MiB: the C++ tokenizer's
    meshes, timed beside the Python tokenizer's, equal to them); then
    start, get_info and
    get_pass("beauty") round trips timed while the render thread runs,
    and the beauty, normal and denoise passes.  Gates: (a) beauty and
    normal equal a synchronous Renderer.step(16) of the scene an
    in-memory session builds from the same messages (bit for bit, else
    within rtol 1e-5 / atol 1e-6 with the difference printed); (b) the
    denoise pass equals the CPU denoiser on the same raw passes to rtol
    1e-4 / atol 1e-5 on >= 99.9% of values; (c) 5 closest-hit and 5
    any-hit kernel launches per sample, on one stream that is not the
    default stream; (d) the median readback round trip is shorter than
    one chunk of 8 samples; (e) on a second config of 48 samples, pause
    holds the count, a bare start resumes to 48 (timed: the resumed
    render replays the graph the first chunk captured), abort resets to
    0; (f)
    two more scenes over the wire, each of another albedo, one after the
    other: each renders its own scene (bit-equal to Renderer.step(16) of
    it, not the first image); after each, the denoise pass and the
    denoiser on a crop of another size: the reserved memory after the
    second is within 256 MiB of that after the first (the old renderer's
    graphs and pools released) and the denoiser holds one graph per set
    of guides.  The render thread's samples are graph replays on its own
    stream; its launches are the counters' (a replay adds what its
    capture counted), and one replay of the synchronous render's graph
    is counted by the profiler;
19. (a) the host runtime: the heightfield at 318,402 tris (a third of
    config 5's; phase 7 builds config 5 itself with the C++ build)
    through the C++ SAH build and the numpy build, both timed: perm,
    node ranges and max leaf equal, boxes bit-equal; (b) pixel sharding
    over torch.distributed (elevenrender_tpu_torch/parallel/), spawned
    ranks:
    the main path (65,522 tris, 1024x1024, 5 bounces, 4 samples) on 1
    rank over NCCL and on 2 ranks that share the card over gloo, through
    sharded_render_step and gather_image, equal to Renderer.step(4) bit
    for bit, with 5 closest-hit and 5 any-hit launches per sample on
    every rank and each rank's ms/sample and peak memory (the 2 ranks
    share one card: no scaling is measured); the sharded loss and
    gradients at 64x64 on 2 ranks equal one process's within rtol 1e-5;
    every rank's steps are graph replays (the forward step's per-rank
    ms/sample beside the eager step's first measured, the sharded
    gradient's ms a replay);
20. the compiled dispatch (elevenrender_tpu_torch/render/dispatch.py), on
    the main path and config 5 (4 samples each): (a) after a warm-up, one
    eager sample, and the gradient path's eager recording sample and
    vector-Jacobian product (replaying the record and tracing again),
    under torch.cuda.set_sync_debug_mode("error"): no host sync; (b) a
    fresh capture (its warm-up sample and capture, timed together, the
    reserved memory it leaves, beside an eager sample's transient peak),
    then n replays against n eager samples from the same state: passes,
    sample counts and RNG state equal bit for bit; (c) 5 closest-hit and
    5 any-hit launches per sample, by the replay accounting over the n
    replays and by the profiler's kernel names in one replay; (d) on the
    main path, ms/sample of Renderer.step (replays) and of the eager loop
    in turns (eager, graph, graph, eager), then each under the profiler
    (profile_step.profile_forward, in a child process): kernels and
    device ms per sample, the device's busy share (the union of the
    device events' intervals over the profiled wall time) and the device
    time over the unprofiled wall time (config 5's is profile_step
    --scene config5, left out of this run for its length); config 5's IR
    comes back to the card from a host copy for this phase; (e) the
    guided denoiser at 1024x1024: eager with no sync, the graph replay
    equal to it bit for bit, both timed in turns, and the reserved
    memory its capture keeps;
21. the bench (python3 -m elevenrender_tpu_torch.bench) at its full
    shape in a subprocess: it exits 0, its line parses with every number
    finite, no config5_error, and its device is this card; the line is
    printed;
22. inverse rendering, BASELINE config 4
    (elevenrender_tpu_torch/inverse_demo.py), in the main process right
    after phase 14, so that the profiling sessions of phases 17-20 follow
    the gradient graphs of both in one process: (a) the demo's three
    stages at its sizes, with the JAX script's assertions: the Cornell
    wall's albedo at 32x32 (the JAX test's criteria: the last loss below
    half the first, the mean albedo error below the start's), the camera
    rotation by Levenberg-Marquardt with forward-mode Jacobians (error
    below 0.2 deg), the environment tint (error below 0.05); (b) stage 1
    at full width on the main path's scene (1024x1024, 5 bounces), the
    terrain albedo from the scene's own toward [0.2, 0.6, 0.3]:
    INVERSE_STEPS Adam steps of render_loss_and_grad_accum, 8 samples
    and chunk 8 a step.  Gates: the JAX test's criteria; loss and
    gradient finite at every step; captures in the first step only
    (CapturedCall.captures), every later step a replay; 5 + 5 launches a
    pass-1 replay and 0 a pass-2 replay by the accounting, each pass
    counted around it.  Reported: s per Adam step, rays/s, peak
    memory;
23. the applications, each in a subprocess as a user runs it (python3 -m
    elevenrender_tpu_torch.<name>, on the card): (a) render_config5 at
    999,698 tris and 1024x1024 with SPP=48 CKPT=16, once straight through
    and once killed by SIGTERM right after the progress line of its
    16-sample checkpoint, then run again with RESUME=1, one process
    after the other: the two final .npz equal bit for bit (passes,
    samples, rng); (b)
    render_config5 at its defaults (1000 samples, CKPT=64), SIGTERM after
    the 320-sample checkpoint's line, then resumed to 1000.  Gates: the
    killed run exits 0 with 320 samples at every pixel in its .npz, the
    second prints "resumed from ... at 320", the final .npz holds 1000 at
    every pixel and finite passes, the beauty PNG is 1024x1024, 5 + 5
    launches a sample by each process's accounting; reported: set-up s,
    ms/sample, s a checkpoint (the readback, the .npz and PNG in the
    writer thread), the checkpoints' share of the wall, the wall to 1000
    samples, peak memory; (c) denoise_showcase on (b)'s final .npz: its
    float image within rtol 1e-4 / atol 1e-5 of the CPU denoiser on the
    same passes on >= 99.9% of values; its s; (d) demo at its defaults
    (256x256, 32 samples): six PNGs of the right size, the float passes
    behind them finite; 5 + 5
    launches a sample on the heightfield, none on the Cornell box; each
    scene's s; (e) multichip_bench at its defaults (1024x1024, grid 182,
    4 samples): one row at N = 1 and its summary line, 5 + 5 launches a
    sample on its rank; its ms/sample beside phase 19's 1-rank replay.
    (a) and (b) add to row 3's launches, (d) and (e) to rows 1-2.
    ``resume_check`` and ``applications_path`` with small sizes and
    ``device="cpu"`` rehearse it on the CPU.
24. (run after phase 10, where both scenes are built) the hit-data
    kernels (csrc/hitdata.cu) alone, on each scene's camera rays at
    1024x1024 traced: bit-equal to the PyTorch ops on every lane and
    field; each kernel's ms a launch by CUDA events beside its bound
    (the fewest bytes it can move / 3.35 TB/s) and the PyTorch ops' ms
    by graph replay.  Phases 4 and 8 count each kernel's launches, 5 a
    sample.
The last two lines are one JSON object with the kernels' numbers (and
the server path's, the host runtime's and the sharded path's) and one
with the result: {"ok": true, "device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

CONFIG5_TRIS = 999698
# Config 5's set-up time with the numpy SAH build, in the run that first
# built it on the card's host (chip_smoke.py phase 7, NVIDIA H100 80GB
# HBM3, 700.00 W): printed beside this run's set-up time for scale only,
# never carried as a result of this run.
CONFIG5_NUMPY_SETUP_S = 47.9
# The sharded main path's eager step on 1 rank (NCCL), ms/sample, over
# the runs that first measured it (chip_smoke.py phase 19, NVIDIA H100
# 80GB HBM3, 700.00 W): printed beside this run's replays for scale only.
SHARDED_EAGER_MS = "66.4-95.3"
# Ray counts of phase 3's ragged checks: a tail of 31 after 2047 full runs
# of 32, one run and a ray, less than a run, a single ray.
RAGGED = (65535, 33, 31, 1)
# The default variant key of the traversal's launch counts: (order,
# leaf_aabb, leaf_mode, count_steps).
DEFAULT = ("near", 0, "full", False)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def render_variants():
    """The (order, leaf_aabb) variants a render can ask for, the default
    first."""
    from elevenrender_tpu_torch.ops import traverse as tr
    return [(o_, a_) for o_ in tr.ORDERS for a_ in (0, 1, 2)]


def profiled_launches(fn, times=1):
    """(closest-hit, any-hit) launches of the binary kernel that the
    profiler sees on the card in ``times`` calls of ``fn``, each to the
    end of its work: measured, where the launch counters of a graph
    replay repeat what its capture counted; with the number of calls
    made, the device events of one call and its kernels (the device
    events but copies and sets).  Each call is a profiling
    session of its own: a session over several back-to-back replays
    loses device records (PERF.md), and so, now and then, does a
    session of one replay.  Every call replays the same graph,
    so a session that saw fewer device events than the fullest lost
    records: calls go on, up to ``times + 3``, until ``times`` sessions
    (and one more call) saw the fullest count, and the launches are
    those sessions'.  A launch that a replay lacks is lacking in every
    session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from elevenrender_tpu_torch import profile_step
    sessions = []
    while len(sessions) < times + 3:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = profile_step.device_events(prof)
        sessions.append((profile_step.walk_launches(events),
                         sum(e.count for e in events),
                         sum(e.count for e in events
                             if not e.key.startswith(("Memcpy", "Memset")))))
        most = max(k for _, k, _ in sessions)
        full = [got for got, k, _ in sessions if k == most]
        if len(full) >= times and len(sessions) > times:
            break
    else:
        fail(f"the profiler lost device records in "
             f"{len(sessions) - len(full)} of {len(sessions)} sessions of "
             f"one call each")
    got = tuple(map(sum, zip(*full[:times])))
    kernels = next(n for _, k, n in sessions if k == most)
    return got, len(sessions), most, kernels


# Phase 24: the card's memory bandwidth (H100 SXM, the roofline's of
# sweep_traverse.py), the hit-data kernels' bound.
HBM_BYTES_PER_S = 3.35e12


def hitdata_bytes(cfg, ir, hit_idx, mat):
    """The fewest bytes a launch of each hit-data kernel can move on these
    lanes (``hit_idx`` the traced hits, ``mat`` their material ids): what
    each lane reads and writes of its own, and each table row that lanes
    share read once.  The triangle kernel reads a lane's hit id (8) and
    ray (24) and writes five [3] vectors, tu, tv and an int64 material id
    (76); it reads each distinct triangle row at the clamped hit ids
    (160 B) once, so all the misses (row 0) and the lanes that hit one
    triangle share a read.  The material kernel reads a lane's material
    id, tu and tv (16) and, with a normal map, its frame (36), and writes
    albedo, emission (24), the 13 scalars (52) and the mapped normal
    (12); it reads each distinct material row (19 floats and 7 int32
    ids, 104 B) once, and once each texture that a used slot of those
    rows binds, 16 B a texel."""
    import torch

    n = hit_idx.shape[0]
    used = cfg.tex_slots_used
    rows = torch.unique(torch.clamp(hit_idx, min=0)).numel()
    mats = torch.unique(mat)
    tex = ir["materials"]["tex"][mats][:, [s for s, u in enumerate(used)
                                            if u]]
    ids = torch.unique(tex[tex >= 0]).long()
    atlas = ir["atlas"]
    texels = int((atlas["w"][ids].long() * atlas["h"][ids].long()).sum())
    lane = 16 + 24 + 52 + (36 + 12 if used[4] else 0)
    return {"tri": n * (8 + 24 + 76) + 160 * rows,
            "material": n * lane + 104 * mats.numel() + 16 * texels}


def hitdata_path(label, cfg, ir, reps=20):
    """Phase 24: each hit-data kernel (csrc/hitdata.cu) alone, on the
    lanes of the camera rays at full width traced (bounce 0's hits, the
    misses' -1 among them): the kernels' outputs against the PyTorch ops'
    on every lane and field, bit for bit (a NaN where they give NaN);
    each kernel's ms a launch by CUDA events (median of ``reps``) beside
    its bound, the fewest bytes it can move / 3.35 TB/s
    (``hitdata_bytes``), and beside the
    PyTorch ops it stands in for, captured in a CUDA graph and timed by
    replay the same way (the triangle rows and ``full_hit``; the material
    rows, taps, normal map and ^2.2 of ``_generate_hitdata``).  Returns
    {kernel: {"ms", "bound_ms", "share_of_bound", "bytes",
    "pytorch_ms"}} and the lanes."""
    import statistics

    import torch

    from elevenrender_tpu_torch.ops import hitdata as hd_ops
    from elevenrender_tpu_torch.ops.camera import camera_ray
    from elevenrender_tpu_torch.ops.intersect import full_hit, gather_tri
    from elevenrender_tpu_torch.render import integrator

    dev = ir["tris"]["packed"].device
    n = cfg.x_res * cfg.y_res
    idx = torch.arange(n, device=dev)
    half = torch.full((n,), 0.5, device=dev)
    cam = dict(ir["camera"])
    cam["bokeh"] = cfg.bokeh
    o, d = camera_ray(cam, cfg.x_res, cfg.y_res, idx % cfg.x_res,
                      idx // cfg.x_res, half, half, half, half, half)
    o, d = o.contiguous(), d.contiguous()
    with torch.no_grad():
        hit_idx, _ = integrator._trace(cfg, ir, o, d, sort=False)
        got_hit, got_hd = integrator._hitdata(cfg, ir, hit_idx, o, d)
        want_hit = full_hit(o, d, gather_tri(ir["tris"],
                                             torch.clamp(hit_idx, min=0)))
        want_hd = integrator._generate_hitdata(cfg, ir, want_hit, d)
    for where, got, want in (("hit", got_hit, want_hit),
                             ("hd", got_hd, want_hd)):
        for k in got:
            a, b = got[k], want[k]
            if a.is_floating_point():
                nan = torch.isnan(b)
                same = (torch.equal(torch.isnan(a), nan) and torch.equal(
                    a.contiguous().view(torch.int32)[~nan],
                    b.contiguous().view(torch.int32)[~nan]))
            else:
                same = torch.equal(a, b)
            if not same:
                fail(f"{label}: the hit-data kernels' {where}[{k!r}] differs "
                     f"from the PyTorch ops'")
    misses = int((hit_idx < 0).sum())

    def kernel_ms(fn):
        fn()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)

    def graphed(fn):
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(graph):
            fn()
        return graph.replay

    mats, atlas = ir["materials"], ir["atlas"]
    runs = {
        "tri": (lambda: hd_ops.tri(ir["tris"], hit_idx, o, d),
                lambda: full_hit(o, d, gather_tri(
                    ir["tris"], torch.clamp(hit_idx, min=0)))),
        "material": (lambda: hd_ops.material(
            mats, atlas, got_hit, cfg.tex_slots_used,
            cfg.tex_uniform_filter),
            lambda: integrator._generate_hitdata(cfg, ir, want_hit, d)),
    }
    moved = hitdata_bytes(cfg, ir, hit_idx, got_hit["mat"])
    out = {"lanes": n, "misses": misses}
    for name, (kernel, ops) in runs.items():
        with torch.no_grad():
            ms = kernel_ms(kernel)
        ops_ms = kernel_ms(graphed(ops))
        bound = moved[name] / HBM_BYTES_PER_S * 1e3
        out[name] = {"ms": ms, "bound_ms": bound,
                     "share_of_bound": bound / ms, "bytes": moved[name],
                     "pytorch_ms": ops_ms}
        print(f"[hitdata] {label} {name}: {ms:.4f} ms a launch of {n} "
              f"lanes ({misses} misses), bound {bound:.4f} ms "
              f"({moved[name]} B at least, {moved[name] / n:.1f} a lane, "
              f"/ 3.35 TB/s, "
              f"{100 * bound / ms:.1f}% of it); the PyTorch ops it stands "
              f"in for {ops_ms:.3f} ms by graph replay "
              f"({ops_ms / ms:.1f}x); bit-equal on every lane and field")
    return out


# The server phase's scene on the wire: the main path's camera and
# terrain material, the 32x16 sky, the heightfield as OBJ text.
WIRE_CAMERA = {"position": {"x": 0.0, "y": 1.5, "z": -4.0},
               "rotation": {"x": 15.0, "y": 0.0, "z": 0.0},
               "focal_length": 0.035, "sensor_width": 0.036,
               "sensor_height": 0.024, "aperture": 2.8,
               "focus_distance": 1000000.0, "bokeh": False}
WIRE_MATERIAL = {"name": "terrain",
                 "albedo": {"r": 0.55, "g": 0.45, "b": 0.35},
                 "roughness": 0.6, "metalness": 0.1}


# Phase 18 (f): the albedos of the scenes loaded over the wire after the
# first (the first is WIRE_MATERIAL's).
RELOAD_ALBEDOS = ({"r": 0.2, "g": 0.5, "b": 0.8}, {"r": 0.8, "g": 0.3, "b": 0.2})
# The reserved memory a reload may add to the last one's, on the card:
# far below the pool of a captured 1024x1024 sample (~1 GiB), so a
# renderer whose graphs outlive it fails the gate.
RELOAD_SLACK_MIB = 256
# Phase 18 (f): after each reload the denoiser also runs on a crop of
# the image, (height, width) as fractions of the scene's size, another
# size at each reload: a denoiser that kept a graph per size would hold
# one more at each.
RELOAD_DENOISE_SHAPES = ((1.0, 0.75), (0.75, 1.0))


def server_path(res=1024, spp=16, target2=48, grid=182, device=""):
    """Phase 18: the render server on ``device`` ("" = the card, as a
    client that names none gets), driven through the client over
    localhost; see the module docstring.  Fails on any gate but the
    launch counts, which the caller reads from the returned dict
    (``counts``: the traversal wrapper's counts over the 16 samples, a
    replay adding what its capture counted; ``streams``: the CUDA
    streams the eager launches and the graph replays went to;
    ``warmup_streams``: those of the captures' eager warm-ups)."""
    from elevenrender_tpu_torch.core import device as device_mod
    import gc
    import socket
    import threading

    import numpy as np
    import torch

    from elevenrender_tpu_torch.ops import native
    from elevenrender_tpu_torch.ops import traverse as tr
    from elevenrender_tpu_torch.render import denoise as dn
    from elevenrender_tpu_torch.render.integrator import DENOISE
    from elevenrender_tpu_torch.render.renderer import Renderer, find_device
    from elevenrender_tpu_torch.scene.demo import (heightfield_mesh,
                                                   mesh_obj_text, sky_image)
    from elevenrender_tpu_torch.scene import objloader
    from elevenrender_tpu_torch.scene.objloader import load_objs
    from elevenrender_tpu_torch.server import commands
    from elevenrender_tpu_torch.server.client import RenderClient
    from elevenrender_tpu_torch.server.protocol import Message
    from elevenrender_tpu_torch.server.tcp import RenderServer

    dev = find_device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    out = {}
    t0 = time.time()
    obj_text = mesh_obj_text(heightfield_mesh(grid))
    mtl_text = "newmtl terrain\n"
    out["obj_write_s"] = time.time() - t0
    # The route load_objs takes is observed: the calls it makes into the
    # C++ tokenizer are counted (one past objloader.NATIVE_MIN_CHARS,
    # which the full-size text is).
    real_parse = native.parse_obj_native
    parse_calls = []

    def counted_parse(text):
        parse_calls.append(len(text))
        return real_parse(text)

    native.parse_obj_native = counted_parse
    try:
        t0 = time.time()
        meshes, _ = load_objs(obj_text, mtl_text=mtl_text)
        out["obj_parse_s"] = time.time() - t0
    finally:
        native.parse_obj_native = real_parse
    out["obj_parse_route"] = ("c++" if parse_calls == [len(obj_text)]
                              else "python" if not parse_calls
                              else f"{len(parse_calls)} C++ calls")
    n_tris = meshes[0].tri_count
    out["obj_mib"] = len(obj_text) / 2**20
    # Each tokenizer on its own, timed, must give the same meshes (one
    # shape, no normals: face normals both ways).
    parsed = {}
    for route, parse in (("cpp", objloader._load_objs_native),
                         ("python", objloader._load_objs_python)):
        t0 = time.time()
        parsed[route] = parse(obj_text, False)
        out[f"obj_parse_{route}_s"] = time.time() - t0
    a, b = parsed["cpp"], parsed["python"]
    if [m.name for m in a] != [m.name for m in b] or not all(
            np.array_equal(getattr(x, k), getattr(y, k))
            for x, y in zip(a, b)
            for k in ("verts", "normals", "uvs", "tangents",
                      "tangent_signs")) or [m.mat_names for m in a] != \
            [m.mat_names for m in b]:
        fail("server: the C++ tokenizer's meshes differ from the Python "
             "tokenizer's")
    sky = sky_image()

    def config_json(target):
        """What RenderClient.load_config sends."""
        return {"x_res": res, "y_res": res, "sample_target": target,
                "denoise": False, "device": device, "block_size": 8,
                "compat": False}

    def load_scene(c, target):
        c.load_config(res, res, target, device=device, compat=False)
        c.load_camera(WIRE_CAMERA)
        c.load_brdf_material(WIRE_MATERIAL)
        c.load_hdri(sky)
        c.load_object(obj_text, mtl_text)

    def session_messages(target, materials):
        """The scene's messages as an in-memory session takes them."""
        msgs = [("--load_config", [Message.json_msg(config_json(target))]),
                ("--load_camera", [Message.json_msg(WIRE_CAMERA)])]
        msgs += [("--load_brdf_material", [Message.json_msg(m)])
                 for m in materials]
        msgs += [("--load_hdri", [
                    Message.json_msg({"name": "hdri", "width": 32,
                                      "height": 16, "channels": 3,
                                      "color_space": "LINEAR"}),
                    Message.float_data(sky.reshape(-1))]),
                 ("--load_object", [
                    Message("data", "string", obj_text.encode()),
                    Message("data", "string", mtl_text.encode())])]
        return msgs

    def reference_build(target, materials):
        """(config, IR) of the scene an in-memory session builds from the
        same messages."""
        inbox, sent = [], []
        sess = commands.CommandSession(send=sent.append,
                                       recv=lambda: inbox.pop(0))
        msgs = session_messages(target, materials)
        for cmd, payloads in msgs:
            inbox.extend(payloads)
            sess.handle_command(cmd)
        if [m.get_string_data() for m in sent] != ["ok"] * len(msgs) or inbox:
            fail("server: the in-memory session did not take the messages")
        return sess.scene.build(config=sess.config, device=dev)

    def settled_reserved():
        """Reserved device memory with every free cached block released:
        what live tensors and live graphs' pools hold."""
        gc.collect()
        sync()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(dev)

    def wait_for(c, pred, what, limit=600):
        deadline = time.time() + limit
        while True:
            n = c.get_info()["samples"]
            if pred(n):
                return n
            if time.time() > deadline:
                fail(f"server: {what}: still at {n} samples after {limit} s")
            time.sleep(0.005)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    srv = RenderServer("127.0.0.1", port)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    real_launch = tr._launch
    real_replay = torch.cuda.CUDAGraph.replay
    try:
        deadline = time.time() + 30
        while not srv._running:
            if time.time() > deadline:
                fail("server: the acceptor did not start")
            time.sleep(0.01)
        c = RenderClient("127.0.0.1", port, timeout=600)
        devices = c.get_device_info()["devices"]
        out["devices"] = [(d["name"], d["type"], d["is_compatible"])
                          for d in devices]
        d0 = devices[0]
        if devices[-1]["type"] != "cpu" or not all(
                d["is_compatible"] is True for d in devices):
            fail(f"server: get_sycl_info {out['devices']}")
        if cuda and not (d0["type"] == "gpu" and d0["name"].startswith(
                torch.cuda.get_device_name(0))):
            fail(f"server: devices[0] is not the card: {d0}")

        t0 = time.time()
        load_scene(c, spp)
        out["load_s"] = time.time() - t0
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        streams, warmup_streams = set(), set()

        def spy(tables, ray_o, *args, **kw):
            # A capture's launches go to the capture stream and run only
            # on replay: the replay's stream is the one that counts.  A
            # capture's eager warm-up runs on the capture stream too
            # (core.device.CapturedCall.warm_up), kept apart.
            if cuda and not torch.cuda.is_current_stream_capturing():
                stream = torch.cuda.current_stream(ray_o.device).cuda_stream
                capture = device_mod._capture_streams.get(ray_o.device)
                (warmup_streams if capture is not None
                 and stream == capture.cuda_stream else streams).add(stream)
            return real_launch(tables, ray_o, *args, **kw)

        def replay_spy(graph):
            streams.add(torch.cuda.current_stream().cuda_stream)
            return real_replay(graph)

        tr._launch = spy
        torch.cuda.CUDAGraph.replay = replay_spy
        tr.reset_counts()
        t0 = time.time()
        c.start()  # the scene build and upload, then the render thread
        t_render = time.time()
        out["start_s"] = t_render - t0
        info_ms, pass_ms, seen = [], [], []
        while True:
            ta = time.time()
            n = c.get_info()["samples"]
            info_ms.append((time.time() - ta) * 1e3)
            if n >= spp:
                t_done = time.time()
                break
            ta = time.time()
            img = c.get_pass("beauty")
            pass_ms.append((time.time() - ta) * 1e3)
            if img.shape != (res * res * 4,) or not np.isfinite(img).all():
                fail("server: a beauty pass read during the render is not "
                     "finite or has the wrong shape")
            seen.append(n)
            if time.time() - t_render > 600:
                fail(f"server: {n} of {spp} samples after 600 s")
            time.sleep(0.05)  # a client polling, not a busy loop
        tr._launch = real_launch
        torch.cuda.CUDAGraph.replay = real_replay
        out["counts"] = (tr.launches, tr.any_hit_launches,
                         dict(tr.variant_launches))
        out["streams"] = sorted(streams)
        out["warmup_streams"] = sorted(warmup_streams)
        out["default_stream"] = (torch.cuda.default_stream(dev).cuda_stream
                                 if cuda else None)
        out["render_s"] = t_done - t_render
        out["ms_per_sample"] = out["render_s"] / spp * 1e3
        out["chunk_ms"] = out["ms_per_sample"] * min(8, spp)
        out["peak_mib"] = (torch.cuda.max_memory_allocated(dev) / 2**20
                           if cuda else None)
        out["info_ms"] = info_ms
        out["pass_ms"] = pass_ms
        out["samples_seen"] = sorted(set(seen))

        beauty = c.get_pass("beauty")
        normal = c.get_pass("normal")
        ta = time.time()
        den = c.get_pass("denoise")
        out["denoise_round_trip_ms"] = (time.time() - ta) * 1e3
        if not (np.isfinite(beauty).all() and beauty.reshape(-1, 4)[
                :, :3].mean() > 0 and np.isfinite(den).all()):
            fail("server: beauty / denoise not finite with a positive mean")

        # (a) The same messages through an in-memory session, rendered
        # synchronously on the default stream.
        t0 = time.time()
        rcfg, rir = reference_build(spp, [WIRE_MATERIAL])
        sync()
        out["build_s"] = time.time() - t0
        if rir["tris"]["verts"].shape[0] != n_tris:
            fail("server: the in-memory session built another scene")
        ref = Renderer(rcfg, rir)
        tr.reset_counts()
        sync()
        t0 = time.time()
        ref.step(spp)
        sync()
        out["sync_ms_per_sample"] = (time.time() - t0) / spp * 1e3
        out["sync_counts"] = (tr.launches, tr.any_hit_launches)
        # The render thread alone (Renderer.start and join, no server or
        # client in the process): what the thread and its stream cost.
        alone = Renderer(rcfg, rir)
        sync()
        t0 = time.time()
        alone.start(spp)
        alone.join()
        sync()
        out["thread_ms_per_sample"] = (time.time() - t0) / spp * 1e3
        if alone.error is not None or not np.array_equal(
                alone.get_pass("beauty"), ref.get_pass("beauty")):
            fail("server: Renderer.start alone did not render what "
                 "Renderer.step renders")
        del alone
        gaps = {}
        for name, got in (("beauty", beauty), ("normal", normal)):
            want = ref.get_pass(name)
            if np.array_equal(got, want):
                gaps[name] = 0.0
                continue
            gaps[name] = float(np.abs(got - want).max())
            if not np.allclose(got, want, rtol=1e-5, atol=1e-6):
                fail(f"server: (a) the server's {name} pass differs from "
                     f"Renderer.step({spp}) by {gaps[name]:.3g}, beyond "
                     f"rtol 1e-5 / atol 1e-6")
        out["a_max_abs_diff"] = gaps

        # (b) The denoised pass against the CPU denoiser of the same raw
        # passes (the albedo guide from the synchronous render, whose
        # passes are the server's by (a)).
        albedo = ref.state["passes"][DENOISE].reshape(-1).to("cpu")
        t0 = time.time()
        cpu_den = dn.denoise(res, res, torch.tensor(beauty),
                             torch.tensor(normal), albedo).numpy()
        out["denoise_cpu_s"] = time.time() - t0
        close = float(np.isclose(den, cpu_den, rtol=1e-4, atol=1e-5).mean())
        out["b_close"] = close
        out["b_max_abs_diff"] = float(np.abs(den - cpu_den).max())
        if close < 0.999:
            fail(f"server: (b) the denoised pass matches the CPU denoiser "
                 f"on {close * 100:.3f}% of values")
        if cuda:
            args = [torch.tensor(x, device=dev)
                    for x in (beauty, normal, albedo.numpy())]
            dn.denoise(res, res, *args)
            times = []
            for _ in range(3):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                dn.denoise(res, res, *args)
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            out["denoise_ms"] = float(np.median(times))
            # One more replay of the synchronous render's graph (the same
            # config and scene as the server's), its launches counted by
            # the profiler.
            out["sync_profiled"] = profiled_launches(lambda: ref.step(1))[0]
        del ref, rir

        # (e) pause, resume and abort on a longer target (a new config:
        # the scene is built again).
        c.load_config(res, res, target2, device=device, compat=False)
        c.start()
        wait_for(c, lambda n: n >= 1, "the second render")
        c.pause()
        s1 = c.get_info()["samples"]
        if not 1 <= s1 < target2:
            fail(f"server: (e) paused at {s1} of {target2} samples")
        time.sleep(0.5)
        if c.get_info()["samples"] != s1:
            fail("server: (e) the sample count moved while paused")
        t0 = time.time()
        c.start()
        wait_for(c, lambda n: n >= target2, "the resumed render")
        # The resumed render replays the graph its first chunk captured,
        # with get_info polled every ~5 ms and no pass read meanwhile.
        out["resume_ms_per_sample"] = (time.time() - t0) / (target2 - s1) * 1e3
        time.sleep(0.2)
        s2 = c.get_info()["samples"]
        c.abort()
        s3 = c.get_info()["samples"]
        out["pause"] = (s1, s2, s3)
        if s2 != target2 or s3 != 0:
            fail(f"server: (e) resumed to {s2} of {target2}, abort left {s3}")

        # (f) Scenes of other albedos over the wire, one after the other:
        # each reload renders its own scene (equal to a synchronous
        # render of it, not the first scene's image), and releases the
        # last renderer's graphs and pools.
        materials = [WIRE_MATERIAL]
        reserved, denoisers = [], []
        for albedo, (fh, fw) in zip(RELOAD_ALBEDOS, RELOAD_DENOISE_SHAPES):
            materials.append({**WIRE_MATERIAL, "albedo": albedo})
            c.load_config(res, res, spp, device=device, compat=False)
            c.load_brdf_material(materials[-1])
            c.start()
            wait_for(c, lambda n: n >= spp, "a reloaded scene's render")
            got = c.get_pass("beauty")
            # The denoiser at the scene's size (over the wire), then at
            # another size, guided and colour only, on a crop.
            c.get_pass("denoise")
            h2, w2 = int(res * fh), int(res * fw)
            crop = [torch.tensor(x, device=dev).reshape(res, res, 4)[
                :h2, :w2].reshape(-1).clone()
                for x in (got, c.get_pass("normal"))]
            dn.denoise(w2, h2, crop[0], crop[1], crop[0])
            dn.denoise(w2, h2, crop[0])
            denoisers.append(len(dn._graphs))
            if cuda:
                reserved.append(settled_reserved() / 2**20)
            if np.array_equal(got, beauty):
                fail("server: (f) a reloaded scene rendered the first "
                     "scene's image")
            rcfg, rir = reference_build(spp, materials)
            ref = Renderer(rcfg, rir)
            ref.step(spp)
            if not np.array_equal(got, ref.get_pass("beauty")):
                fail(f"server: (f) the scene of albedo {albedo} over the "
                     f"wire differs from Renderer.step({spp}) of it")
            del ref, rir
        out["reload_reserved_mib"] = reserved
        if cuda and reserved[1] > reserved[0] + RELOAD_SLACK_MIB:
            fail(f"server: (f) reserved memory grew from {reserved[0]:.0f} "
                 f"to {reserved[1]:.0f} MiB over a reload: the last "
                 f"renderer's graphs or a denoiser's were not released")
        out["reload_denoisers"] = denoisers
        if cuda and max(denoisers) > 2:
            fail(f"server: (f) the denoiser holds {denoisers} captured "
                 f"graphs after each reload, more than one per set of "
                 f"guides")
        c.close()
    finally:
        tr._launch = real_launch
        torch.cuda.CUDAGraph.replay = real_replay
        srv.shutdown()
        th.join(30)
    if th.is_alive():
        fail("server: the acceptor thread did not stop")
    return out


# Phase 19 (a)'s heightfield: 318,402 tris, a third of config 5's
# 999,698, where the numpy build takes about 15 s, not 37-52 s.
HOST_GRID = 400


def host_runtime_path(grid=HOST_GRID):
    """Phase 19 (a): the heightfield's tris (grid HOST_GRID) through the
    C++ SAH build and the numpy build, both timed; fails unless perm,
    node ranges and max leaf are equal and the boxes bit-equal."""
    import numpy as np

    from elevenrender_tpu_torch.ops.bvh import build_bvh
    from elevenrender_tpu_torch.scene.demo import heightfield_tris

    verts = heightfield_tris(grid)
    out = {"tris": int(verts.shape[0])}
    t0 = time.time()
    cpp = build_bvh(verts, use_native=True)
    out["bvh_cpp_s"] = time.time() - t0
    t0 = time.time()
    plain = build_bvh(verts, use_native=False)
    out["bvh_numpy_s"] = time.time() - t0
    for k in ("perm", "node_from", "node_to"):
        if not np.array_equal(cpp[k], plain[k]):
            fail(f"host runtime: the C++ build's {k} differs from numpy's")
    for k in ("node_bmin", "node_bmax"):
        if not np.array_equal(cpp[k].view(np.uint32),
                              plain[k].view(np.uint32)):
            fail(f"host runtime: the C++ build's {k} is not bit-equal")
    if (cpp["depth"], cpp["max_leaf"]) != (plain["depth"], plain["max_leaf"]):
        fail("host runtime: depth or max leaf differ")
    out["depth"], out["max_leaf"] = cpp["depth"], cpp["max_leaf"]
    return out


def sharded_path(grid=182, res=1024, spp=4, grad_res=64, grad_spp=2,
                 device="cuda", renderer_passes=None):
    """Phase 19 (b): the main path through the sharded step on spawned
    ranks, 1 over NCCL and 2 sharing the card over gloo (on the CPU: 1
    and 2 over gloo), each gathered image equal to ``renderer_passes``
    (Renderer.step(spp) of the same scene, [P, npix, 4]) bit for bit;
    then the sharded loss and gradients at ``grad_res`` on 2 ranks
    against one process (rtol 1e-5).  Returns each run's per-rank
    numbers; the launch-count gates live in ``main``."""
    import numpy as np

    from elevenrender_tpu_torch.parallel import dryrun
    from elevenrender_tpu_torch.parallel import mesh as pm

    render = {"kind": "render", "scene": "heightfield", "grid": grid,
              "res": res, "bounces": 5, "samples": spp, "warmup": True}
    grad = {"kind": "grad", "scene": "heightfield", "grid": grid,
            "res": grad_res, "bounces": 5, "samples": grad_spp,
            "warmup": True}
    cuda = device != "cpu"
    out = {}
    for label, world, backend, tasks in (
            ("n1_nccl" if cuda else "n1_gloo", 1, None, [render]),
            ("n2_gloo", 2, "gloo", [render, grad])):
        t0 = time.time()
        ranks = dryrun.run_ranks(tasks, world, device, backend,
                                 timeout=600)
        got = ranks[0][0]["passes"]
        if any(r[0]["passes"] is not None for r in ranks[1:]):
            fail(f"sharding {label}: an image was gathered off rank 0")
        if not np.isfinite(got).all() or not got[0, :, :3].mean() > 0:
            fail(f"sharding {label}: the gathered image is not finite and "
                 f"lit")
        diff = (0.0 if np.array_equal(got, renderer_passes)
                else float(np.abs(got - renderer_passes).max()))
        if diff:
            fail(f"sharding {label}: the gathered passes differ from "
                 f"Renderer.step({spp}) by {diff:.3g}")
        out[label] = {
            "wall_s": time.time() - t0,
            "ranks": [{k: r[0][k] for k in ("ms_per_sample", "peak_mib",
                                           "launches")} for r in ranks]}
        if len(tasks) > 1:
            alone = dryrun.run_tasks(pm.make_mesh(device=device), [grad])[0]
            loss = ranks[0][1]["loss"]
            rel = abs(loss - alone["loss"]) / abs(alone["loss"])
            worst = 0.0
            for k, want in alone["grads"]["materials"].items():
                for r in ranks:
                    g = r[1]["grads"]["materials"][k]
                    scale = max(float(np.abs(want).max()), 1e-30)
                    worst = max(worst, float(np.abs(g - want).max()) / scale)
                    if not np.allclose(g, want, rtol=1e-5,
                                       atol=1e-5 * scale):
                        fail(f"sharding {label}: gradient {k} differs from "
                             f"one process's beyond rtol 1e-5")
            if rel > 1e-5 or not np.isfinite(loss):
                fail(f"sharding {label}: loss {loss} against one process's "
                     f"{alone['loss']}")
            out[label]["grad"] = {"res": grad_res, "samples": grad_spp,
                                  "loss": loss, "loss_alone": alone["loss"],
                                  "loss_rel_diff": rel,
                                  "grad_max_diff_over_leaf_max": worst,
                                  "ms_per_rank": [r[1]["ms"] for r in ranks],
                                  "ms_alone": alone["ms"]}
    return out


# Phase 9 (b): config 5's rows rendered on the card and the CPU, and the
# samples each row is followed for.
STRIPE_ROWS, STRIPE_SAMPLES = (256, 2), 6


def stripe_card_vs_cpu(label, cfg, ir_, rows=STRIPE_ROWS,
                       samples=STRIPE_SAMPLES, device="cuda"):
    """Phase 9 (b): the rows [rows[0], rows[0] + rows[1]) of ``cfg``'s
    image at full width, rendered eagerly one sample at a time on
    ``device`` and on the CPU (``integrator.render_sample`` at their
    pixel offset, from the same fresh state).  After each sample: the
    share of pixels whose accumulated beauty agrees within rtol 1e-4 /
    atol 1e-5, and the share whose RNG state is equal (a pixel's RNG
    advances once per draw of a path that is alive, so an equal state
    after k samples means k paths of the same length and branches).
    Fails unless the first sample agrees on >= 99% of pixels, as phase
    9 (a) gates.  Returns the two lists."""
    import numpy as np
    import torch

    from elevenrender_tpu_torch.convert import ir_to
    from elevenrender_tpu_torch.render import integrator

    off, n = rows[0] * cfg.x_res, rows[1] * cfg.x_res
    start = integrator.init_state(cfg, "cpu")
    start = {"passes": start["passes"][:, off:off + n].clone(),
             "samples": start["samples"][off:off + n].clone(),
             "rng": start["rng"][off:off + n].clone()}
    states = {"cpu": start,
              device: {k: v.to(device) for k, v in start.items()}}
    irs = {"cpu": ir_to(ir_, "cpu"), device: ir_}
    close, same_rng = [], []
    t0 = time.time()
    with torch.no_grad():
        for _ in range(samples):
            for dev, st in states.items():
                states[dev] = integrator.render_sample(cfg, irs[dev], st, off,
                                                       device=dev)
            a, b = (states[d]["passes"][0, :, :3].cpu().numpy()
                    for d in (device, "cpu"))
            close.append(float(np.isclose(a, b, rtol=1e-4, atol=1e-5)
                               .all(-1).mean()))
            same_rng.append(float((states[device]["rng"].cpu()
                                   == states["cpu"]["rng"]).float().mean()))
    print(f"[parity] {label} rows {rows[0]}-{rows[0] + rows[1] - 1} "
          f"({n} pixels) at full width, card vs CPU, samples 1-{samples}: "
          f"pixels within rtol 1e-4 / atol 1e-5 "
          f"{[round(x, 4) for x in close]}, RNG state equal "
          f"{[round(x, 4) for x in same_rng]} ({time.time() - t0:.1f} s)")
    if close[0] < 0.99:
        fail(f"{label}: the card and the CPU agree on {close[0] * 100:.2f}% "
             f"of the rows' pixels after one sample")
    return {"rows": list(rows), "pixels_close": close,
            "rng_equal": same_rng}


def make_target(cfg, ir_, device):
    """A target [npix, 3]: one sample's beauty pass x 1.5 + 0.1."""
    import torch

    from elevenrender_tpu_torch.render import integrator
    with torch.no_grad():
        st = integrator.render_sample(
            cfg, ir_, integrator.init_state(cfg, device), device=device)
    return st["passes"][integrator.BEAUTY, :, :3] * 1.5 + 0.1


def drop_captures(ir_, cfg_=None):
    """Free the captures (and parameter buffers) cached for ``ir_``,
    or only those of ``cfg_``, with their pools."""
    import gc

    import torch

    from elevenrender_tpu_torch.render import dispatch
    entries = dispatch._graphs.get(ir_["tris"]["verts"], {})
    for key in [k for k in entries if cfg_ is None or cfg_ in k[0]]:
        del entries[key]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def grad_gap(got, want):
    """The largest |got - want| over the material leaves, each over
    its leaf's largest entry."""
    worst = 0.0
    for k, v in want["materials"].items():
        scale = max(float(v.abs().max()), 1e-30)
        worst = max(worst, float((got["materials"][k] - v).abs().max())
                    / scale)
    return worst


def same_pass1(label, got, want):
    """Pass 1 by replay against the eager loop: loss, state and every
    recorded trace bit-equal."""
    import torch
    loss_, caches_, state_ = got
    e_loss_, e_caches_, e_state_ = want
    if float(loss_) != float(e_loss_):
        fail(f"{label}: pass 1's loss {float(loss_)} by replay, "
             f"{float(e_loss_)} eager")
    for k in ("passes", "samples", "rng"):
        if not torch.equal(state_[k], e_state_[k]):
            fail(f"{label}: pass 1's {k} by replay differs from eager")
    for k in e_caches_[0]:
        if not torch.equal(torch.cat([c[k] for c in caches_]),
                           torch.stack([c[k] for c in e_caches_])):
            fail(f"{label}: pass 1's recorded {k} by replay differs "
                 f"from eager")


# Phase 14's samples a fwd+bwd on the main path.
GRAD_SAMPLES = 8


def gradient_at_full_width(cfg, ir_, launch_log, prof):
    """Phase 14 on the main path: fwd_bwd_step_accum at full width,
    GRAD_SAMPLES samples, default RenderConfig (material_fetch="mm_bwd",
    pass 2 replaying pass 1's records), by graph replay against the
    eager loops of its passes; see the module docstring.  ``prof``:
    profile_step's profile of it (GRAD_SAMPLES samples).  Appends
    (label, expected, counted) launches by variant to ``launch_log``.
    Returns (its numbers, {(order, leaf_aabb): (closest-hit, any-hit)
    launches of the graph runs})."""
    import torch

    from elevenrender_tpu_torch import profile_step
    from elevenrender_tpu_torch.ops import traverse as tr
    from elevenrender_tpu_torch.render import dispatch
    from elevenrender_tpu_torch.render import grad as grad_mod

    n = GRAD_SAMPLES
    res = cfg.x_res
    if cfg.material_fetch != "mm_bwd" or cfg.remat_bounces:
        fail("the gradient path is to run the default RenderConfig")
    target = make_target(cfg, ir_, "cuda")
    dev = target.device
    params = {"materials": grad_mod.float_subtree(ir_["materials"])}
    rays = 2 * cfg.max_bounces * res * res
    out = {"samples": n}
    # (a) The eager loops, the reference, from the same inputs.
    torch.cuda.reset_peak_memory_stats()
    (e_loss, e_seed, e_caches, e_state), _ = profile_step.wall(
        grad_mod._accum_fwd, cfg, ir_, params, target, n, True, dev)
    (e_grads, e_rng), _ = profile_step.wall(
        grad_mod._accum_bwd, cfg, ir_, params, e_seed, e_caches, n, dev)
    out["eager_peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    # (b) The graph form's first call, pass by pass: each pass's
    # warm-up and capture, and the reserved memory it keeps.
    drop_captures(ir_)
    r0 = torch.cuda.memory_reserved()
    buffers = grad_mod.static_params(ir_, params, dev)
    merged = grad_mod._merge(ir_, buffers)
    tr.reset_counts()
    (loss, seed, caches, state), first1 = profile_step.wall(
        grad_mod._accum_fwd_chunked, cfg, merged, target, n, n, True,
        dev)
    counted1 = (tr.launches - tr.any_hit_launches, tr.any_hit_launches)
    variants1 = dict(tr.variant_launches)
    torch.cuda.empty_cache()
    r1 = torch.cuda.memory_reserved()
    same_pass1("gradient path", (loss, caches, state),
               (e_loss, e_caches, e_state))
    tr.reset_counts()
    (grads, rng), first2 = profile_step.wall(
        grad_mod._accum_bwd_chunked, cfg, ir_, buffers, seed, caches, n, n,
        dev)
    counted2 = (tr.launches - tr.any_hit_launches, tr.any_hit_launches)
    torch.cuda.empty_cache()
    r2 = torch.cuda.memory_reserved()
    record_mib = sum(v.numel() * v.element_size() for c in caches
                     for v in c.values()) / 2**20
    out.update(
        first_call_s={"pass1": first1, "pass2": first2},
        reserved_after_pass1_mib=(r1 - r0) / 2**20,
        record_mib=record_mib,
        reserved_by_pass2_mib=(r2 - r1) / 2**20,
        first_gap=grad_gap(grads, e_grads))
    if not torch.equal(rng, e_rng):
        fail("gradient path: pass 2's final RNG state by replay differs "
             "from eager")
    if not out["first_gap"] <= 1e-5:
        fail(f"gradient path: pass 2 by replay differs from eager by "
             f"{out['first_gap']:.3g} of a leaf's largest entry")
    # (c) chunk = 1, 3, 8: the same captures, the same results.
    out["chunk_gap"] = {}
    for chunk in (1, 3, 8):
        tr.reset_counts()
        c_loss, _, c_caches, c_state = grad_mod._accum_fwd_chunked(
            cfg, merged, target, n, chunk, True, dev)
        same_pass1(f"gradient path, chunk={chunk}",
                   (c_loss, c_caches, c_state),
                   (e_loss, e_caches, e_state))
        c_grads, c_rng = grad_mod._accum_bwd_chunked(
            cfg, ir_, buffers, seed, c_caches, n, chunk, dev)
        torch.cuda.synchronize()
        if (tr.launches, tr.any_hit_launches) != (10 * n, 5 * n):
            fail(f"gradient path, chunk={chunk}: {tr.launches} launches")
        out["chunk_gap"][chunk] = grad_gap(c_grads, e_grads)
        if not (torch.equal(c_rng, e_rng)
                and out["chunk_gap"][chunk] <= 1e-5):
            fail(f"gradient path, chunk={chunk}: RNG or gradients "
                 f"differ from eager's")
    # (d) launches by the accounting of these replays (the profiler's
    # count per replay comes from (g), in profile_grad's child).
    # (e) cache_traces=False: pass 2 traces every sample again.
    tr.reset_counts()
    r_loss, r_grads = grad_mod.render_loss_and_grad_accum(
        cfg, ir_, params, target, n, cache_traces=False)
    torch.cuda.synchronize()
    counted_rt = (tr.launches - tr.any_hit_launches, tr.any_hit_launches)
    out["retrace_gap"] = grad_gap(r_grads, e_grads)
    if float(r_loss) != float(e_loss) or not out["retrace_gap"] <= 1e-5:
        fail(f"gradient path, cache_traces=False: loss {float(r_loss)} "
             f"(eager {float(e_loss)}), gradients differ by "
             f"{out['retrace_gap']:.3g}")
    out["launches_counted"] = {"pass1": counted1, "pass2": counted2,
                               "retrace": counted_rt}
    out["launches_per_replay"] = {
        "pass1": tuple(c // n for c in counted1),
        "pass2": tuple(c // n for c in counted2),
        "pass2_retrace": tuple((r - c) // n
                               for r, c in zip(counted_rt, counted1))}
    if (counted1 != (5 * n, 5 * n) or counted2 != (0, 0)
            or counted_rt != (10 * n, 10 * n)):
        fail(f"gradient path: launches (closest-hit, any-hit) counted "
             f"{out['launches_counted']}; expected 5 + 5 a pass-1 "
             f"replay, 0 a pass-2 replay, 5 + 5 a re-traced one")
    # (f) New parameter values (the albedo halved): no new capture,
    # eager's result for those values.
    anchor = ir_["tris"]["verts"]
    before = {k: (e, getattr(getattr(e, "_call", e), "graph", None))
              for k, e in dispatch._graphs[anchor].items()}
    half = {"materials": {k: (v * 0.5 if k == "albedo" else v.clone())
                          for k, v in params["materials"].items()}}
    h_loss, h_grads = grad_mod.render_loss_and_grad_accum(
        cfg, ir_, half, target, n)
    after = {k: (e, getattr(getattr(e, "_call", e), "graph", None))
             for k, e in dispatch._graphs[anchor].items()}
    he_loss, he_seed, he_caches, _ = grad_mod._accum_fwd(
        cfg, ir_, half, target, n, True, dev)
    he_grads, _ = grad_mod._accum_bwd(cfg, ir_, half, he_seed, he_caches,
                                      n, dev)
    del he_caches
    out["new_values_gap"] = grad_gap(h_grads, he_grads)
    if (after.keys() != before.keys()
            or any(after[k][0] is not v[0] or after[k][1] is not v[1]
                   for k, v in before.items())):
        fail("gradient path: new parameter values made a new capture")
    if (float(h_loss) != float(he_loss) or float(h_loss) == float(e_loss)
            or not out["new_values_gap"] <= 1e-5):
        fail(f"gradient path: the halved albedo's loss {float(h_loss)} "
             f"(eager {float(he_loss)}) or gradients (gap "
             f"{out['new_values_gap']:.3g}) differ")
    del caches, e_caches, seed, state
    # (g) s per fwd+bwd in turns, each pass's ms/sample and busy, and the
    # launches of one replay of each graph by the profiler (``prof``,
    # from profile_grad's child process and its own captures).
    for name, part in (("graph", "pass1"), ("graph", "pass2"),
                       ("graph", "pass2_retrace"), ("eager", "pass1"),
                       ("eager", "pass2")):
        if prof[name][part] is None:
            fail(f"gradient path: the profiler recorded no device "
                 f"time for the {name} {part}")
    out["turns"] = prof
    out["launches_profiled_in_child"] = {
        k: tuple(prof["graph"][k]["launches"])
        for k in ("pass1", "pass2", "pass2_retrace")}
    if out["launches_profiled_in_child"] != {
            "pass1": (5, 5), "pass2": (0, 0), "pass2_retrace": (5, 5)}:
        fail(f"gradient path: launches (closest-hit, any-hit) profiled "
             f"per replay in profile_grad's child "
             f"{out['launches_profiled_in_child']}; expected 5 + 5 a "
             f"pass-1 replay, 0 a pass-2 replay, 5 + 5 a re-traced one")
    g, e = prof["graph"], prof["eager"]
    print(f"[gradient] fwd_bwd_step_accum {res}x{res}, "
          f"{cfg.max_bounces} bounces, {n} samples, material_fetch="
          f"{cfg.material_fetch}, by graph replay: pass 1 state, loss and "
          f"every record bit-equal to the eager loop's; pass 2 "
          f"gradients within {out['first_gap']:.3g} of a leaf's largest "
          f"entry (chunk 1 / 3 / 8: {out['chunk_gap']}), the final RNG "
          f"bit-equal; cache_traces=False within "
          f"{out['retrace_gap']:.3g}; launches (closest-hit, any-hit) "
          f"counted {out['launches_counted']}, profiled per replay in "
          f"profile_grad's child {out['launches_profiled_in_child']}")
    print(f"[gradient] s per fwd+bwd in turns (eager, graph, graph, "
          f"eager): graph {[round(x, 4) for x in g['s']]}, eager "
          f"{[round(x, 4) for x in e['s']]}; rays/s "
          f"{rays * n / min(g['s']):.4g} by replay, "
          f"{rays * n / min(e['s']):.4g} eager; ms/sample pass 1 "
          f"{g['pass1']['ms_per_sample']:.1f} / "
          f"{e['pass1']['ms_per_sample']:.1f} eager, pass 2 "
          f"{g['pass2']['ms_per_sample']:.1f} / "
          f"{e['pass2']['ms_per_sample']:.1f}; busy pass 1 "
          f"{g['pass1']['busy'] * 100:.1f}% / "
          f"{e['pass1']['busy'] * 100:.1f}%, pass 2 "
          f"{g['pass2']['busy'] * 100:.1f}% / "
          f"{e['pass2']['busy'] * 100:.1f}%; device over unprofiled "
          f"wall pass 1 {g['pass1']['device_over_unprofiled'] * 100:.1f}"
          f"% / {e['pass1']['device_over_unprofiled'] * 100:.1f}%, pass "
          f"2 {g['pass2']['device_over_unprofiled'] * 100:.1f}% / "
          f"{e['pass2']['device_over_unprofiled'] * 100:.1f}%")
    print(f"[gradient] first call s (warm-up, capture, replays) "
          f"{out['first_call_s']}; reserved after pass 1's capture +"
          f"{out['reserved_after_pass1_mib']:.0f} MiB (its records "
          f"{record_mib:.0f} MiB), by pass 2's +"
          f"{out['reserved_by_pass2_mib']:.0f} MiB; peak allocated "
          f"{prof['peak_mib']:.0f} MiB by replay, "
          f"{out['eager_peak_mib']:.0f} eager; the halved albedo "
          f"replayed the same captures, within "
          f"{out['new_values_gap']:.3g} of eager's")
    launches = {("near", 0): counted1}
    launch_log.append(("gradient path", {DEFAULT: 10 * n}, variants1))
    # (h) Every other (order, leaf_aabb) variant, 2 samples by replay,
    # its captures freed after it.
    nv = 2
    base_loss, base_grads = grad_mod.fwd_bwd_step_accum(cfg, ir_, target,
                                                        nv)
    for order, leaf_aabb in render_variants()[1:]:
        cfg_v = cfg.replace(trace_order=order, leaf_aabb=leaf_aabb)
        grad_mod.fwd_bwd_step_accum(cfg_v, ir_, target, nv)  # capture
        tr.reset_counts()
        v_loss, v_grads = grad_mod.fwd_bwd_step_accum(cfg_v, ir_, target,
                                                      nv)
        torch.cuda.synchronize()
        key = (order, leaf_aabb, "full", False)
        launch_log.append((f"gradient path under {key}", {key: 10 * nv},
                           dict(tr.variant_launches)))
        launches[(order, leaf_aabb)] = (
            tr.launches - tr.any_hit_launches, tr.any_hit_launches)
        drop_captures(ir_, cfg_v)
        # Same hits but for equal-t ties: the loss to 1e-4 relative,
        # the albedo gradient to 1e-4 of its largest entry.
        rel = abs(float(v_loss) - float(base_loss)) / float(base_loss)
        if not rel <= 1e-4:
            fail(f"gradient path under {key}: loss differs by {rel:.3g}")
        base_albedo = base_grads["materials"]["albedo"]
        gap = float((v_grads["materials"]["albedo"]
                     - base_albedo).abs().max())
        if not gap <= 1e-4 * float(base_albedo.abs().max()):
            fail(f"gradient path under {key}: albedo gradient differs "
                 f"by {gap:.3g}")
        print(f"[gradient] trace_order={order} leaf_aabb={leaf_aabb}, "
              f"{nv} samples by replay: loss {float(v_loss):.8f} "
              f"(default {float(base_loss):.8f}), albedo gradient "
              f"differs by {gap:.3g}; {10 * nv} launches of this variant")
    # (i) remat_bounces at 64x64, 4 samples, by replay.
    cfg64 = cfg.replace(x_res=64, y_res=64)
    t64 = make_target(cfg64, ir_, "cuda")
    got = {}
    for remat in (False, True):
        c_ = cfg64.replace(remat_bounces=remat)
        grad_mod.fwd_bwd_step_accum(c_, ir_, t64, 4)  # capture
        got[remat] = grad_mod.fwd_bwd_step_accum(c_, ir_, t64, 4)
    out["remat_gap"] = grad_gap(got[True][1], got[False][1])
    if (float(got[True][0]) != float(got[False][0])
            or not out["remat_gap"] <= 1e-5):
        fail(f"gradient path, remat_bounces at 64x64: loss "
             f"{float(got[True][0])} against {float(got[False][0])}, "
             f"gradients differ by {out['remat_gap']:.3g}")
    print(f"[gradient] remat_bounces=True at 64x64, 4 samples by replay: "
          f"the same loss, gradients within {out['remat_gap']:.3g}")
    drop_captures(ir_)
    return out, launches


def config5_gradient(cfg5, ir5, launch_log):
    """Phase 14, config 5: fwd_bwd_step_accum at 999,698 tris, 1024x1024,
    4 samples, by replay after a first call that captures: finite,
    non-zero gradients, 5 + 5 launches a sample over both passes by the
    accounting (pass 1's 5 + 5, so none in pass 2); its s and peak
    memory.  Appends its launches by variant to ``launch_log``."""
    import torch

    from elevenrender_tpu_torch import profile_step
    from elevenrender_tpu_torch.ops import traverse as tr
    from elevenrender_tpu_torch.render import grad as grad_mod

    n = 4
    res = cfg5.x_res
    target = make_target(cfg5, ir5, "cuda")
    (_, _), first_s = profile_step.wall(
        grad_mod.fwd_bwd_step_accum, cfg5, ir5, target, n)
    torch.cuda.reset_peak_memory_stats()
    tr.reset_counts()
    (loss, grads), s = profile_step.wall(
        grad_mod.fwd_bwd_step_accum, cfg5, ir5, target, n)
    counted = (tr.launches - tr.any_hit_launches, tr.any_hit_launches)
    variants = dict(tr.variant_launches)
    peak = torch.cuda.max_memory_allocated() / 2**20
    g = grads["materials"]
    finite = all(bool(torch.isfinite(v).all()) for v in g.values())
    nonzero = [k for k, v in g.items() if float(v.abs().sum()) > 0]
    out = {"samples": n, "first_s": first_s, "s": s,
           "rays_per_s": 2 * cfg5.max_bounces * res * res * n / s,
           "peak_mib": peak, "loss": float(loss),
           "launches_counted": counted, "nonzero_leaves": nonzero}
    print(f"[gradient] config 5 ({ir5['tris']['verts'].shape[0]} tris, "
          f"textures, a point light) fwd_bwd_step_accum {res}x{res}, "
          f"{n} samples by replay: {s:.3f} s per fwd+bwd "
          f"({out['rays_per_s']:.4g} rays/s; the first call, with its "
          f"warm-ups and captures, {first_s:.3f} s), peak allocated "
          f"{peak:.0f} MiB, loss {float(loss):.8f}, finite {finite}, "
          f"non-zero leaves {nonzero}; launches (closest-hit, any-hit) "
          f"counted {counted}")
    if not (finite and nonzero and bool(torch.isfinite(loss))):
        fail("config 5 gradient: not finite and non-zero")
    if counted != (5 * n, 5 * n):
        fail(f"config 5 gradient: launches counted {counted}, expected "
             f"5 + 5 a sample")
    launch_log.append(("config 5 gradient", {DEFAULT: 10 * n}, variants))
    drop_captures(ir5)
    return out


# Phase 22 (b): Adam steps of the full-width albedo loop, and the samples
# of each step's accumulated gradient (chunk 8: one chunk a pass).
INVERSE_STEPS = 24
INVERSE_SAMPLES = 8


def inverse_path(cfg, ir_, outdir):
    """Phase 22: BASELINE config 4, inverse rendering
    (``elevenrender_tpu_torch/inverse_demo.py``) on the card, in the main
    process; see the module docstring.  Returns (its numbers, the
    traversal launches (closest-hit, any-hit) of the phase, its launches
    by variant)."""
    import numpy as np
    import torch

    from elevenrender_tpu_torch import inverse_demo as inv
    from elevenrender_tpu_torch.core.device import CapturedCall
    from elevenrender_tpu_torch.ops import traverse as tr
    from elevenrender_tpu_torch.render import dispatch
    from elevenrender_tpu_torch.render import grad as grad_mod

    def counts():
        return tr.launches - tr.any_hit_launches, tr.any_hit_launches

    out = {}
    tr.reset_counts()
    # (a) The three stages at the demo's sizes, with its assertions.
    lines = []
    t0 = time.time()
    try:
        demo = inv.run(outdir, "cuda", log=lines.append)
    except RuntimeError as e:
        fail(f"inverse rendering at the demo's sizes: {e}; the last lines: "
             f"{lines[-4:]}")
    out["demo_s"] = time.time() - t0
    alb, cam, tint = demo["albedo"], demo["camera"], demo["tint"]
    out["demo"] = {
        "albedo": {"first_loss": alb["losses"][0],
                   "last_loss": alb["losses"][-1],
                   "recovered": alb["albedos"][-1].tolist(),
                   "target": alb["target"].tolist()},
        "rotation_err_deg": cam["err"],
        "tint": {"recovered": tint["tints"][-1].tolist(),
                 "err": tint["err"]}}
    demo_launches = counts()
    demo_variants = dict(tr.variant_launches)
    print(f"[inverse] the demo's stages on the card in {out['demo_s']:.1f} "
          f"s: albedo (Cornell 32x32, 2 samples, 100 Adam steps) "
          f"{alb['albedos'][-1]} for {alb['target']}, loss "
          f"{alb['losses'][0]:.6f} -> {alb['losses'][-1]:.6f}; rotation "
          f"(Levenberg-Marquardt, forward-mode Jacobians) within "
          f"{cam['err']:.4f} deg; tint {tint['tints'][-1]} within "
          f"{tint['err']:.4f}; traversal launches (closest-hit, any-hit) "
          f"{demo_launches}; {lines[-1].strip()}")
    if not inv.recovered(alb):
        fail("inverse rendering: stage 1 at 32x32 missed the JAX test's "
             "criteria")
    if not demo_launches[0] > 0:
        fail("inverse rendering: stage 2 launched no traversal")

    # (b) Stage 1 at full width through render_loss_and_grad_accum, each
    # pass's launches counted around it.
    n = INVERSE_SAMPLES
    res = cfg.x_res
    drop_captures(ir_)
    tr.reset_counts()
    passes, steps = {}, []
    real = {"pass1": grad_mod._accum_fwd_chunked,
            "pass2": grad_mod._accum_bwd_chunked}

    def counted(name):
        def run(*a, **kw):
            c0 = counts()
            got = real[name](*a, **kw)
            torch.cuda.synchronize()
            c1 = counts()
            passes[name] = (c1[0] - c0[0], c1[1] - c0[1])
            return got
        return run

    def on_step(it, loss, grads, s):
        g = grads["materials"]["albedo"]
        if it == 0:
            # The peak up to here is the target's eager samples' and
            # the warm-ups'; the later steps' is the replays'.
            peaks.append(torch.cuda.max_memory_allocated() / 2**20)
            torch.cuda.reset_peak_memory_stats()
        steps.append({"s": s, "loss": float(loss),
                      "finite": bool(torch.isfinite(loss))
                      and bool(torch.isfinite(g).all()),
                      "captures": CapturedCall.captures - seen[0],
                      "launches": dict(passes)})
        seen[0] = CapturedCall.captures

    seen, peaks = [CapturedCall.captures], []
    grad_mod._accum_fwd_chunked = counted("pass1")
    grad_mod._accum_bwd_chunked = counted("pass2")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    try:
        full = inv.albedo_stage(cfg, ir_, (0.2, 0.6, 0.3), INVERSE_STEPS, n,
                                "cuda", accum=True, chunk=n, log=None,
                                on_step=on_step)
    finally:
        grad_mod._accum_fwd_chunked = real["pass1"]
        grad_mod._accum_bwd_chunked = real["pass2"]
    wall_s = time.time() - t0
    peaks.append(torch.cuda.max_memory_allocated() / 2**20)
    full_launches = counts()  # the target's eager samples, the steps
    variants = dict(tr.variant_launches)
    later = steps[1:]
    s_step = float(np.median([st["s"] for st in later]))
    rays = 2 * cfg.max_bounces * res * res * n
    out["full_width"] = {
        "steps": INVERSE_STEPS, "samples": n, "s_first_step": steps[0]["s"],
        "s_per_step_median": s_step,
        "s_per_step": [st["s"] for st in steps],
        "rays_per_s": rays / s_step, "peak_mib_first_step": peaks[0],
        "peak_mib_later_steps": peaks[1],
        "captures_first_step": steps[0]["captures"],
        "captures_later": sum(st["captures"] for st in later),
        "losses": full["losses"], "recovered": full["albedos"][-1].tolist(),
        "start": full["start"].tolist(), "wall_s": wall_s}
    print(f"[inverse] stage 1 at full width ({res}x{res}, "
          f"{cfg.max_bounces} bounces, {ir_['tris']['verts'].shape[0]} "
          f"tris), {INVERSE_STEPS} Adam steps of render_loss_and_grad_accum "
          f"({n} samples, chunk {n}): albedo {full['start']} -> "
          f"{full['albedos'][-1]} for [0.2 0.6 0.3], loss "
          f"{full['losses'][0]:.8f} -> {full['losses'][-1]:.8f}; "
          f"{s_step:.4f} s per Adam step (median of steps 2-"
          f"{INVERSE_STEPS}; the first, with its warm-ups and captures, "
          f"{steps[0]['s']:.3f} s), "
          f"{rays / s_step:.4g} rays/s, peak allocated {peaks[1]:.0f} MiB "
          f"over the later steps ({peaks[0]:.0f} MiB up to the first: "
          f"the target's eager samples and the warm-ups); "
          f"captures {steps[0]['captures']} in the first step, "
          f"{out['full_width']['captures_later']} after; launches "
          f"(closest-hit, any-hit) per step: pass 1 "
          f"{sorted({st['launches']['pass1'] for st in steps})}, pass 2 "
          f"{sorted({st['launches']['pass2'] for st in steps})}")
    bad = [i for i, st in enumerate(steps) if not st["finite"]]
    if bad:
        fail(f"inverse rendering at full width: loss or gradient not finite "
             f"at steps {bad}")
    if out["full_width"]["captures_later"] or not steps[0]["captures"]:
        fail(f"inverse rendering at full width: captures by step "
             f"{[st['captures'] for st in steps]}; expected the first "
             f"step's only")
    if any(st["launches"] != {"pass1": (5 * n, 5 * n), "pass2": (0, 0)}
           for st in steps):
        fail(f"inverse rendering at full width: launches by step "
             f"{[st['launches'] for st in steps]}; expected 5 + 5 a pass-1 "
             f"replay and 0 a pass-2 replay")
    if not inv.recovered(full):
        fail("inverse rendering at full width missed the JAX test's "
             "criteria")
    drop_captures(ir_)
    launches = (demo_launches[0] + full_launches[0],
                demo_launches[1] + full_launches[1])
    for k, v in demo_variants.items():
        variants[k] = variants.get(k, 0) + v
    return out, launches, variants


def bench_phase(card: str, timeout: int = 600) -> dict:
    """``python3 -m elevenrender_tpu_torch.bench`` at its default full
    shape, in a subprocess with no ``BENCH_*`` setting of this process:
    its stage lines pass through to stderr, and its line is returned.
    Fails unless it exits 0, its last line parses, every number in it is
    finite, it has no ``config5_error`` and its ``device`` is ``card``
    (the ``nvidia-smi`` name and power limit)."""
    import math
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "elevenrender_tpu_torch.bench"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        fail(f"the bench did not end within {timeout} s")
    sys.stderr.write(proc.stderr)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        fail(f"the bench exited {proc.returncode}: {proc.stderr[-2000:]}")
    try:
        line = json.loads(lines[-1])
    except json.JSONDecodeError:
        fail(f"the bench's last line does not parse: {lines[-1][:500]}")

    def numbers(tree):
        if isinstance(tree, dict):
            tree = list(tree.values())
        if isinstance(tree, list):
            return [x for v in tree for x in numbers(v)]
        return [tree] if isinstance(tree, (int, float)) else []

    extra = line.get("extra", {})
    if "config5_error" in extra:
        fail(f"the bench's config-5 stage failed: {extra['config5_error']}")
    if not {"metric", "value", "unit", "vs_baseline"} <= set(line):
        fail(f"the bench's line lacks bench.py's keys: {sorted(line)}")
    if not all(math.isfinite(x) for x in numbers(line)):
        fail(f"the bench's line holds a number that is not finite: {line}")
    if extra.get("device") != card:
        fail(f"the bench ran on {extra.get('device')!r}, not {card!r}")
    return line


# Phase 23 (a): the resume check's samples and checkpoint interval; (b):
# the production render's SIGTERM comes after this checkpoint's line.
RESUME_SPP, RESUME_CKPT = 48, 16
PRODUCTION_KILL_AT = 320
# The applications' settings, taken from this process's environment by
# no application run.
APP_SETTINGS = ("GRID", "RES", "SPP", "CKPT", "OUT", "RESUME")


def run_app(module, args=(), env=None, kill_after=None, timeout=900):
    """``python3 -m elevenrender_tpu_torch.<module> *args`` from this
    tree's root, in a subprocess with this process's environment but the
    applications' settings, plus ``env``.  ``kill_after``: SIGTERM is sent
    once, right after the first line of its standard output that holds
    this text.  Its standard error passes through.  Returns (its standard
    output's lines, its wall s); fails unless it exits 0 within
    ``timeout`` s."""
    import signal
    import threading
    base = {k: v for k, v in os.environ.items() if k not in APP_SETTINGS}
    t0 = time.time()
    with tempfile.TemporaryFile("w+") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", f"elevenrender_tpu_torch.{module}",
             *args], cwd=os.path.dirname(os.path.abspath(__file__)),
            env={**base, **(env or {})}, stdout=subprocess.PIPE, stderr=err,
            text=True)
        timer = threading.Timer(timeout, proc.kill)
        timer.start()
        lines = []
        try:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                if kill_after is not None and kill_after in line:
                    proc.send_signal(signal.SIGTERM)
                    kill_after = None
            rc = proc.wait()
        finally:
            timer.cancel()
        err.seek(0)
        sys.stderr.write(err.read()[-20000:])
    wall = time.time() - t0
    if wall >= timeout:
        fail(f"{module} did not end within {timeout} s")
    if rc != 0:
        fail(f"{module} exited {rc}; its last lines: {lines[-5:]}")
    return lines, wall


def measured_line(lines, label):
    """The ``measured {...}`` line of a render_config5 run."""
    got = [ln.split("] measured ", 1)[1] for ln in lines
           if "] measured " in ln]
    if len(got) != 1:
        fail(f"{label}: {len(got)} measured lines")
    return json.loads(got[0])


def load_npz(path):
    import numpy as np
    data = np.load(path)
    return {k: data[k] for k in data.files}


def config5_run(label, out, resume_flag, c5_env=None, env=None, kill=None,
                device=""):
    """One ``render_config5`` process (``run_app``) with OUT and RESUME:
    (its lines, its wall s, its ``measured`` line).  On the card it fails
    unless the process launched 5 + 5 traversal kernels a sample by its
    own accounting."""
    lines, wall = run_app("render_config5", ("--device", device) if device
                          else (), {**(c5_env or {}), **(env or {}),
                                    "OUT": out, "RESUME": resume_flag},
                          kill_after=kill)
    m = measured_line(lines, label)
    n = m["samples_rendered"]
    if not device and m["launches"] != [5 * n, 5 * n]:
        fail(f"{label}: launches {m['launches']} over {n} samples, "
             f"expected 5 + 5 per sample")
    return lines, wall, m


def flushed(lines, label):
    """The sample count that a killed run's SIGTERM line flushed."""
    got = [re.search(r"flushing snapshot from (\d+)", ln) for ln in lines]
    got = [int(g.group(1)) for g in got if g]
    if len(got) != 1:
        fail(f"{label}: no single SIGTERM flush line")
    return got[0]


def resume_check(c5_env=None, resume=(RESUME_SPP, RESUME_CKPT), device=""):
    """Phase 23 (a): ``render_config5`` with SPP, CKPT = ``resume``, once
    straight through, then once killed by SIGTERM right after its first
    checkpoint's progress line and run again with RESUME=1: the two final
    ``.npz`` must be equal bit for bit.  The three processes run one
    after the other.  Returns (its numbers, its launches [closest-hit,
    any-hit])."""
    import shutil

    import numpy as np

    tmp = tempfile.mkdtemp(prefix="phase23a_")
    env = {"SPP": str(resume[0]), "CKPT": str(resume[1])}
    straight, killed = os.path.join(tmp, "straight"), os.path.join(tmp, "a")
    runs = [config5_run("(a) straight", straight, "0", c5_env, env,
                        device=device)[2]]
    lines, _, m = config5_run("(a) killed", killed, "0", c5_env, env,
                              f"] {resume[1]}/{resume[0]} samples", device)
    runs.append(m)
    at = flushed(lines, "(a) killed")
    if at != resume[1] or not (load_npz(f"{killed}.npz")["samples"]
                               == at).all():
        fail(f"(a): the killed run flushed {at} samples, not {resume[1]}")
    lines, _, m = config5_run("(a) resumed", killed, "1", c5_env, env,
                              device=device)
    runs.append(m)
    if not any(f"resumed from {killed}.npz at {at} samples" in ln
               for ln in lines):
        fail("(a): the second run did not resume")
    want, got = load_npz(f"{straight}.npz"), load_npz(f"{killed}.npz")
    if set(want) != set(got) or not all(
            np.array_equal(want[k].view(np.uint32), got[k].view(np.uint32))
            for k in want):
        fail("(a): the resumed render differs from the straight one")
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[config5 render] (a) {resume[0]} samples straight and killed at "
          f"{at} then resumed: the final .npz equal bit for bit (passes, "
          f"samples, rng)")
    launches = np.sum([m["launches"] for m in runs], axis=0)
    return ({"spp": resume[0], "ckpt": resume[1], "killed_at": at,
             "bit_equal": True}, launches.tolist())


def applications_path(c5_env=None, spp=1000, kill_at=PRODUCTION_KILL_AT,
                      demo_args=(), scaling_env=None, device=""):
    """Phase 23 (b)-(e): the applications, each in a subprocess.
    ``device`` "" runs them on the card, as users do (no ``--device``);
    "cpu" with small ``c5_env`` (GRID, RES, SPP, CKPT), ``spp`` and
    ``kill_at``, ``demo_args`` and ``scaling_env`` rehearses it on the
    CPU, where the launch gates are left out (the plain walker launches
    no kernel).  Returns the numbers and the launches: "config5" (row
    3), "rows12" (rows 1-2)."""
    import shutil

    import numpy as np
    import torch

    from elevenrender_tpu_torch.render import denoise as dn
    from elevenrender_tpu_torch.utils.image import read_png

    dev = ("--device", device) if device else ()
    card = not device
    res = int((c5_env or {}).get("RES", 1024))
    tmp = tempfile.mkdtemp(prefix="phase23_")
    nums = {}

    # (b) the production render: killed after the kill_at checkpoint,
    # then resumed to spp.
    prod = os.path.join(tmp, "config5")
    lines1, wall1, m1 = config5_run("(b) killed", prod, "0", c5_env,
                                    kill=f"] {kill_at}/{spp} samples",
                                    device=device)
    at = flushed(lines1, "(b) killed")
    killed = load_npz(f"{prod}.npz")
    if at != kill_at or not (killed["samples"] == kill_at).all():
        fail(f"(b): the killed run's .npz does not hold {kill_at} samples "
             f"at every pixel")
    lines2, wall2, m2 = config5_run("(b) resumed", prod, "1", c5_env,
                                    device=device)
    if not any(f"resumed from {prod}.npz at {kill_at} samples" in ln
               for ln in lines2):
        fail(f"(b): the second run did not resume at {kill_at}")
    final = load_npz(f"{prod}.npz")
    if not (final["samples"] == spp).all() or not np.isfinite(
            final["passes"]).all():
        fail(f"(b): the final .npz does not hold {spp} finite samples")
    beauty = read_png(f"{prod}_beauty.png")
    if beauty.shape != (res, res, 4):
        fail(f"(b): the beauty PNG is {beauty.shape}")
    runs = [m1, m2]
    ckpt_s = {k: [x for m in runs for x in m[k]]
              for k in ("readback_s", "npz_s", "png_s")}
    nums["production"] = {
        "spp": spp, "killed_at": kill_at,
        "setup_s": [m["setup_s"] for m in runs],
        "first_sample_s": [m["first_sample_s"] for m in runs],
        "ms_per_sample": [m["ms_per_sample"] for m in runs],
        "samples_rendered": [m["samples_rendered"] for m in runs],
        "checkpoints": [m["checkpoints"] for m in runs],
        "readback_s_mean": float(np.mean(ckpt_s["readback_s"])),
        "npz_s_mean": float(np.mean(ckpt_s["npz_s"])),
        "png_s_mean": float(np.mean(ckpt_s["png_s"])),
        "waited_for_writer_s": [m["waited_for_writer_s"] for m in runs],
        "final_write_s": [m["final_write_s"] for m in runs],
        "checkpoint_share": [m["checkpoint_share"] for m in runs],
        "render_wall_s": [m["wall_s"] for m in runs],
        "process_wall_s": [wall1, wall2],
        "wall_to_spp_s": wall1 + wall2,
        "peak_mib": [m["peak_mib"] for m in runs],
        "launches": [m["launches"] for m in runs]}
    # Beside the repo's 1000-spp checkpoint of the JAX script (this scene
    # and seed rule, rendered on a TPU by the JAX package of its day):
    # how far apart the two images are, against how far apart two
    # independent renders of spp samples would be.  That spread comes from
    # this render's own two independent parts: the killed run's first
    # kill_at samples and the resumed run's last spp - kill_at.  An equal
    # RNG state tells a pixel whose every path drew alike.  Each apart
    # for the sky (pixels that never hit the terrain) and the terrain.
    # Reported, not gated.
    jax_ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            ".runlogs", "config5.npz")
    if os.path.exists(jax_ckpt):
        ref = load_npz(jax_ckpt)
        if (ref["passes"].shape == final["passes"].shape
                and (ref["samples"] == spp).all()):
            got, want = final["passes"][0, :, :3], ref["passes"][0, :, :3]
            first = killed["passes"][0, :, :3]
            rest = (spp * got - kill_at * first) / (spp - kill_at)
            to_spp = np.sqrt((2 / spp) / (1 / kill_at + 1 / (spp - kill_at)))
            sky = np.abs(final["passes"][2, :, :3]).sum(-1) == 0
            same = final["rng"] == ref["rng"]
            cmp = {"pixels_within_rtol_1e-2": float(np.isclose(
                       got, want, rtol=1e-2, atol=1e-3).all(-1).mean()),
                   "sky_share": float(sky.mean()),
                   "mean_rgb": got.mean(0).tolist(),
                   "jax_mean_rgb": want.mean(0).tolist()}
            for part, px in (("sky", sky), ("terrain", ~sky)):
                if not px.any():
                    continue
                scale = float(np.abs(want[px]).mean())
                cmp[part] = {
                    "rng_equal": float(same[px].mean()),
                    "mean_abs_diff_over_mean":
                        float(np.abs(got[px] - want[px]).mean()) / scale,
                    "independent_renders_mean_abs_diff_over_mean": float(
                        np.abs(first[px] - rest[px]).mean() * to_spp)
                        / scale}
            nums["production"]["beauty_vs_jax_checkpoint"] = cmp
            print(f"[config5 render] (b) beauty beside the JAX script's "
                  f"{spp}-spp checkpoint: "
                  f"{nums['production']['beauty_vs_jax_checkpoint']}")
    p = nums["production"]
    print(f"[config5 render] (b) {spp} samples at {res}x{res}: killed after "
          f"{kill_at} (exit 0, {kill_at} at every pixel), resumed to {spp} "
          f"(finite); set-up {p['setup_s']} s, first sample "
          f"{p['first_sample_s']} s, {p['ms_per_sample']} ms/sample by "
          f"replay; a checkpoint: readback {p['readback_s_mean']:.3f} s "
          f"(the card idle), .npz {p['npz_s_mean']:.2f} s and PNG "
          f"{p['png_s_mean']:.2f} s in the writer thread; the checkpoints' "
          f"share of the wall {p['checkpoint_share']}; wall to {spp} spp "
          f"{p['wall_to_spp_s']:.1f} s in two processes; peak "
          f"{p['peak_mib']} MiB; launches {p['launches']}")

    # (c) the denoised showcase of (b)'s checkpoint, against the CPU.
    shown, raw = os.path.join(tmp, "denoised.png"), os.path.join(tmp, "d.npy")
    lines, wall = run_app("denoise_showcase", (*dev, "--raw", raw),
                          {"CKPT": f"{prod}.npz", "OUT": shown})
    img = np.load(raw)
    t0 = time.time()
    with torch.no_grad():
        planes = [torch.from_numpy(final["passes"][i, :, :3].reshape(
            res, res, 3).copy()) for i in range(3)]
        cpu = dn.nlm_denoise_ms(planes[0], planes[2], planes[1]).numpy()
    cpu_s = time.time() - t0
    close = float(np.isclose(img, cpu, rtol=1e-4, atol=1e-5).mean())
    if close < 0.999 or read_png(shown).shape != (res, res, 4):
        fail(f"(c): the showcase agrees with the CPU denoiser on {close:.5f} "
             f"of values (gate 0.999)")
    nums["showcase"] = {"wall_s": wall, "line": lines[-1],
                        "close_to_cpu": close, "cpu_s": cpu_s}
    print(f"[showcase] (c) {lines[-1]}; {wall:.1f} s with the process; "
          f"{close:.5f} of values within rtol 1e-4 / atol 1e-5 of the CPU "
          f"denoiser ({cpu_s:.2f} s)")

    # (d) the demo at its defaults.
    outdir = os.path.join(tmp, "demo")
    lines, wall = run_app("demo", (outdir, *demo_args, *dev))
    scenes = json.loads(lines[-1])["demo"]
    size = int(demo_args[0]) if demo_args else 256
    spp_d = int(demo_args[1]) if len(demo_args) > 1 else 32
    for name in ("cornell", "heightfield"):
        if not scenes[name]["finite"]:
            fail(f"(d): {name}'s passes are not finite")
        for suffix in ("", "_normal", "_denoised"):
            png = read_png(os.path.join(outdir, f"{name}{suffix}.png"))
            if png.shape != (size, size, 4):
                fail(f"(d): {name}{suffix}.png is {png.shape}")
    rows12 = np.array(scenes["heightfield"]["launches"], np.int64)
    if card and (scenes["cornell"]["launches"] != [0, 0]
                 or list(rows12) != [5 * spp_d, 5 * spp_d]):
        fail(f"(d): launches {scenes}, expected none for the Cornell box "
             f"(brute force) and 5 + 5 per sample for the heightfield")
    nums["demo"] = {"wall_s": wall, "scenes": scenes}
    print(f"[demo] (d) {size}x{size}, {spp_d} samples: six PNGs; "
          + "; ".join(f"{k} {v['s']:.1f} s, launches {v['launches']}"
                      for k, v in scenes.items())
          + f"; {wall:.1f} s with the process")

    # (e) the scaling harness at its defaults: one row on one card.
    lines, wall = run_app("multichip_bench", dev, scaling_env)
    parsed = [json.loads(ln) for ln in lines if ln.startswith("{")]
    rows = [r for r in parsed if "devices" in r]
    summary = [r for r in parsed if "summary" in r]
    if ([r["devices"] for r in rows] != [1] or len(summary) != 1
            or summary[0]["platform"] != ("gpu" if card else "cpu")):
        fail(f"(e): rows {rows}, summary {summary}")
    scaled = summary[0]["launches_rank0"]["1"]
    samples_e = 1 + int((scaling_env or {}).get("SPP", 4))
    if card and scaled != [5 * samples_e, 5 * samples_e]:
        fail(f"(e): launches {scaled} over {samples_e} samples")
    rows12 += scaled
    nums["scaling"] = {"wall_s": wall, "rows": rows, "summary": summary[0]}
    print(f"[scaling] (e) {json.dumps(rows[0])}; {wall:.1f} s with the "
          f"spawn; launches {scaled}")
    shutil.rmtree(tmp, ignore_errors=True)
    nums["launches"] = {
        "config5": np.sum([m["launches"] for m in runs], axis=0).tolist(),
        "rows12": rows12.tolist()}
    return nums


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    import numpy as np

    import gc

    from elevenrender_tpu_torch import kernels, profile_step
    from elevenrender_tpu_torch import sweep_traverse as sweep
    from elevenrender_tpu_torch.convert import ir_to
    from elevenrender_tpu_torch.core import spans
    from elevenrender_tpu_torch.experiments import bvh_wide
    from elevenrender_tpu_torch.ops import hitdata as hd_ops
    from elevenrender_tpu_torch.ops import sort as sort_ops
    from elevenrender_tpu_torch.ops import traverse as tr
    from elevenrender_tpu_torch.ops.camera import camera_ray
    from elevenrender_tpu_torch.render import denoise as dn
    from elevenrender_tpu_torch.render import dispatch
    from elevenrender_tpu_torch.render import grad as grad_mod
    from elevenrender_tpu_torch.render import integrator
    from elevenrender_tpu_torch.render.renderer import Renderer
    from elevenrender_tpu_torch.scene.demo import (heightfield_scene,
                                                   textured_heightfield_scene)

    t_start = time.time()

    def phase_done(name, t0):
        print(f"[time] {name}: {time.time() - t0:.1f} s; reserved "
              f"{torch.cuda.memory_reserved() / 2**20:.0f} MiB, peak "
              f"allocated since the last reset "
              f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")

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
    kernels.build_all([*kernels.LIBRARIES, *kernels.HOST_LIBRARIES])
    print(f"[build] {time.time() - t0:.1f} s for {len(kernels.LIBRARIES)} "
          f"CUDA libraries and the host runtime, all compilers at once; the "
          f"host runtime (c++ {' '.join(kernels.HOST_FLAGS)}) "
          f"{kernels.build_info['elevenrt']['seconds']:.1f} s")
    host_build_s = kernels.build_info["elevenrt"]["seconds"]
    # library -> {template arguments as mangled: (registers, stack bytes,
    # spill store bytes, spill load bytes)}, from ptxas -v.
    ptxas = {}
    for name, info in kernels.build_info.items():
        entry = None
        for line in info["log"].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and entry:
                ptxas.setdefault(name, {})[entry] = [0, *map(int, m.groups())]
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                ptxas.setdefault(name, {}).setdefault(entry, [0, 0, 0, 0])[
                    0] = int(m.group(1))
        for entry, (regs, stack, st, ld) in ptxas.get(name, {}).items():
            print(f"[build] {name}: {entry}: {regs} registers, {stack} bytes "
                  f"stack frame, {st} / {ld} bytes spill stores / loads")
    if set(ptxas) != set(kernels.LIBRARIES):
        fail(f"no ptxas report for {set(kernels.LIBRARIES) - set(ptxas)}")

    def ptxas_of(lib, pattern):
        """(registers, stack, spill stores, spill loads) of the one entry
        function of ``lib`` whose mangled name holds ``pattern``."""
        found = [v for k, v in ptxas[lib].items() if pattern in k]
        if len(found) != 1:
            fail(f"{lib}: {len(found)} entry functions match {pattern!r}")
        return dict(zip(("registers", "stack_bytes", "spill_store_bytes",
                         "spill_load_bytes"), found[0]))

    errs = {"closest": [], "any_hit": []}
    # Launches by variant key (order, leaf_aabb, leaf_mode, count_steps),
    # summed over the driven paths (phases 4, 8 and 14): each adds what
    # the wrapper counted between its own reset and its end.
    path_launches = {}
    # The hit-data kernels' launches (ops/hitdata.py's counters) over the
    # timed samples of each driven forward path (phases 4 and 8).
    hitdata_launched = {}

    def add_path_launches(label, expected, counted=None):
        """``counted``: the wrapper's launches by variant, read by the
        caller (default: read now)."""
        counted = tr.variant_launches if counted is None else counted
        if counted != expected:
            fail(f"{label}: launches by variant {counted}, "
                 f"expected {expected}")
        for k, v in counted.items():
            path_launches[k] = path_launches.get(k, 0) + v

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

    def check_ragged(tables, depth, label, o, d, closest, t_max):
        """The persistent grid's ray hand-out at ray counts that are not a
        multiple of a warp's run of 32, that leave the last run short or
        the grid part empty: the first n random rays, closest-hit and
        any-hit, with count_steps.  ids, t and counters equal to the
        plain version's on every ray."""
        for n_ in RAGGED:
            for mode, ex, tm in (("closest", None, None),
                                 ("any-hit", closest[:n_], t_max[:n_])):
                args = (tables, o[:n_], d[:n_], depth, ex, tm)
                got = tr.traverse(*args, count_steps=True)
                ref = tr.traverse_plain(*args, count_steps=True)
                for what, a, b in zip(("ids", "t", "counters"), got, ref):
                    if not torch.equal(a, b):
                        fail(f"{label} {n_} random rays {mode}: {what} "
                             f"differ from the plain version's")
        print(f"[kernel] {label} random rays cut to {RAGGED} rays, "
              f"closest-hit and any-hit with count_steps: ids, t and "
              f"counters equal to the plain version's")

    def check_scene(ir, depth, label):
        """Camera rays, random rays around the scene's box, and those as
        any-hit queries with half of them under a finite t_max; then the
        random rays cut to ragged counts (check_ragged)."""
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
        cam_o, cam_d = cam_o.contiguous(), cam_d.contiguous()
        cam_closest = check(tables, depth, f"{label} camera rays", cam_o,
                            cam_d)
        closest = check(tables, depth, f"{label} random rays", rnd_o, rnd_d)
        t_max = torch.tensor(np.where(gen.uniform(size=nr) < 0.5, np.inf,
                                      gen.uniform(0.05, 4.0, nr)
                                      ).astype(np.float32), device=dev)
        check(tables, depth, f"{label} random rays", rnd_o, rnd_d,
              closest.to(torch.int32), t_max)
        check_ragged(tables, depth, label, rnd_o, rnd_d,
                     closest.to(torch.int32), t_max)
        return {"camera rays": (cam_o, cam_d, cam_closest.to(torch.int32),
                                t_max),
                "random rays": (rnd_o, rnd_d, closest.to(torch.int32),
                                t_max)}

    def drive(label, cfg, ir, n_timed):
        """Renderer.step at full width: 1 warm-up sample, then n_timed
        timed, with the launch counts set to 0 just before and read just
        after; then n_timed more, each under the profiler, whose kernel
        names count the launches the replays made.  Fails unless the profiler
        and the counters (a replay adds what its capture counted) each
        saw 5 closest-hit and 5 any-hit launches per sample and the
        beauty pass is finite and positive.  Returns the profiled
        (closest-hit, any-hit) launches."""
        res = cfg.x_res
        torch.cuda.reset_peak_memory_stats()
        renderer = Renderer(cfg, ir)
        renderer.step(1)  # warm-up
        torch.cuda.synchronize()
        tr.reset_counts()
        spans.reset(list(hd_ops.LAUNCHES.values()))
        t0 = time.time()
        renderer.step(n_timed)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches, any_hit = tr.launches, tr.any_hit_launches
        hitdata_launched[label] = {k: spans.counter(v)
                                   for k, v in hd_ops.LAUNCHES.items()}
        if hitdata_launched[label] != dict.fromkeys(
                hd_ops.LAUNCHES, cfg.max_bounces * n_timed):
            fail(f"{label}: hit-data launches {hitdata_launched[label]} "
                 f"over {n_timed} samples, expected {cfg.max_bounces} "
                 f"of each a sample")
        add_path_launches(label, {DEFAULT: 10 * n_timed})
        closest = launches - any_hit
        tr.reset_counts()
        profiled, calls, *_ = profiled_launches(lambda: renderer.step(1),
                                                n_timed)
        again = (tr.launches - tr.any_hit_launches, tr.any_hit_launches)
        rays_per_sample = 2 * cfg.max_bounces * res * res
        beauty = renderer.get_pass("beauty").reshape(res, res, 4)[..., :3]
        print(f"[{label}] {res}x{res} native {cfg.max_bounces} bounces: "
              f"{dt / n_timed * 1e3:.1f} ms/sample, "
              f"{rays_per_sample * n_timed / dt:.4g} rays/s, "
              f"{launches / n_timed:g} kernel launches/sample ({closest} "
              f"closest, {any_hit} any-hit over {n_timed} samples by the "
              f"counters); the profiler's kernel names over {n_timed} more "
              f"replays: {profiled[0]} closest, {profiled[1]} any-hit "
              f"(counters {again[0]}, {again[1]} over the {calls} "
              f"profiled replays); peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
        print(f"[{label}] beauty mean {float(beauty.mean()):.5f}, finite "
              f"{bool(np.isfinite(beauty).all())}, samples "
              f"{renderer.get_render_info()['samples']}")
        want = (5 * n_timed, 5 * n_timed)
        if ((closest, any_hit) != want or profiled != want
                or again != (5 * calls, 5 * calls)):
            fail(f"{label}: expected 5 closest-hit and 5 any-hit launches "
                 f"per sample, counted {closest}, {any_hit}, profiled "
                 f"{profiled} over {n_timed} samples")
        if not np.isfinite(beauty).all() or not beauty.mean() > 0:
            fail(f"{label}: beauty pass is not finite with a positive mean")
        return profiled

    def trace_check(label, cfg, ir_, n=4):
        """Renderer.profile(path, n) at full width: the trace.json it
        writes holds n samples' device work, n x 5 closest-hit and n x 5
        any-hit launches by kernel name and n x the kernels of one
        replay of the same graph that the profiler sees in this process
        (profiled_launches); the renderer is n samples further on.  The
        call traces in a child process; its wall time is printed."""
        from types import SimpleNamespace

        renderer = Renderer(cfg, ir_)
        renderer.step(1)  # the warm-up sample and the capture
        per_replay = profiled_launches(lambda: renderer.step(1))[3]
        before = renderer.get_render_info()["samples"]
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            renderer.profile(tmp, n)
            wall_s = time.time() - t0
            with open(os.path.join(tmp, "trace.json")) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel"]
        walks = profile_step.walk_launches(
            SimpleNamespace(key=e.get("name", ""), count=1) for e in events)
        taken = renderer.get_render_info()["samples"] - before
        print(f"[{label}] Renderer.profile(path, {n}): trace.json holds "
              f"{len(events)} kernels ({len(events) / n:g} a sample; "
              f"{per_replay} in one replay profiled here) and {walks} "
              f"(closest-hit, any-hit) traversal launches; in a child "
              f"process, {wall_s:.2f} s; the renderer {taken} samples on")
        if taken != n:
            fail(f"{label}: Renderer.profile(path, {n}) took the renderer "
                 f"{taken} samples on")
        if walks != (5 * n, 5 * n) or len(events) != n * per_replay:
            fail(f"{label}: Renderer.profile(path, {n}) wrote {len(events)} "
                 f"kernels and {walks} traversal launches; expected "
                 f"{n} x {per_replay} and {(5 * n, 5 * n)}")
        return {"s": wall_s}

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

    def time_kernel(tables, depth, o, d, ex, tm, reps=20, **variant):
        """Median of ``reps`` launches, each between two CUDA events."""
        return float(np.median(sweep.times_in_turns(
            {"kernel": lambda: tr._launch(tables, o, d, depth, ex, tm,
                                          **variant)}, reps, True)["kernel"]))

    def bound_of(tables, counts, any_hit, leaf_aabb=0):
        """sweep_traverse.bound_of for the binary kernel's variants: the
        tables the variant reads.  The group box tests of leaf_aabb 1 and
        2 are left out: the kernel counts the 8-aligned groups a ray
        touches, not the boxes it tests, and a bound may count too little
        work but never too much."""
        read = ["boxes", "leaves", "tris"]
        if leaf_aabb:
            read.append({1: "groups8", 2: "groups4"}[leaf_aabb])
        return sweep.bound_of([tables[k] for k in read], counts, any_hit)

    def timing_at_recorded_shapes(label, cfg, ir, depth):
        """Records the first four launches of one sample (bounce 0 and 1,
        closest then any-hit), then times the kernel on the closest-hit
        bounce-0 and bounce-1 rays and the bounce-1 any-hit rays, in
        turns with binary-v1 (the median and 10-90% spread of 20 turns
        each), checks it against its plain version there, and times the
        plain version."""
        tables = ir["kernel"]
        shapes = sweep.recorded_launches(cfg, ir, "cuda")
        table_bytes = sum(tables[k].numel() * tables[k].element_size()
                          for k in ("boxes", "leaves", "tris"))
        print(f"[timing] {label}: kernel tables {table_bytes / 2**20:.1f} "
              f"MiB (tris {tables['tris'].numel() * 4 / 2**20:.1f} MiB)")

        timing = {}
        for key, (o, d, ex, tm) in shapes.items():
            turns = sweep.times_in_turns(
                {"kernel": lambda: tr._launch(tables, o, d, depth, ex, tm),
                 sweep.V1: lambda: tr.traverse_v1(tables, o, d, depth, ex,
                                                  tm)}, 20, True)
            ms, ms_v1 = (float(np.median(turns[k]))
                         for k in ("kernel", sweep.V1))
            spread, spread_v1 = (sweep.spread(turns[k])
                                 for k in ("kernel", sweep.V1))
            pi, pt, p_cnt = tr.traverse_plain(tables, o, d, depth, ex, tm,
                                              count_steps=True)
            check(tables, depth, f"{label} {key}", o, d, ex, tm,
                  plain=(pi, pt))
            torch.cuda.synchronize()
            t0 = time.time()
            tr.traverse_plain(tables, o, d, depth, ex, tm)
            torch.cuda.synchronize()
            plain_ms = (time.time() - t0) * 1e3
            # The bound's work counts are the kernel's own (count_steps).
            _, _, k_cnt = tr.traverse(tables, o, d, depth, ex, tm,
                                      count_steps=True)
            if not torch.equal(k_cnt, p_cnt):
                fail(f"{label} {key}: the kernel's counters differ from the "
                     f"plain version's on "
                     f"{int((k_cnt != p_cnt).any(dim=1).sum())} rays")
            timing[key] = dict(ms=ms, plain_ms=plain_ms, ms_v1=ms_v1,
                               vs_v1=ms / ms_v1, spread_ms=spread,
                               spread_ms_v1=spread_v1,
                               beyond_spread=spread[1] < spread_v1[0],
                               **bound_of(tables, k_cnt, ex is not None))
            b = timing[key]
            n = o.shape[0]
            print(f"[timing] {label} {key}: {n} rays, kernel {ms:.3f} "
                  f"ms/launch (10-90% {spread[0]:.3f}-{spread[1]:.3f}), "
                  f"binary-v1 {ms_v1:.3f} ({spread_v1[0]:.3f}-"
                  f"{spread_v1[1]:.3f}) in turns: {ms / ms_v1:.3f}x, "
                  f"{'apart' if b['beyond_spread'] else 'overlapping'}; "
                  f"plain {plain_ms:.1f} ms, bound "
                  f"{b['bound_ms']:.4f} ms ({b['bound_by']}, from the "
                  f"kernel's counters, equal to the plain version's: "
                  f"{b['visits'] / n:.1f} visits and {b['tests'] / n:.1f} "
                  f"tri tests per ray, {b['ops']:.4g} ops, "
                  f"{b['bytes'] / 2**20:.1f} MiB), "
                  f"{b['bound_ms'] / ms * 100:.1f}% of bound")
        return timing, shapes

    RENDER_VARIANTS = render_variants()

    def check_variants(label, tables, depth, rays, recorded, only=None):
        """Every variant against the plain version under the same flags:
        ids equal, t bit-equal (so the any-hit flags too), the four
        counters equal on every ray.  leaf_aabb 1/2 must give exactly
        leaf_aabb 0's ids and t; order="sign" gives order="near"'s up
        to equal-t ties, which are counted.  Returns, by variant at the
        recorded shapes, the plain version's time and the largest
        |t - t_plain| seen there (0 unless the check above is loosened).
        ``only``: the (name, mode) pairs of ``rays`` to keep; the recorded
        launches always stay."""
        sets = []
        for name, (o, d, closest, t_max) in rays.items():
            sets.append((name, "closest", o, d, None, None))
            sets.append((name, "any-hit", o, d, closest, t_max))
        if only is not None:
            sets = [s_ for s_ in sets if (s_[0], s_[1]) in only]
        sets.append(("recorded bounce 1", "closest",
                     *recorded["closest_b1"]))
        sets.append(("recorded shadow", "any-hit", *recorded["any_hit_b1"]))
        plain_ms = {}
        ties = 0
        checked = 0
        for name, mode, o, d, ex, tm in sets:
            base = {}
            for order, leaf_aabb, leaf_mode in (
                    [(o_, a_, "full") for o_, a_ in RENDER_VARIANTS]
                    + [(o_, 0, m_) for o_ in tr.ORDERS
                       for m_ in ("noscan", "skip")]):
                flags = dict(order=order, leaf_aabb=leaf_aabb,
                             leaf_mode=leaf_mode)
                what = (f"{label} {name} {mode} order={order} "
                        f"leaf_aabb={leaf_aabb} leaf_mode={leaf_mode}")
                ki, kt, kc = tr.traverse(tables, o, d, depth, ex, tm,
                                         count_steps=True, **flags)
                ki2, kt2 = tr.traverse(tables, o, d, depth, ex, tm, **flags)
                torch.cuda.synchronize()
                ta = time.time()
                pi, pt, pc = tr.traverse_plain(tables, o, d, depth, ex, tm,
                                               count_steps=True, **flags)
                torch.cuda.synchronize()
                if name.startswith("recorded"):
                    took = (time.time() - ta) * 1e3
                    # inf - inf on a common miss is no error.
                    gap = torch.nan_to_num(kt - pt, nan=0.0).abs().max()
                    plain_ms[(order, leaf_aabb, leaf_mode, mode)] = (
                        took, float(gap))
                if not (torch.equal(ki, pi) and torch.equal(kt, pt)):
                    fail(f"{what}: kernel and plain version differ on "
                         f"{int(((ki != pi) | (kt != pt)).sum())} rays")
                if not torch.equal(kc, pc):
                    fail(f"{what}: counters differ on "
                         f"{int((kc != pc).any(dim=1).sum())} rays")
                if not (torch.equal(ki, ki2) and torch.equal(kt, kt2)):
                    fail(f"{what}: count_steps changed the result")
                checked += 1
                if leaf_mode != "full":
                    if bool((ki >= 0).any()) or int(kc[:, 3].sum()):
                        fail(f"{what}: a probe found a hit or tested a tri")
                    continue
                if leaf_aabb == 0:
                    base[order] = (ki, kt, kc)
                    continue
                bi, bt, bc = base[order]
                if not (torch.equal(ki, bi) and torch.equal(kt, bt)):
                    fail(f"{what}: not the ids and t of leaf_aabb=0")
                if int(kc[:, 3].sum()) > int(bc[:, 3].sum()):
                    fail(f"{what}: more tri tests than leaf_aabb=0")
            ni, nt, _ = base["near"]
            si, st, _ = base["sign"]
            if not torch.equal(nt, st):
                fail(f"{label} {name} {mode}: order=sign changed t")
            if mode == "closest":
                diff = (ni != si).nonzero()[:, 0]
                if diff.numel():
                    # Same t from another tri: an equal-t tie.
                    _, t_alt = tr._mt(tables["tris"][si[diff].long()],
                                      o[diff], d[diff])
                    if not torch.equal(t_alt, nt[diff]):
                        fail(f"{label} {name}: order=sign differs from "
                             f"near beyond equal-t ties")
                    ties += int(diff.numel())
        print(f"[variants] {label}: {checked} launches of "
              f"{len(RENDER_VARIANTS)} (order, leaf_aabb) variants and 4 "
              f"probes, each with and without count_steps, on {len(sets)} "
              f"ray sets: ids equal, t bit-equal, counters equal to the "
              f"plain version on every ray; leaf_aabb 1/2 give leaf_aabb "
              f"0's ids and t exactly; order=sign gives order=near's t "
              f"exactly and its ids but for {ties} equal-t ties")
        return plain_ms

    def time_variants(label, tables, depth, recorded, plain_ms):
        """Each variant's time per launch at the path's recorded bounce-1
        and shadow launches beside the default's, its mean counters per
        ray (from its own count_steps launch) and its bound.  For the
        probes, which walk more than the default (best_t never falls),
        also the walk's estimated share of a default launch: the probe's
        time x the default's visits / the probe's visits."""
        out = {}
        variants = ([("near", 0, "full", False), ("near", 0, "full", True)]
                    + [(o_, a_, "full", False) for o_, a_ in RENDER_VARIANTS
                       if (o_, a_) != ("near", 0)]
                    + [("near", 0, "noscan", False),
                       ("near", 0, "skip", False)])
        for shape, key in (("closest", "closest_b1"),
                           ("any-hit", "any_hit_b1")):
            o, d, ex, tm = recorded[key]
            default_ms = None
            for order, leaf_aabb, leaf_mode, count in variants:
                flags = dict(order=order, leaf_aabb=leaf_aabb,
                             leaf_mode=leaf_mode)
                ms = time_kernel(tables, depth, o, d, ex, tm,
                                 count_steps=count, **flags)
                _, _, cnt = tr.traverse(tables, o, d, depth, ex, tm,
                                        count_steps=True, **flags)
                visits = float(cnt[:, 0].float().mean())
                if default_ms is None:
                    default_ms, default_visits = ms, visits
                b = bound_of(tables, cnt, ex is not None,
                             leaf_aabb if leaf_mode == "full" else 0)
                means = [round(float(c), 2)
                         for c in cnt.float().mean(dim=0)]
                out[(order, leaf_aabb, leaf_mode, count, shape)] = dict(
                    ms=ms, counters=means,
                    plain_ms=plain_ms[(order, leaf_aabb, leaf_mode,
                                       shape)][0],
                    err=plain_ms[(order, leaf_aabb, leaf_mode, shape)][1],
                    **b)
                print(f"[variants] {label} {shape} order={order} "
                      f"leaf_aabb={leaf_aabb} leaf_mode={leaf_mode} "
                      f"count_steps={count}: {ms:.3f} ms/launch "
                      f"({ms / default_ms:.2f}x the default), per ray "
                      f"[visits, leaf visits, groups, tri tests] {means}, "
                      f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
                      + (f"; at the default's {default_visits:.2f} visits "
                         f"{ms * default_visits / visits:.3f} ms "
                         f"({ms * default_visits / visits / default_ms:.0%}"
                         f" of the default)"
                         if leaf_mode != "full" else ""))
        return out

    def grad_card_vs_cpu(label, cfg, ir_):
        """fwd_bwd_step_accum, 4 samples, on the card and on the CPU:
        loss within rtol 1e-4, every material gradient leaf within rtol
        2e-3 / atol 1e-4 x the leaf's largest entry (sums in another
        order, and the two devices' sin, cos, pow and log differ in the
        last bit).  On the card, cache_traces=False must give exactly
        the replayed gradients; the kernel is launched 10 times per
        sample in pass 1, as often again in a re-traced pass 2, and not
        once in a replayed sample."""
        n = 4
        res = {}
        for name in ("cuda", "cpu"):
            ir_n = ir_to(ir_, name)
            target = make_target(cfg, ir_n, name)
            tr.reset_counts()
            res[name] = grad_mod.fwd_bwd_step_accum(cfg, ir_n, target, n,
                                                    device=name)
            if name == "cuda":
                replay_launches = tr.launches
                params = {"materials": grad_mod.float_subtree(
                    ir_n["materials"])}
                tr.reset_counts()
                retraced = grad_mod.render_loss_and_grad_accum(
                    cfg, ir_n, params, target, n, cache_traces=False)
                retrace_launches = tr.launches
                st, trace = integrator.render_sample(
                    cfg, ir_n, integrator.init_state(cfg), record=True)
                tr.reset_counts()
                integrator.sample_radiance(
                    cfg, ir_n, integrator.init_state(cfg)["rng"],
                    cfg.x_res * cfg.y_res, trace_cache=trace)
                replayed_sample_launches = tr.launches
        if (replay_launches != 10 * n or retrace_launches != 20 * n
                or replayed_sample_launches != 0):
            fail(f"{label}: launches {replay_launches} (replay), "
                 f"{retrace_launches} (re-trace), "
                 f"{replayed_sample_launches} (one replayed sample); "
                 f"expected {10 * n}, {20 * n}, 0")
        loss_c, loss_h = float(res["cuda"][0]), float(res["cpu"][0])
        if not abs(loss_c - loss_h) <= 1e-4 * abs(loss_h):
            fail(f"{label}: loss {loss_c} on the card, {loss_h} on the CPU")
        if float(retraced[0]) != loss_c:
            fail(f"{label}: re-traced loss differs from the replayed one")
        worst = 0.0
        nonzero = 0
        for k, g_h in res["cpu"][1]["materials"].items():
            g_c = res["cuda"][1]["materials"][k]
            if not torch.equal(g_c, retraced[1]["materials"][k]):
                fail(f"{label}: leaf {k}: replayed and re-traced gradients "
                     f"differ")
            g_c = g_c.cpu()
            scale = float(g_h.abs().max())
            nonzero += scale > 0
            if not bool(torch.isfinite(g_c).all()):
                fail(f"{label}: leaf {k} is not finite on the card")
            gap = float((g_c - g_h).abs().max())
            if not bool(((g_c - g_h).abs()
                         <= 2e-3 * g_h.abs() + 1e-4 * scale).all()):
                fail(f"{label}: leaf {k} differs by {gap:.3g} (largest "
                     f"entry {scale:.3g})")
            if scale > 0:
                worst = max(worst, gap / scale)
        print(f"[grad parity] {label} {cfg.x_res}x{cfg.y_res}, "
              f"{cfg.max_bounces} bounces, {n} samples, by graph replay on "
              f"the card: loss {loss_c:.8f} "
              f"card / {loss_h:.8f} CPU; {len(res['cpu'][1]['materials'])} "
              f"material leaves ({nonzero} non-zero), worst |card - CPU| "
              f"{worst:.3g} of a leaf's largest entry; replay == re-trace "
              f"exactly; launches {replay_launches} with replay, "
              f"{retrace_launches} re-traced, {replayed_sample_launches} in "
              f"a replayed sample")
        # render_loss_and_grad (fwd_bwd_step): one graph of the whole
        # 2-sample forward and backward.  Its first call is the warm-up
        # and the capture, the second a replay; against the CPU as above,
        # the replay against the first call within 1e-5 of each leaf's
        # largest entry (an atomic order may move), 20 launches a replay.
        nd = 2
        direct = {}
        for name in ("cuda", "cpu"):
            ir_n = ir_to(ir_, name)
            target = make_target(cfg, ir_n, name)
            direct[name] = grad_mod.fwd_bwd_step(cfg, ir_n, target, nd,
                                                 device=name)
            if name == "cuda":
                tr.reset_counts()
                again = grad_mod.fwd_bwd_step(cfg, ir_n, target, nd)
                direct_launches = tr.launches
        loss_c, loss_h = float(direct["cuda"][0]), float(direct["cpu"][0])
        if (not abs(loss_c - loss_h) <= 1e-4 * abs(loss_h)
                or float(again[0]) != loss_c or direct_launches != 10 * nd):
            fail(f"{label}: render_loss_and_grad loss {loss_c} on the card "
                 f"(replay {float(again[0])}), {loss_h} on the CPU; "
                 f"{direct_launches} launches in a replay")
        worst_d = worst_r = 0.0
        for k, g_h in direct["cpu"][1]["materials"].items():
            g_c = direct["cuda"][1]["materials"][k]
            scale = float(g_h.abs().max())
            gap_r = float((again[1]["materials"][k] - g_c).abs().max())
            g_c = g_c.cpu()
            if not (bool(torch.isfinite(g_c).all())
                    and bool(((g_c - g_h).abs()
                              <= 2e-3 * g_h.abs() + 1e-4 * scale).all())
                    and gap_r <= 1e-5 * scale):
                fail(f"{label}: render_loss_and_grad leaf {k}: card against "
                     f"CPU or replay against the first call out of bounds")
            if scale > 0:
                worst_d = max(worst_d, float((g_c - g_h).abs().max()) / scale)
                worst_r = max(worst_r, gap_r / scale)
        print(f"[grad parity] {label} render_loss_and_grad, {nd} samples, "
              f"one graph of the whole forward and backward: loss "
              f"{loss_c:.8f} card / {loss_h:.8f} CPU, worst |card - CPU| "
              f"{worst_d:.3g} of a leaf's largest entry; the replay's loss "
              f"equal, its gradients within {worst_r:.3g}; "
              f"{direct_launches} launches a replay")

    # Rows 5 and 6 as the kernel table reports them (timed by the sweep,
    # phase 16), and every frontier the kernel serves (checked in phase 15).
    NEW_WALKS = ([sweep.frontier_name(k) for k in (2, 4, 8)] + [sweep.WIDE])
    ANY_HIT_WALK = sweep.frontier_name(sweep.ANY_HIT_FRONTIER)
    FRONTIER_WALKS = [sweep.frontier_name(k) for k in tr.FRONTIERS]

    def plain_of(walk, kernel, o, d, ex, tm):
        """The plain version of ``kernel`` on the same (card) tensors,
        with counters; the deepest stack and refused pushes it saw."""
        if kernel == sweep.V1:
            return tr.traverse_plain(walk["tables"], o, d, walk["depth"], ex,
                                     tm, count_steps=True), None
        if kernel == sweep.WIDE:
            out = bvh_wide.traverse_wide_plain(
                walk["wide"]["nodes8"], walk["wide"]["leaf8"],
                walk["tables"]["tris"], o, d, walk["depth"], count_steps=True)
            return out, None
        out = tr.traverse_frontier_plain(
            walk["tables"], o, d, walk["depth"], int(kernel.split("=")[1]),
            ex, tm, count_steps=True)
        return out, dict(tr.frontier_stack)

    def same_as_plain(what, walk, kernel, o, d, ex, tm):
        """One kernel of rows 5-6 (or binary-v1) and its plain version on
        the same rays: ids equal, t bit-equal, counters equal on every
        ray, with and without count_steps; the frontier's deepest stack
        equal and no push refused.  Returns (plain ms, max |t - t_plain|,
        the frontier's stack or None)."""
        ki, kt, kc = sweep.run(walk, kernel, o, d, ex, tm, count_steps=True)
        k_stack = dict(tr.frontier_stack)
        ki2, kt2 = sweep.run(walk, kernel, o, d, ex, tm)
        torch.cuda.synchronize()
        ta = time.time()
        (pi, pt, pc), p_stack = plain_of(walk, kernel, o, d, ex, tm)
        torch.cuda.synchronize()
        took = (time.time() - ta) * 1e3
        if not (torch.equal(ki, pi) and torch.equal(kt, pt)):
            fail(f"{what}: kernel and plain version differ on "
                 f"{int(((ki != pi) | (kt != pt)).sum())} rays")
        if not torch.equal(kc, pc):
            fail(f"{what}: counters differ on "
                 f"{int((kc != pc).any(dim=1).sum())} rays")
        if not (torch.equal(ki, ki2) and torch.equal(kt, kt2)):
            fail(f"{what}: count_steps changed the result")
        if p_stack is not None:
            if k_stack != p_stack:
                fail(f"{what}: stack {k_stack} in the kernel, {p_stack} in "
                     f"the plain version")
            if p_stack["refused"]:
                fail(f"{what}: {p_stack['refused']} pushes refused")
        gap = float(torch.nan_to_num(kt - pt, nan=0.0).abs().max()
                    ) if kt.numel() else 0.0
        return took, gap, p_stack

    def check_new_walks(label, walk, rays, recorded, full):
        """Rows 5 and 6, and binary-v1, against their plain versions: the
        frontier-K walk for every K = 2..8, closest-hit and any-hit, the
        8-wide walk and binary-v1 (closest-hit and any-hit) on a
        65,536-ray strided subset of the recorded bounce-1 and shadow
        launches; with ``full`` also on 65,536 camera rays, 65,536 random
        rays (closest-hit and any-hit) and the whole recorded launches,
        where the plain version is timed (the walks of the kernel table
        only: K = 2, 4, 8 and the wide walk closest-hit, K = 4 any-hit),
        then on the random rays cut to the ragged counts of phase 3, every
        K and the wide walk (check_new_walks_ragged).  ids equal, t bit-equal,
        counters equal on every ray, with and without count_steps; the
        frontier's deepest stack equal and no push refused.  Returns
        {(kernel, mode): (plain ms, max |t - t_plain|)} at the full
        launches."""
        def strided(rays_):
            step = max(rays_[0].shape[0] // 65536, 1)
            return tuple(None if x is None else x[::step].contiguous()
                         for x in rays_)

        cam, rnd = rays["camera rays"], rays["random rays"]
        sets = [("recorded bounce 1 subset", *strided(recorded["closest_b1"])),
                ("recorded shadow subset", *strided(recorded["any_hit_b1"]))]
        if full:
            sets += [("camera rays", cam[0], cam[1], None, None),
                     ("random rays", rnd[0], rnd[1], None, None),
                     ("random rays", *rnd),
                     ("recorded bounce 1", *recorded["closest_b1"]),
                     ("recorded shadow", *recorded["any_hit_b1"])]
        out = {}
        checked = 0
        deepest = {}
        for name, o, d, ex, tm in sets:
            mode = "closest" if ex is None else "any-hit"
            whole = name in ("recorded bounce 1", "recorded shadow")
            if ex is None:
                walks = NEW_WALKS if whole else FRONTIER_WALKS + [sweep.WIDE]
            else:
                walks = [ANY_HIT_WALK] if whole else FRONTIER_WALKS
            for kernel in walks + [sweep.V1]:
                took, gap, p_stack = same_as_plain(
                    f"{label} {name} {mode} {kernel}", walk, kernel, o, d,
                    ex, tm)
                if p_stack is not None:
                    deepest[kernel] = max(deepest.get(kernel, 0),
                                          p_stack["deepest"])
                checked += 1
                if whole:
                    out[(kernel, mode)] = (took, gap)
        rows = {k: tr.frontier_stack_rows(int(k.split("=")[1]), walk["depth"])
                for k in deepest}
        print(f"[new walks] {label}: {checked} (kernel, ray set) pairs, each "
              f"with and without count_steps, on {len(sets)} ray sets: ids "
              f"equal, t bit-equal, counters equal to the plain version on "
              f"every ray; no push refused, deepest stack (of its rows) "
              f"{ {k: f'{v} of {rows[k]}' for k, v in deepest.items()} }")
        if full:
            check_new_walks_ragged(label, walk, rnd)
        return out

    def check_new_walks_ragged(label, walk, rnd):
        """The lane-tile kernels' persistent hand-out (a tile takes one ray
        at a time from the work counter) at the ray counts of phase 3's
        ragged checks: the first n random rays, every K closest-hit and
        any-hit and the wide walk, with count_steps; as same_as_plain.  The
        counts check that the last rays are handed out and that the tiles
        which find nothing left exit together."""
        o, d, closest, t_max = rnd
        checked = 0
        for n_ in RAGGED:
            for kernel in FRONTIER_WALKS + [sweep.WIDE]:
                modes = [(None, None)]
                if kernel != sweep.WIDE:
                    modes.append((closest[:n_], t_max[:n_]))
                for ex, tm in modes:
                    same_as_plain(
                        f"{label} {n_} random rays "
                        f"{'closest' if ex is None else 'any-hit'} {kernel}",
                        walk, kernel, o[:n_], d[:n_], ex, tm)
                    checked += 1
        print(f"[new walks] {label}: random rays cut to {RAGGED} rays, every "
              f"K closest-hit and any-hit and the wide walk ({checked} "
              f"launches with count_steps, each beside one without): ids, t, "
              f"counters and stack equal to the plain version's")

    def sweep_at_full_width(label, walk, ir_, recorded, res):
        """sweep_traverse's loop on one scene at res x res rays per
        launch; the launch counts are set to 0 just before and read just
        after.  Returns (rows, launches by variant)."""
        sets = sweep.standard_ray_sets(walk, ir_, res, 0, recorded)
        for name, r_ in sets.items():
            if name != "recorded shadow" and r_[0].shape[0] != res * res:
                fail(f"{label} {name}: {r_[0].shape[0]} rays, expected "
                     f"{res * res}")
        tr.reset_counts()
        rows = sweep.sweep_scene(walk, label, sets, (2, 4, 8), reps=20)
        torch.cuda.synchronize()
        counted = dict(tr.variant_launches)
        if tr.frontier_launches < 1 or tr.wide_launches < 1:
            fail(f"{label}: the sweep launched the frontier kernel "
                 f"{tr.frontier_launches} and the wide kernel "
                 f"{tr.wide_launches} times")
        return rows, counted

    def counting_sort_on_the_path(cfg, ir_, recorded):
        """sort_impl="counting": the permutation on the card equals the
        CPU's for the recorded bounce-1 rays; Renderer.step renders with
        it, 10 launches per sample, and is timed in turns beside argsort
        (2 rounds of 4 samples each, after a warm-up sample)."""
        o, d, _, _ = recorded["closest_b1"]
        bmin, bmax = ir_["bvh"]["node_bmin"][0], ir_["bvh"]["node_bmax"][0]
        key = sort_ops.morton_key(o, d, bmin, bmax,
                                  dir_major=cfg.sort_dir_major,
                                  dir_bits=cfg.sort_dir_bits)
        order, inverse = sort_ops.counting_order(key)
        order_h, inverse_h = sort_ops.counting_order(key.cpu())
        if not (torch.equal(order.cpu(), order_h)
                and torch.equal(inverse.cpu(), inverse_h)):
            fail("counting_order on the card differs from the CPU's")
        if not torch.equal(inverse[order],
                           torch.arange(o.shape[0], device=o.device)):
            fail("counting_order: inverse[order[i]] != i")
        buckets = int(torch.unique(key >> 24).numel())
        sort_ms = {k: float(np.median(v)) for k, v in sweep.times_in_turns(
            {"counting": lambda: sort_ops.counting_order(key),
             "argsort": lambda: torch.sort(key, stable=True)}, 20,
            True).items()}
        print(f"[counting] counting_order of {o.shape[0]} recorded bounce-1 "
              f"keys ({buckets} of 256 buckets used): card == CPU, "
              f"{sort_ms['counting']:.3f} ms; a stable sort of the full keys "
              f"{sort_ms['argsort']:.3f} ms")
        n = 4
        res = cfg.x_res
        renderers = {}
        for impl in ("argsort", "counting"):
            renderers[impl] = Renderer(cfg.replace(sort_impl=impl), ir_)
            renderers[impl].step(1)  # warm-up
        torch.cuda.synchronize()
        times = {impl: [] for impl in renderers}
        for _ in range(2):
            for impl, r_ in renderers.items():
                tr.reset_counts()
                t0 = time.time()
                r_.step(n)
                torch.cuda.synchronize()
                times[impl].append((time.time() - t0) / n * 1e3)
                add_path_launches(f"sort_impl={impl}", {DEFAULT: 10 * n})
        for impl, r_ in renderers.items():
            profiled = profiled_launches(lambda: r_.step(1))[0]
            if profiled != (5, 5):
                fail(f"sort_impl={impl}: the profiler saw {profiled} "
                     f"(closest-hit, any-hit) launches in one replay")
        images = {impl: r_.get_pass("beauty").reshape(res, res, 4)[..., :3]
                  for impl, r_ in renderers.items()}
        close = np.isclose(images["counting"], images["argsort"], rtol=1e-4,
                           atol=1e-5).all(axis=-1).mean()
        print(f"[counting] Renderer.step {res}x{res}, {cfg.max_bounces} "
              f"bounces, ms/sample in turns (2 rounds of {n} samples): "
              f"sort_impl=argsort {[round(t, 1) for t in times['argsort']]}, "
              f"sort_impl=counting "
              f"{[round(t, 1) for t in times['counting']]}; 10 launches per "
              f"sample under both, by the counters and by the profiler on "
              f"one more replay; after {2 + 2 * n} samples "
              f"{close * 100:.2f}% of pixels within rtol 1e-4 / atol 1e-5, "
              f"means {images['counting'].mean():.6f} / "
              f"{images['argsort'].mean():.6f}")
        if (not np.isfinite(images["counting"]).all()
                or not images["counting"].mean() > 0 or close < 0.99):
            fail("sort_impl=counting: the render is not finite, positive "
                 "and equal to the argsort render on 99% of pixels")
        return times

    def dispatch_path(label, cfg, ir_, n):
        """Phase 20 (a)-(c) on one path at full width; see the module
        docstring.  Returns its numbers."""
        out = {}
        with torch.no_grad():
            st = integrator.render_sample(cfg, ir_, integrator.init_state(cfg))
            torch.cuda.synchronize()
            # (a) no host sync in an eager sample.
            torch.cuda.set_sync_debug_mode("error")
            try:
                st = integrator.render_sample(cfg, ir_, st)
            except RuntimeError as e:
                fail(f"{label}: (a) an eager sample synchronised: {e}")
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            print(f"[dispatch] {label}: (a) one eager sample under "
                  f"torch.cuda.set_sync_debug_mode('error'): no sync")
            # (a) The gradient path's eager samples, after a warm-up of
            # each: pass 1's recording sample, pass 2's vector-Jacobian
            # product replaying its record and tracing again.
            params = {"materials": grad_mod.float_subtree(ir_["materials"])}
            tree, flat = grad_mod._as_parameters(params)
            merged = grad_mod._merge(ir_, tree)
            seed = torch.full((st["rng"].shape[0], 3), 1e-6,
                              device=st["rng"].device)
            units = {
                "recording sample": lambda: integrator.render_sample(
                    cfg, merged, st, record=True)[1],
                "VJP sample replaying the record": lambda: (
                    grad_mod._vjp_sample(cfg, merged, flat, st["rng"], seed,
                                         trace)),
                "VJP sample tracing again": lambda: grad_mod._vjp_sample(
                    cfg, merged, flat, st["rng"], seed, None)}
            trace = units["recording sample"]()
            for fn in units.values():
                fn()
            torch.cuda.synchronize()
            for name, fn in units.items():
                torch.cuda.set_sync_debug_mode("error")
                try:
                    fn()
                except RuntimeError as e:
                    fail(f"{label}: (a) an eager {name} synchronised: {e}")
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
            del tree, flat, merged, seed, trace
            print(f"[dispatch] {label}: (a) the gradient path's eager "
                  f"{', '.join(units)} under "
                  f"torch.cuda.set_sync_debug_mode('error'): no sync")
            # The eager sample's transient memory, for the pool beside it.
            torch.cuda.reset_peak_memory_stats()
            a0 = torch.cuda.memory_allocated()
            integrator.render_sample(cfg, ir_, st)
            torch.cuda.synchronize()
            out["eager_transient_mib"] = (torch.cuda.max_memory_allocated()
                                          - a0) / 2**20
            # A fresh capture (not the cached one of the paths above):
            # the warm-up sample, then the capture, with the reserved
            # memory it leaves behind.
            graph = dispatch.SampleGraph(cfg)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            r0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            graph.run(ir_, st, 1)
            torch.cuda.synchronize()
            out["first_run_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
            out["capture_reserved_mib"] = (torch.cuda.memory_reserved()
                                           - r0) / 2**20
            # (b) n replays against n eager samples from the same state,
            # with the replay accounting.
            start = {k: v.clone() for k, v in st.items()}
            tr.reset_counts()
            got = graph.run(ir_, start, n, safe=True)
            torch.cuda.synchronize()
            accounted = (tr.launches - tr.any_hit_launches,
                         tr.any_hit_launches)
            want = start
            for _ in range(n):
                want = integrator.render_sample(cfg, ir_, want)
            for k in ("passes", "samples", "rng"):
                if not torch.equal(got[k], want[k]):
                    fail(f"{label}: (b) {k} after {n} replays differs from "
                         f"{n} eager samples")
            if accounted != (5 * n, 5 * n):
                fail(f"{label}: (b) the replay accounting counted "
                     f"{accounted} launches over {n} samples")
            # (c) the launches of one replay, from the profiler.
            profiled, _, out["replay_kernels"], _ = profiled_launches(
                lambda: graph.run(ir_, graph.state, 1))
            if profiled != (5, 5):
                fail(f"{label}: (c) the profiler saw {profiled} (closest-hit, "
                     f"any-hit) launches in one replay of "
                     f"{out['replay_kernels']} device events")
            print(f"[dispatch] {label}: (b) {n} replays equal {n} eager "
                  f"samples bit for bit (passes, samples, RNG); (c) "
                  f"launches per sample (closest-hit, any-hit): accounted "
                  f"{accounted[0] / n:g}, {accounted[1] / n:g}, profiled in "
                  f"one replay {profiled} of {out['replay_kernels']} device "
                  f"events; warm-up sample and capture "
                  f"{out['first_run_s'] * 1e3:.1f} ms, reserved memory "
                  f"the capture left {out['capture_reserved_mib']:.0f} MiB "
                  f"(an eager sample's transient "
                  f"{out['eager_transient_mib']:.0f} MiB)")
            del graph, got, want, start
        out.update(accounted=accounted, profiled=profiled)
        return out

    def dispatch_timed(label, out, prof_out):
        """Phase 20 (d) of one path from its profile_step profile: the
        numbers into ``out``, printed, each present."""
        for name in ("graph", "eager"):
            if prof_out[name] is None:
                fail(f"{label}: (d) the profiler recorded no device time "
                     f"for the {name} path")
            out[name] = {k: prof_out[name][k] for k in (
                "ms_per_sample", "device_ms", "kernels", "busy",
                "device_over_unprofiled", "ms_by_group")}
        g, e = out["graph"], out["eager"]
        print(f"[dispatch] {label}: (d) ms/sample in turns (eager, graph, "
              f"graph, eager): graph {g['ms_per_sample']}, eager "
              f"{e['ms_per_sample']}; device busy (the union of the "
              f"device events' intervals over the profiled wall time) "
              f"{g['busy'] * 100:.1f}% under the graph, "
              f"{e['busy'] * 100:.1f}% eager; device time over the "
              f"unprofiled wall time {g['device_over_unprofiled'] * 100:.1f}"
              f"% / {e['device_over_unprofiled'] * 100:.1f}%; kernels per "
              f"sample {g['kernels']:.0f} / {e['kernels']:.0f}; device "
              f"ms/sample {g['device_ms']:.2f} / {e['device_ms']:.2f}")

    def denoise_graph_check(state):
        """Phase 20 (e): the denoiser at the state's resolution, guided
        (the "denoise" pass): eager under the sync check, the graph
        replay equal to it bit for bit, both timed in turns; the
        reserved memory its capture keeps (the graph's pool and its
        static buffers), from no captured denoiser."""
        res = int(state["passes"].shape[1] ** 0.5)
        args = [state["passes"][p].reshape(-1).clone()
                for p in (integrator.BEAUTY, integrator.NORMAL,
                          integrator.DENOISE)]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = dn.denoise_ops(res, res, *args)
        except RuntimeError as e:
            fail(f"denoise: (e) the eager denoiser synchronised: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        dn._graphs.clear()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        dn.denoise(res, res, *args)  # the eager run and the capture
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool_mib = (torch.cuda.memory_reserved() - r0) / 2**20
        got = dn.denoise(res, res, *args)
        torch.cuda.synchronize()
        if not torch.equal(got, eager):
            fail("denoise: (e) the graph replay differs from the eager "
                 "denoiser")
        turns = sweep.times_in_turns(
            {"graph": lambda: dn.denoise(res, res, *args),
             "eager": lambda: dn.denoise_ops(res, res, *args)}, 5, True)
        out = {k: float(np.median(v)) for k, v in turns.items()}
        out["capture_reserved_mib"] = pool_mib
        print(f"[dispatch] denoise {res}x{res} guided: (e) the graph replay "
              f"equals the eager denoiser bit for bit, no sync; "
              f"{out['graph']:.2f} ms by replay, {out['eager']:.2f} ms eager "
              f"(CUDA events, median of 5 in turns); reserved memory the "
              f"capture keeps {pool_mib:.0f} MiB")
        return out

    # ---- 3. kernel against its plain version -----------------------------
    t0 = time.time()
    scene, config, ir = heightfield_scene(grid=182, res=1024, compat=False)
    n_tris = ir["tris"]["verts"].shape[0]
    if n_tris != 65522:
        fail(f"heightfield has {n_tris} tris, expected 65522")
    print(f"[scene] {n_tris} tris, bvh depth {config.bvh_depth}, max leaf "
          f"{config.bvh_max_leaf}, built in {time.time() - t0:.1f} s")
    depth = config.bvh_depth
    rays_main = check_scene(ir, depth, "heightfield")
    phase_done("phase 3", t0)

    # ---- 4. the main path at full width ----------------------------------
    t0 = time.time()
    cfg = config.replace(max_bounces=5, compat=False)
    main_closest, main_any_hit = drive("main", cfg, ir, 8)
    profile_child = trace_check("main", cfg, ir)
    phase_done("phase 4", t0)

    # ---- 5. card against CPU ---------------------------------------------
    t0 = time.time()
    card_vs_cpu("heightfield", cfg.replace(x_res=64, y_res=64), ir)
    phase_done("phase 5", t0)

    # ---- 6. kernel timing at the main path's shapes ------------------------
    t0 = time.time()
    timing, shapes = timing_at_recorded_shapes("main path", cfg, ir, depth)
    phase_done("phase 6", t0)
    err12 = {k: max(v) for k, v in errs.items()}
    for v in errs.values():
        v.clear()

    # ---- 7. config 5: build, kernel against its plain version -----------
    t0 = time.time()
    _, config5, ir5 = textured_heightfield_scene(grid=708, res=1024,
                                                 compat=False)
    n5 = ir5["tris"]["verts"].shape[0]
    if n5 != CONFIG5_TRIS:
        fail(f"config 5 has {n5} tris, expected {CONFIG5_TRIS}")
    if config5.n_lights != 1 or config5.tex_uniform_filter != -1:
        fail("config 5 lost its point light or its mixed-filter atlas")
    config5_setup_s = time.time() - t0
    print(f"[config5] {n5} tris, bvh depth {config5.bvh_depth}, max leaf "
          f"{config5.bvh_max_leaf}, built in {config5_setup_s:.1f} s with "
          f"the C++ SAH build (PR 2's run, with the numpy build: "
          f"{CONFIG5_NUMPY_SETUP_S} s on the card's host)")
    depth5 = config5.bvh_depth
    rays5 = check_scene(ir5, depth5, "config5")
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
    stripe5 = stripe_card_vs_cpu("config5 (999,698 tris)", cfg5, ir5)
    phase_done("phase 9", t0)

    # ---- 10. kernel timing at config 5's shapes -----------------------------
    t0 = time.time()
    timing5, shapes5 = timing_at_recorded_shapes("config5", cfg5, ir5,
                                                 depth5)
    phase_done("phase 10", t0)

    # ---- 24. the hit-data kernels alone -------------------------------------
    t0 = time.time()
    hitdata_numbers = {"main path": hitdata_path("main path", cfg, ir),
                       "config5": hitdata_path("config5", cfg5, ir5)}
    phase_done("phase 24", t0)
    err3 = {k: max(v) for k, v in errs.items()}

    # ---- 11. the kernel's variants against the plain version ---------------
    t0 = time.time()
    plain_ms = {}
    # At 999,698 tris every 4th ray of the recorded launches: the plain
    # version there takes about a second a variant at full width.
    shapes5_quarter = {k: tuple(None if x is None else x[::4].contiguous()
                                for x in shapes5[k])
                       for k in ("closest_b1", "any_hit_b1")}
    for label, tables, dep, rays, rec, only in (
            ("65,522 tris", ir["kernel"], depth, rays_main, shapes, None),
            ("999,698 tris", ir5["kernel"], depth5, rays5, shapes5_quarter,
             [("random rays", "closest")])):
        plain_ms[label] = check_variants(label, tables, dep, rays, rec, only)
    phase_done("phase 11", t0)

    # ---- 12. the variants timed ---------------------------------------------
    t0 = time.time()
    vt = time_variants("main path", ir["kernel"], depth, shapes,
                       plain_ms["65,522 tris"])
    vt5 = time_variants("config5", ir5["kernel"], depth5, shapes5,
                        plain_ms["999,698 tris"])
    for label, old, new in (("main path", timing, vt),
                            ("config5", timing5, vt5)):
        for key, shape in (("closest_b1", "closest"),
                           ("any_hit_b1", "any-hit")):
            a = old[key]["bound_ms"]
            b = new[("near", 0, "full", True, shape)]["bound_ms"]
            print(f"[variants] {label} {shape}: bound from the kernel's "
                  f"counters {b:.4f} ms; phases 6/10 had {a:.4f} ms "
                  f"({'unchanged' if a == b else 'moved'})")
    phase_done("phase 12", t0)

    # ---- 13. the gradient path, card against CPU ----------------------------
    t0 = time.time()
    grad_card_vs_cpu("heightfield", cfg.replace(x_res=64, y_res=64), ir)
    grad_card_vs_cpu("textured heightfield (7,938 tris, point light)",
                     small5.replace(max_bounces=5), ir_small)
    phase_done("phase 13", t0)

    # ---- 14. the gradient path at full width --------------------------------
    t0 = time.time()
    # Both paths' profiles first, each in a child process.
    grad_prof = profile_step.profile_grad(cfg, ir, GRAD_SAMPLES, top=8)
    launch_log = []
    gradient, grad_launches = gradient_at_full_width(cfg, ir, launch_log,
                                                     grad_prof)
    gradient["config5"] = config5_gradient(cfg5, ir5, launch_log)
    for label, expected, counted in launch_log:
        add_path_launches(label, expected, counted)
    phase_done("phase 14", t0)

    # ---- 22. inverse rendering (BASELINE config 4) --------------------------
    # Here, in the process that ran phase 14's gradient graphs, ahead of
    # the profiling sessions of phases 17-20.
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        inverse, inv_launches, inv_variants = inverse_path(cfg, ir, tmp)
    add_path_launches("inverse path", {DEFAULT: sum(inv_launches)},
                      inv_variants)
    phase_done("phase 22", t0)

    # ---- 15. the frontier and wide walks against their plain versions -----
    t0 = time.time()
    walk = sweep.make_walk(ir, depth)
    walk5 = sweep.make_walk(ir5, depth5)
    new_plain = check_new_walks("65,522 tris", walk, rays_main, shapes, True)
    check_new_walks("999,698 tris", walk5, rays5, shapes5, False)
    phase_done("phase 15", t0)

    # ---- 16. the traversal A/B sweep at full width --------------------------
    t0 = time.time()
    sweep_rows, sweep_launches = sweep_at_full_width("65,522 tris", walk, ir,
                                                     shapes, 1024)
    rows5, launches5 = sweep_at_full_width("999,698 tris", walk5, ir5,
                                           shapes5, 1024)
    for k, v in launches5.items():
        sweep_launches[k] = sweep_launches.get(k, 0) + v
    print(f"[sweep] launches by variant over both scenes: "
          f"{ {str(k): v for k, v in sorted(sweep_launches.items())} }")
    phase_done("phase 16", t0)
    ir5_host = ir_to(ir5, "cpu")
    del ir5, walk5

    # ---- 17. sort_impl="counting" on the main path ---------------------------
    t0 = time.time()
    counting_ms = counting_sort_on_the_path(cfg, ir, shapes)
    phase_done("phase 17", t0)

    # ---- 18. the render server on the card ----------------------------------
    t0 = time.time()
    srv = server_path()
    n_srv = 16
    srv_total, srv_any_hit, srv_variants = srv["counts"]
    srv_closest = srv_total - srv_any_hit
    print(f"[server] OBJ text {srv['obj_mib']:.1f} MiB written in "
          f"{srv['obj_write_s']:.2f} s, parsed in {srv['obj_parse_s']:.2f} "
          f"s; loads over the wire {srv['load_s']:.2f} s; start (scene "
          f"build and upload) {srv['start_s']:.2f} s, the same build in "
          f"memory {srv['build_s']:.2f} s; devices {srv['devices']}")
    print(f"[server] 1024x1024 native 5 bounces, {n_srv} samples in the "
          f"render thread: {srv['ms_per_sample']:.1f} ms/sample (wall from "
          f"the start reply to the get_info that shows {n_srv}, polled "
          f"every ~50 ms), synchronous Renderer.step({n_srv}) "
          f"{srv['sync_ms_per_sample']:.1f}, the render thread alone "
          f"(Renderer.start, no server) {srv['thread_ms_per_sample']:.1f} "
          f"ms/sample; {srv_closest} "
          f"closest-hit and {srv_any_hit} any-hit launches on stream(s) "
          f"{srv['streams']} (default stream {srv['default_stream']}; the "
          f"captures' warm-ups on {srv['warmup_streams']}); "
          f"peak memory {srv['peak_mib']:.0f} MiB; snapshots seen "
          f"{srv['samples_seen']}")
    info_med = float(np.median(srv["info_ms"]))
    pass_med = float(np.median(srv["pass_ms"])) if srv["pass_ms"] else None
    print(f"[server] readback during the render: get_info "
          f"{len(srv['info_ms'])} round trips, median {info_med:.1f} ms "
          f"(max {max(srv['info_ms']):.1f}); get_pass beauty "
          f"{len(srv['pass_ms'])}, median {pass_med} ms (max "
          f"{max(srv['pass_ms'] or [0]):.1f}); one chunk of 8 samples "
          f"{srv['chunk_ms']:.0f} ms")
    print(f"[server] (a) beauty / normal against Renderer.step({n_srv}): "
          f"max |diff| {srv['a_max_abs_diff']} (0 = bit-equal); (b) denoise "
          f"pass against the CPU denoiser: {srv['b_close'] * 100:.4f}% of "
          f"values within rtol 1e-4 / atol 1e-5, max |diff| "
          f"{srv['b_max_abs_diff']:.3g}; denoise at 1024x1024 on the card "
          f"{srv['denoise_ms']:.1f} ms (median of 3, CUDA events), on the "
          f"CPU {srv['denoise_cpu_s']:.2f} s, the denoise round trip "
          f"{srv['denoise_round_trip_ms']:.0f} ms; (e) paused at, resumed "
          f"to, after abort: {srv['pause']}, the resumed render "
          f"{srv['resume_ms_per_sample']:.1f} ms/sample (its captured graph "
          f"replayed, get_info polled, no pass read)")
    if srv_closest != 5 * n_srv or srv_any_hit != 5 * n_srv:
        fail(f"server: (c) {srv_closest} closest-hit and {srv_any_hit} "
             f"any-hit launches over {n_srv} samples, expected 5 and 5 per "
             f"sample")
    add_path_launches("server path", {DEFAULT: 10 * n_srv}, srv_variants)
    if srv["sync_counts"] != (10 * n_srv, 5 * n_srv):
        fail(f"server: the synchronous render made {srv['sync_counts']} "
             f"launches")
    if srv["sync_profiled"] != (5, 5):
        fail(f"server: the profiler saw {srv['sync_profiled']} (closest-hit, "
             f"any-hit) launches in one replay of the synchronous render")
    if len(srv["streams"]) != 1 or srv["streams"][0] == srv["default_stream"]:
        fail(f"server: the render thread's launches went to streams "
             f"{srv['streams']}, not one stream of its own")
    if len(srv["warmup_streams"]) > 1 or srv["default_stream"] in srv[
            "warmup_streams"]:
        fail(f"server: the captures' warm-ups launched on streams "
             f"{srv['warmup_streams']}, not the capture stream alone")
    if not srv["pass_ms"] or not (info_med < srv["chunk_ms"]
                                  and pass_med < srv["chunk_ms"]):
        fail("server: (d) readback during the render is not shorter than "
             "one chunk")
    print(f"[server] OBJ parse of the {srv['obj_mib']:.1f} MiB text: "
          f"load_objs ({srv['obj_parse_route']} tokenizer) "
          f"{srv['obj_parse_s']:.3f} s; alone, the C++ tokenizer "
          f"{srv['obj_parse_cpp_s']:.3f} s and the Python tokenizer "
          f"{srv['obj_parse_python_s']:.3f} s, meshes equal")
    if srv["obj_parse_route"] != "c++":
        fail("server: load_objs did not take the C++ tokenizer")
    print(f"[server] (f) {len(RELOAD_ALBEDOS)} scenes of other albedos "
          f"loaded over the wire one after the other: each equals "
          f"Renderer.step({n_srv}) of it bit for bit; after each, the "
          f"denoise pass and the denoiser (guided and colour only) on a "
          f"crop of another size "
          f"{[(int(1024 * h), int(1024 * w)) for h, w in RELOAD_DENOISE_SHAPES]}"
          f": reserved memory {[round(m) for m in srv['reload_reserved_mib']]}"
          f" MiB (gate: a reload adds at most {RELOAD_SLACK_MIB} MiB), "
          f"captured denoisers {srv['reload_denoisers']} (gate: one per set "
          f"of guides); the synchronous render's graph, one replay under "
          f"the profiler: {srv['sync_profiled']} (closest-hit, any-hit) "
          f"launches")
    phase_done("phase 18", t0)

    # ---- 19. the host runtime and pixel sharding -------------------------
    t0 = time.time()
    host = host_runtime_path()
    host.update(lib_build_s=host_build_s, config5_setup_s=config5_setup_s,
                obj_mib=srv["obj_mib"], obj_parse_s=srv["obj_parse_s"],
                obj_parse_cpp_s=srv["obj_parse_cpp_s"],
                obj_parse_python_s=srv["obj_parse_python_s"])
    print(f"[host] SAH build of {host['tris']} tris (depth {host['depth']}, "
          f"max leaf {host['max_leaf']}): C++ {host['bvh_cpp_s']:.2f} s, "
          f"numpy {host['bvh_numpy_s']:.2f} s, perm / node ranges / max "
          f"leaf equal, boxes bit-equal; host runtime built in "
          f"{host_build_s:.1f} s; config 5 set-up {config5_setup_s:.1f} s "
          f"(PR 2's run, with the numpy build: {CONFIG5_NUMPY_SETUP_S} s)")
    ref = Renderer(cfg, ir)
    tr.reset_counts()
    ref.step(4)
    torch.cuda.synchronize()
    if (tr.launches, tr.any_hit_launches) != (40, 20):
        fail(f"sharding: Renderer.step(4) made {tr.launches} launches")
    ref_passes = ref.state["passes"].cpu().numpy()
    del ref
    shard = sharded_path(renderer_passes=ref_passes)
    del ref_passes
    for label, run in shard.items():
        for rank, r in enumerate(run["ranks"]):
            print(f"[sharding] {label} rank {rank}: {r['ms_per_sample']:.1f} "
                  f"ms/sample by replay (the eager step, first measured: "
                  f"{SHARDED_EAGER_MS} ms/sample on 1 rank), peak "
                  f"{r['peak_mib']:.0f} MiB, launches "
                  f"(closest-hit, any-hit) {r['launches']} over 4 samples")
            if tuple(r["launches"]) != (20, 20):
                fail(f"sharding {label} rank {rank}: launches "
                     f"{r['launches']}, expected 5 + 5 per sample")
        print(f"[sharding] {label}: gathered passes equal Renderer.step(4) "
              f"bit for bit; {run['wall_s']:.1f} s with the spawn")
    g = shard["n2_gloo"]["grad"]
    print(f"[sharding] n2_gloo loss and gradients at {g['res']}x{g['res']}, "
          f"{g['samples']} samples: loss {g['loss']:.8g} (one process "
          f"{g['loss_alone']:.8g}, rel diff {g['loss_rel_diff']:.3g}), "
          f"gradients' max |diff| / leaf max "
          f"{g['grad_max_diff_over_leaf_max']:.3g} (gate rtol 1e-5); by "
          f"replay {[round(x, 2) for x in g['ms_per_rank']]} ms per rank, "
          f"{g['ms_alone']:.2f} ms in one process. The 2 "
          f"ranks share one card: no scaling is claimed.")
    phase_done("phase 19", t0)

    # ---- 20. the compiled dispatch: CUDA graphs against eager ----------------
    t0 = time.time()
    dispatch_numbers = {"main": dispatch_path("main", cfg, ir, 4)}
    # Config 5 back on the card from its host copy (off the card after
    # phase 16, so that phases 17-19 run without its IR and cached
    # capture there).
    ir5 = ir_to(ir5_host, "cuda")
    del ir5_host
    dispatch_numbers["config5"] = dispatch_path("config5", cfg5, ir5, 4)
    # (d) of the main path, in a child process.
    dispatch_timed("main", dispatch_numbers["main"],
                   profile_step.profile_forward(cfg, ir, 4, top=8))
    del ir5
    ref = Renderer(cfg, ir)
    ref.step(4)
    dispatch_numbers["denoise"] = denoise_graph_check(ref.state)
    del ref
    phase_done("phase 20", t0)

    # ---- 21. the bench at its full shape -------------------------------------
    t0 = time.time()
    drop_captures(ir)
    bench = bench_phase(card)
    print(f"[bench] {json.dumps(bench)}")
    phase_done("phase 21", t0)

    # ---- 23. the applications: config 5's production render, the showcase,
    # the demo, the scaling harness ------------------------------------------
    t0 = time.time()
    resumed, resume_launches = resume_check()
    apps = applications_path()
    apps["resume_check"] = resumed
    apps["launches"]["config5"] = [
        a + b for a, b in zip(apps["launches"]["config5"], resume_launches)]
    print(f"[scaling] 1 rank: {apps['scaling']['rows'][0]['ms_per_sample']} "
          f"ms/sample by the harness (its slowest rank), beside phase 19's "
          f"1-rank replay {shard['n1_nccl']['ranks'][0]['ms_per_sample']:.1f}")
    app_launches = apps["launches"]
    phase_done("phase 23", t0)

    src = "elevenrender_tpu_torch/csrc/bvh_traverse.cu"
    row12 = "elevenrender_tpu/ops/bvh_pallas.py:102"
    row3 = "elevenrender_tpu/ops/bvh_pallas.py:102 (stream=True)"
    row4 = ("elevenrender_tpu/ops/bvh_pallas.py:102 (count_steps :286, "
            "order=sign :371, leaf_aabb :260, leaf_mode :330)")

    def entry(name, replaces, launches, err, t, extra=None, source=src):
        e = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches, max_abs_err=err, ms=t["ms"],
                 plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                 bound_by=t["bound_by"], library_ms=None)
        e.update(extra or {})
        return e

    def against_v1(t, any_hit, dep, extra):
        """Rows 1-3: the time of binary-v1 in the same turns, both
        spreads, and the kernel's resources: ptxas, the block's dynamic
        shared memory (its threads' stacks) at this depth, the blocks
        that fit on an SM (the persistent grid's second factor)."""
        return {**extra, "ms_v1": t["ms_v1"], "vs_v1": t["vs_v1"],
                "spread_ms": t["spread_ms"],
                "spread_ms_v1": t["spread_ms_v1"],
                "faster_beyond_spread": t["beyond_spread"],
                **ptxas_of("bvh_traverse", "bvh_traverse_walkIL"
                           f"b{int(any_hit)}ELb0ELb0ELi0ELi0E"),
                "shared_bytes_per_block": tr.stack_bytes(dep),
                "blocks_per_sm": tr.blocks_per_sm("cuda", dep, any_hit)}

    def grad_replay_launches(numbers, i):
        """The gradient path's launches of this kernel per graph replay
        (phase 14), closest-hit (i = 0) or any-hit: by the accounting of
        this run's replays where phase 14 counted them pass by pass, and
        by the profiler in profile_grad's child process, whose captures
        are its own (``_profiled_in_child``)."""
        out = {f"launches_per_gradient_{k}_replay": v[i]
               for k, v in numbers.get("launches_per_replay", {}).items()}
        out.update({f"launches_per_gradient_{k}_replay_profiled_in_child":
                    v[i] for k, v in
                    numbers.get("launches_profiled_in_child", {}).items()})
        return out

    c5_grad = gradient["config5"]["launches_counted"]
    kern = [
        entry("bvh_traverse closest-hit", row12,
              main_closest + grad_launches[("near", 0)][0] + srv_closest
              + inv_launches[0] + app_launches["rows12"][0],
              err12["closest"], timing["closest_b1"],
              against_v1(
                  timing["closest_b1"], False, depth,
                  {"ms_bounce0": timing["closest_b0"]["ms"],
                   "ms_v1_bounce0": timing["closest_b0"]["ms_v1"],
                   "launches_forward_path": main_closest,
                   "launches_gradient_path": grad_launches[("near", 0)][0],
                   "launches_server_path": srv_closest,
                   "launches_inverse_path": inv_launches[0],
                   "launches_demo_and_scaling_harness":
                       app_launches["rows12"][0],
                   "launches_per_graph_replay":
                       dispatch_numbers["main"]["profiled"][0],
                   **grad_replay_launches(gradient, 0)})),
        entry("bvh_traverse any-hit", row12,
              main_any_hit + grad_launches[("near", 0)][1] + srv_any_hit
              + inv_launches[1] + app_launches["rows12"][1],
              err12["any_hit"], timing["any_hit_b1"], against_v1(
                  timing["any_hit_b1"], True, depth,
                  {"launches_forward_path": main_any_hit,
                   "launches_gradient_path":
                       grad_launches[("near", 0)][1],
                   "launches_server_path": srv_any_hit,
                   "launches_inverse_path": inv_launches[1],
                   "launches_demo_and_scaling_harness":
                       app_launches["rows12"][1],
                   "launches_per_graph_replay":
                       dispatch_numbers["main"]["profiled"][1],
                   **grad_replay_launches(gradient, 1)})),
        entry("bvh_traverse closest-hit, stream residency (config 5)", row3,
              c5_closest + c5_grad[0] + app_launches["config5"][0],
              err3["closest"],
              timing5["closest_b1"], against_v1(
                  timing5["closest_b1"], False, depth5,
                  {"ms_bounce0": timing5["closest_b0"]["ms"],
                   "ms_v1_bounce0": timing5["closest_b0"]["ms_v1"],
                   "launches_forward_path": c5_closest,
                   "launches_gradient_path": c5_grad[0],
                   "launches_production_render": app_launches["config5"][0],
                   "launches_per_graph_replay":
                       dispatch_numbers["config5"]["profiled"][0],
                   **grad_replay_launches(gradient["config5"], 0)})),
        entry("bvh_traverse any-hit, stream residency (config 5, merged "
              "2N-ray shadow launch)", row3,
              c5_any_hit + c5_grad[1] + app_launches["config5"][1],
              err3["any_hit"], timing5["any_hit_b1"],
              against_v1(timing5["any_hit_b1"], True, depth5, {
                  "launches_forward_path": c5_any_hit,
                  "launches_gradient_path": c5_grad[1],
                  "launches_production_render": app_launches["config5"][1],
                  "launches_per_graph_replay":
                      dispatch_numbers["config5"]["profiled"][1],
                  **grad_replay_launches(gradient["config5"], 1)})),
    ]
    # Row 4, the variants a render can ask for: launched on the gradient
    # path (phase 14), timed at the main path's shapes (phase 12), held
    # to the plain version bit for bit in phase 11 (its error there).
    for order, leaf_aabb in RENDER_VARIANTS[1:]:
        for i, shape in enumerate(("closest", "any-hit")):
            t = vt[(order, leaf_aabb, "full", False, shape)]
            kern.append(entry(
                f"bvh_traverse {shape}, order={order} leaf_aabb={leaf_aabb}",
                row4, grad_launches[(order, leaf_aabb)][i], t["err"], t,
                {"counters_per_ray": t["counters"],
                 "ms_config5": vt5[(order, leaf_aabb, "full", False,
                                    shape)]["ms"]}))
    # Row 4's instruments belong on no render path: the counters feed the
    # bounds above, the probes split a launch's time.  Their launches are
    # what the wrapper counted over the driven paths, and must be 0.
    instruments = []
    for leaf_mode, count in (("full", True), ("noscan", False),
                             ("skip", False)):
        for shape in ("closest", "any-hit"):
            t = vt[("near", 0, leaf_mode, count, shape)]
            instruments.append(entry(
                f"bvh_traverse {shape}, "
                + ("count_steps" if count else f"leaf_mode={leaf_mode}"),
                row4, path_launches.get(("near", 0, leaf_mode, count), 0),
                t["err"], t,
                {"counters_per_ray": t["counters"],
                 "ms_config5": vt5[("near", 0, leaf_mode, count,
                                    shape)]["ms"]}))
    # Rows 5 and 6, the walks of the A/B sweep: timed and counted there
    # (phase 16) on the main scene's recorded launches, held to their plain
    # versions bit for bit in phase 15 (its error and the plain version's
    # time there).  No render path launches them.
    row5 = "elevenrender_tpu/ops/bvh_pallas.py:430"
    row6 = "elevenrender_tpu/experiments/bvh_wide.py:72"
    by_cell = {(r["scene"], r["ray_set"], r["kernel"]): r
               for r in sweep_rows + rows5}
    for kernel, mode in ([(k_, "closest") for k_ in NEW_WALKS]
                         + [(ANY_HIT_WALK, "any-hit")]):
        ray_set = ("recorded bounce 1" if mode == "closest"
                   else "recorded shadow")
        r_ = by_cell[("65,522 tris", ray_set, kernel)]
        wide = kernel == sweep.WIDE
        lib = "bvh_wide" if wide else "bvh_frontier"
        launched = sum(v for k_, v in sweep_launches.items()
                       if k_[0] == kernel)
        on_render_paths = sum(v for k_, v in path_launches.items()
                              if k_[0] == kernel)
        if on_render_paths:
            fail(f"{kernel} was launched {on_render_paths} times on a "
                 f"render path")
        t = dict(r_, plain_ms=new_plain[(kernel, mode)][0])
        cells = {(sc, rs): c_ for (sc, rs, k_), c_ in by_cell.items()
                 if k_ == kernel and c_["mode"] == r_["mode"]}
        # The lane-tile design's resources at each scene's depth: shared
        # memory a block (the warps' scan scratch and the tiles' stacks)
        # and the blocks that fit on an SM (the persistent grid's factor).
        if wide:
            levels = {sc: len(bvh_wide.level_offsets(dep))
                      for sc, dep in (("65,522 tris", depth),
                                      ("999,698 tris", depth5))}
            shared = {sc: bvh_wide.shared_bytes(m) for sc, m in levels.items()}
            fit = {sc: bvh_wide.blocks_per_sm("cuda", m)
                   for sc, m in levels.items()}
        else:
            k_ = int(kernel.split("=")[1])
            shared = {sc: tr.frontier_shared_bytes(k_, dep)
                      for sc, dep in (("65,522 tris", depth),
                                      ("999,698 tris", depth5))}
            fit = {sc: tr.frontier_blocks_per_sm("cuda", k_, dep)
                   for sc, dep in (("65,522 tris", depth),
                                   ("999,698 tris", depth5))}
        extra = {"launches_render_paths": 0,
                 "design": ("one ray per lane tile, the warp's leaf scans "
                            "pooled, stacks in shared memory, persistent "
                            "grid"),
                 "tile_lanes": (bvh_wide.WIDE if wide
                                else tr.frontier_tile(int(kernel.split("=")[1]))),
                 "counters_per_ray": r_["counters"],
                 "vs_binary": r_["vs_binary"],
                 "share_of_bound": r_["bound_ms"] / r_["ms"],
                 "ms_by_ray_set": {f"{sc} {rs}": c_["ms"]
                                   for (sc, rs), c_ in cells.items()},
                 "vs_binary_by_ray_set": {f"{sc} {rs}": c_["vs_binary"]
                                          for (sc, rs), c_ in cells.items()},
                 "bound_ms_by_ray_set": {f"{sc} {rs}": c_["bound_ms"]
                                         for (sc, rs), c_ in cells.items()},
                 "shared_bytes_per_block": shared,
                 "blocks_per_sm": fit,
                 **ptxas_of(lib, "Lb0E" if wide else
                            f"ILi{kernel.split('=')[1]}ELb0E")}
        kern.append(entry(
            f"bvh_{'wide' if wide else 'frontier'} {mode}"
            + ("" if wide else f", {kernel}"),
            row6 if wide else row5, launched, new_plain[(kernel, mode)][1],
            t, extra, source=f"elevenrender_tpu_torch/csrc/{lib}.cu"))
    # binary-v1, the first version of rows 1-3: launched by the sweep
    # alone (phase 16), held to its plain version in phase 15 and to the
    # binary kernel exactly in phase 16.
    for mode in ("closest", "any-hit"):
        ray_set = ("recorded bounce 1" if mode == "closest"
                   else "recorded shadow")
        r_ = by_cell[("65,522 tris", ray_set, sweep.V1)]
        on_render_paths = sum(v for k_, v in path_launches.items()
                              if k_[0] == sweep.V1)
        if on_render_paths:
            fail(f"binary-v1 was launched {on_render_paths} times on a "
                 f"render path")
        kern.append(entry(
            f"bvh_traverse_v1 {mode} (binary-v1, the first design of rows "
            f"1-3)", row12,
            sum(v for k_, v in sweep_launches.items() if k_[0] == sweep.V1),
            new_plain[(sweep.V1, mode)][1],
            dict(r_, plain_ms=new_plain[(sweep.V1, mode)][0]),
            {"launches_render_paths": 0, "counters_per_ray": r_["counters"],
             "vs_binary": r_["vs_binary"],
             "ms_by_ray_set": {
                 f"{sc} {rs}": c_["ms"]
                 for (sc, rs, k_), c_ in by_cell.items()
                 if k_ == sweep.V1 and c_["mode"] == r_["mode"]},
             **ptxas_of("bvh_traverse_v1", "v1_kernelILb0E")},
            source="elevenrender_tpu_torch/csrc/bvh_traverse_v1.cu"))
    # Rows 7-8, the hit-data kernels: launched on the forward paths of
    # phases 4 and 8 (their wrappers' counts over the timed samples), held
    # to the PyTorch ops bit for bit and timed alone in phase 24 (cell 1's
    # scene; config 5's beside it).
    for key, name, replaces in (
            ("tri", "hitdata_tri_gather",
             "none: ops/intersect.py gather_tri + full_hit (PyTorch ops)"),
            ("material", "hitdata_material_gather",
             "none: render/integrator.py _generate_hitdata (PyTorch ops)")):
        t, t5 = (hitdata_numbers[k][key] for k in ("main path", "config5"))
        kern.append(entry(
            name, replaces,
            hitdata_launched["main"][key] + hitdata_launched["config5"][key],
            0.0, {"ms": t["ms"], "plain_ms": t["pytorch_ms"],
                  "bound_ms": t["bound_ms"], "bound_by": "bytes"},
            {"launches_forward_path": hitdata_launched["main"][key],
             "launches_config5_path": hitdata_launched["config5"][key],
             "bytes": t["bytes"], "ms_config5": t5["ms"],
             "plain_ms_config5": t5["pytorch_ms"],
             "bound_ms_config5": t5["bound_ms"], "bytes_config5": t5["bytes"],
             **ptxas_of("hitdata", f"{name}")},
            source="elevenrender_tpu_torch/csrc/hitdata.cu"))
    for e in kern:
        if e["launches"] < 1:
            fail(f"kernel {e['name']!r} was launched no time on its path")
    for e in instruments:
        if e["launches"]:
            fail(f"instrument {e['name']!r} was launched {e['launches']} "
                 f"times on a render path")
    print(f"[launches] by variant (order, leaf_aabb, leaf_mode, "
          f"count_steps) over the driven paths: "
          f"{ {str(k): v for k, v in sorted(path_launches.items())} }")
    print(f"[done] {time.time() - t_start:.1f} s")
    server_numbers = {k: srv[k] for k in (
        "ms_per_sample", "sync_ms_per_sample", "thread_ms_per_sample",
        "chunk_ms", "start_s",
        "build_s", "obj_parse_s", "load_s", "denoise_ms", "denoise_cpu_s",
        "denoise_round_trip_ms", "peak_mib", "a_max_abs_diff", "b_close",
        "reload_reserved_mib", "resume_ms_per_sample")}
    server_numbers.update(readback_info_ms_median=info_med,
                          readback_pass_ms_median=pass_med)
    print(json.dumps({"kernels": kern, "instruments": instruments,
                      "counting_ms_per_sample": counting_ms,
                      "server_path": server_numbers,
                      "host_runtime": host, "sharding": shard,
                      "dispatch": dispatch_numbers, "gradient": gradient,
                      "inverse": inverse, "profile_child": profile_child,
                      "hitdata": hitdata_numbers,
                      "config5_rows_card_vs_cpu": stripe5,
                      "applications": {k: v for k, v in apps.items()
                                       if k != "launches"}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
