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
    1024x1024, 5 bounces, through Renderer.step (1 warm-up sample, then 8
    timed), with the kernel's launch counts;
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
    (1 warm-up sample, then 4 timed), 5 closest-hit launches of 1M rays
    and 5 merged any-hit launches of 2M rays per sample, peak memory;
 9. a small textured, lit heightfield at 64x64, one sample, card against
    CPU;
10. at config 5's recorded shapes: the kernel against its plain version,
    with its times and bound, as in phase 6;
11. the kernel's variants (order near/sign x leaf_aabb 0/1/2, the
    noscan/skip probes, count_steps) against the plain version under the
    same flags: at 65,522 tris on 65,536 camera rays, 65,536 random rays
    (each closest-hit and any-hit) and the recorded bounce-1 and shadow
    launches; at 999,698 tris on the random rays closest-hit and the two
    recorded launches: ids equal, t bit-equal, the four per-ray counters
    equal; leaf_aabb is a pure cull; sign gives near's hits up to equal-t
    ties;
12. the variants timed at both paths' recorded shapes beside the default
    kernel, their mean counters per ray, and each bound from the
    kernel's own counters; the noscan/skip probes keep the default's
    schedule and grid, so they split its time into walk and scans;
13. the gradient path at 64x64, 5 bounces, 4 samples, card against CPU,
    on the untextured and the textured, lit scene: loss and every
    material gradient leaf; a replayed pass 2 equals a re-traced one
    exactly and launches no traversal;
14. the gradient path at full width: fwd_bwd_step_accum at 1024x1024, 5
    bounces, 8 samples on the 65,522-tri scene (pass 1 records, pass 2
    replays), its time, rays/s and peak memory; then one sample under
    each other (order, leaf_aabb) variant: the same loss.
15. the frontier-K walk (K = 2, 4, 8 closest-hit, K = 4 any-hit too), the
    8-wide walk and binary-v1 (closest-hit and any-hit) against their
    plain versions at 65,522 and 999,698 tris, on 65,536 camera rays,
    65,536 random rays and a 65,536-ray strided subset of the recorded
    bounce-1 and shadow launches, and on the main path's full recorded
    launches: ids equal, t bit-equal, counters equal, the same deepest
    stack, no push refused;
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
    5 bounces renders with it (10 launches per sample), timed in turns
    beside sort_impl="argsort";
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
    holds the count, a bare start resumes to 48, abort resets to 0;
19. (a) the host runtime: config 5's 999,698 tris through the C++ SAH
    build and the numpy build, both timed: perm, node ranges and max
    leaf equal, boxes bit-equal; (b) pixel sharding over
    torch.distributed (elevenrender_tpu_torch/parallel/), spawned ranks:
    the main path (65,522 tris, 1024x1024, 5 bounces, 4 samples) on 1
    rank over NCCL and on 2 ranks that share the card over gloo, through
    sharded_render_step and gather_image, equal to Renderer.step(4) bit
    for bit, with 5 closest-hit and 5 any-hit launches per sample on
    every rank and each rank's ms/sample and peak memory (the 2 ranks
    share one card: no scaling is measured); the sharded loss and
    gradients at 64x64 on 2 ranks equal one process's within rtol 1e-5.
The last two lines are one JSON object with the kernels' numbers (and
the server path's, the host runtime's and the sharded path's) and one
with the result: {"ok": true, "device": {...}}.
"""

import json
import re
import subprocess
import sys
import time

CONFIG5_TRIS = 999698
# Config 5's set-up time with the numpy SAH build, in the run that first
# built it on the card's host (chip_smoke.py phase 7, NVIDIA H100 80GB
# HBM3, 700.00 W): printed beside this run's set-up time for scale only,
# never carried as a result of this run.
CONFIG5_NUMPY_SETUP_S = 47.9
# Ray counts of phase 3's ragged checks: a tail of 31 after 2047 full runs
# of 32, one run and a ray, less than a run, a single ray.
RAGGED = (65535, 33, 31, 1)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


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


def server_path(res=1024, spp=16, target2=48, grid=182, device=""):
    """Phase 18: the render server on ``device`` ("" = the card, as a
    client that names none gets), driven through the client over
    localhost; see the module docstring.  Fails on any gate but the
    launch counts, which the caller reads from the returned dict
    (``counts``: the traversal wrapper's counts over the 16 samples,
    ``streams``: the CUDA streams its launches went to)."""
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
        streams = set()

        def spy(tables, ray_o, *args, **kw):
            if cuda:
                streams.add(torch.cuda.current_stream(ray_o.device)
                            .cuda_stream)
            return real_launch(tables, ray_o, *args, **kw)

        tr._launch = spy
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
        out["counts"] = (tr.launches, tr.any_hit_launches,
                         dict(tr.variant_launches))
        out["streams"] = sorted(streams)
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
        inbox, sent = [], []
        ref_sess = commands.CommandSession(send=sent.append,
                                           recv=lambda: inbox.pop(0))
        for cmd, payloads in (
                ("--load_config", [Message.json_msg(config_json(spp))]),
                ("--load_camera", [Message.json_msg(WIRE_CAMERA)]),
                ("--load_brdf_material", [Message.json_msg(WIRE_MATERIAL)]),
                ("--load_hdri", [
                    Message.json_msg({"name": "hdri", "width": 32,
                                      "height": 16, "channels": 3,
                                      "color_space": "LINEAR"}),
                    Message.float_data(sky.reshape(-1))]),
                ("--load_object", [
                    Message("data", "string", obj_text.encode()),
                    Message("data", "string", mtl_text.encode())])):
            inbox.extend(payloads)
            ref_sess.handle_command(cmd)
        if [m.get_string_data() for m in sent] != ["ok"] * 5 or inbox:
            fail("server: the in-memory session did not take the messages")
        t0 = time.time()
        rcfg, rir = ref_sess.scene.build(config=ref_sess.config, device=dev)
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
        c.start()
        wait_for(c, lambda n: n >= target2, "the resumed render")
        time.sleep(0.2)
        s2 = c.get_info()["samples"]
        c.abort()
        s3 = c.get_info()["samples"]
        out["pause"] = (s1, s2, s3)
        if s2 != target2 or s3 != 0:
            fail(f"server: (e) resumed to {s2} of {target2}, abort left {s3}")
        c.close()
    finally:
        tr._launch = real_launch
        srv.shutdown()
        th.join(30)
    if th.is_alive():
        fail("server: the acceptor thread did not stop")
    return out


def host_runtime_path(grid=708):
    """Phase 19 (a): the heightfield's tris (grid 708: config 5's
    999,698) through the C++ SAH build and the numpy build, both timed;
    fails unless perm, node ranges and max leaf are equal and the boxes
    bit-equal."""
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
            "res": grad_res, "bounces": 5, "samples": grad_spp}
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
                                  "grad_max_diff_over_leaf_max": worst}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    import numpy as np

    from elevenrender_tpu_torch import kernels
    from elevenrender_tpu_torch import sweep_traverse as sweep
    from elevenrender_tpu_torch.convert import ir_to
    from elevenrender_tpu_torch.experiments import bvh_wide
    from elevenrender_tpu_torch.ops import sort as sort_ops
    from elevenrender_tpu_torch.ops import traverse as tr
    from elevenrender_tpu_torch.ops.camera import camera_ray
    from elevenrender_tpu_torch.render import grad as grad_mod
    from elevenrender_tpu_torch.render import integrator
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
    DEFAULT = ("near", 0, "full", False)

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
        add_path_launches(label, {DEFAULT: 10 * n_timed})
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

    RENDER_VARIANTS = [(o_, a_) for o_ in tr.ORDERS for a_ in (0, 1, 2)]

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

    def make_target(cfg, ir_, device):
        with torch.no_grad():
            st = integrator.render_sample(
                cfg, ir_, integrator.init_state(cfg, device), device=device)
        return st["passes"][integrator.BEAUTY, :, :3] * 1.5 + 0.1

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
              f"{cfg.max_bounces} bounces, {n} samples: loss {loss_c:.8f} "
              f"card / {loss_h:.8f} CPU; {len(res['cpu'][1]['materials'])} "
              f"material leaves ({nonzero} non-zero), worst |card - CPU| "
              f"{worst:.3g} of a leaf's largest entry; replay == re-trace "
              f"exactly; launches {replay_launches} with replay, "
              f"{retrace_launches} re-traced, {replayed_sample_launches} in "
              f"a replayed sample")

    def gradient_at_full_width(cfg, ir_):
        """fwd_bwd_step_accum at the main path's width, 8 samples, default
        RenderConfig (material_fetch="mm_bwd", replayed pass 2); then the
        accumulator's two passes again, each timed alone; then one sample
        under every other (order, leaf_aabb) variant.  Returns
        {(order, leaf_aabb): (closest-hit, any-hit) launches}."""
        n = 8
        res = cfg.x_res
        if cfg.material_fetch != "mm_bwd" or cfg.remat_bounces:
            fail("the gradient path is to run the default RenderConfig")
        target = make_target(cfg, ir_, "cuda")
        grad_mod.fwd_bwd_step_accum(cfg, ir_, target, 1)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr.reset_counts()
        t0 = time.time()
        loss, grads = grad_mod.fwd_bwd_step_accum(cfg, ir_, target, n)
        torch.cuda.synchronize()
        dt = time.time() - t0
        add_path_launches("gradient path", {DEFAULT: 10 * n})
        total, any_hit = tr.launches, tr.any_hit_launches
        launches = {("near", 0): (total - any_hit, any_hit)}
        peak = torch.cuda.max_memory_allocated() / 2**20
        g = grads["materials"]
        finite = all(bool(torch.isfinite(v).all()) for v in g.values())
        rays = 2 * cfg.max_bounces * res * res * n
        # The accumulator's own two passes, each timed alone.
        params = {"materials": grad_mod.float_subtree(ir_["materials"])}
        dev = target.device
        tr.reset_counts()
        t0 = time.time()
        _, seed, caches = grad_mod._accum_fwd(cfg, ir_, params, target, n,
                                              True, dev)
        torch.cuda.synchronize()
        pass1 = time.time() - t0
        pass1_launches = tr.launches
        t0 = time.time()
        again = grad_mod._accum_bwd(cfg, ir_, params, seed, caches, n, dev)
        torch.cuda.synchronize()
        pass2 = time.time() - t0
        pass2_launches = tr.launches - pass1_launches
        del seed, caches
        print(f"[gradient] fwd_bwd_step_accum {res}x{res}, "
              f"{cfg.max_bounces} bounces, {n} samples, material_fetch="
              f"{cfg.material_fetch}: {dt:.3f} s per fwd+bwd, "
              f"{rays / dt:.4g} rays/s; its two passes run again, each "
              f"timed alone: pass 1 {pass1 / n * 1e3:.1f} ms/sample, "
              f"{pass1_launches} kernel launches; pass 2 "
              f"{pass2 / n * 1e3:.1f} ms/sample, {pass2_launches} kernel "
              f"launches; peak memory {peak:.0f} MiB; remat_bounces not "
              f"needed")
        print(f"[gradient] loss {float(loss):.8f}, albedo gradient "
              f"{[round(x, 6) for x in g['albedo'].flatten().tolist()]}, "
              f"finite {finite}")
        if total != 10 * n or pass1_launches != 10 * n or pass2_launches:
            fail(f"gradient path: {total} kernel launches ({pass1_launches} "
                 f"in pass 1 alone, {pass2_launches} in pass 2 alone), "
                 f"expected {10 * n} (pass 1 only)")
        # The same sums, though atomic adds may take another order: each
        # leaf within 1e-5 of its largest entry.
        for k, v in g.items():
            gap = float((again["materials"][k] - v).abs().max())
            if not gap <= 1e-5 * float(v.abs().max()):
                fail(f"gradient path: leaf {k} of the two passes run alone "
                     f"differs from fwd_bwd_step_accum's by {gap:.3g}")
        if not (finite and bool(torch.isfinite(loss)) and float(loss) > 0
                and float(g["albedo"].abs().sum()) > 0):
            fail("gradient path: loss or gradients not finite and non-zero")
        base_loss, base_grads = grad_mod.fwd_bwd_step_accum(cfg, ir_,
                                                            target, 1)
        for order, leaf_aabb in RENDER_VARIANTS[1:]:
            tr.reset_counts()
            v_loss, v_grads = grad_mod.fwd_bwd_step_accum(
                cfg.replace(trace_order=order, leaf_aabb=leaf_aabb), ir_,
                target, 1)
            key = (order, leaf_aabb, "full", False)
            add_path_launches(f"gradient path under {key}", {key: 10})
            launches[(order, leaf_aabb)] = (
                tr.launches - tr.any_hit_launches, tr.any_hit_launches)
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
            print(f"[gradient] trace_order={order} leaf_aabb={leaf_aabb}, 1 "
                  f"sample: loss {float(v_loss):.8f} (default "
                  f"{float(base_loss):.8f}), albedo gradient differs by "
                  f"{gap:.3g}; 10 launches of this variant")
        return launches

    NEW_WALKS = ([sweep.frontier_name(k) for k in (2, 4, 8)] + [sweep.WIDE])
    ANY_HIT_WALK = sweep.frontier_name(sweep.ANY_HIT_FRONTIER)

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

    def check_new_walks(label, walk, rays, recorded, full):
        """Rows 5 and 6, and binary-v1, against their plain versions: the
        frontier-K walk (K = 2, 4, 8 closest-hit, K = 4 any-hit), the
        8-wide walk and binary-v1 (closest-hit and any-hit) on 65,536
        camera rays, 65,536 random rays (closest-hit, and any-hit for K =
        4 and binary-v1) and a 65,536-ray strided subset of the recorded
        bounce-1 and shadow launches; with ``full`` also on those whole
        launches, where the plain version is timed.  ids equal, t
        bit-equal, counters equal on every ray, with and without
        count_steps; the frontier's deepest stack equal and no push
        refused.  Returns {(kernel, mode): (plain ms, max |t - t_plain|)}
        at the full launches."""
        def strided(rays_):
            step = max(rays_[0].shape[0] // 65536, 1)
            return tuple(None if x is None else x[::step].contiguous()
                         for x in rays_)

        cam, rnd = rays["camera rays"], rays["random rays"]
        sets = [("camera rays", cam[0], cam[1], None, None),
                ("random rays", rnd[0], rnd[1], None, None),
                ("random rays", *rnd),
                ("recorded bounce 1 subset", *strided(recorded["closest_b1"])),
                ("recorded shadow subset", *strided(recorded["any_hit_b1"]))]
        if full:
            sets += [("recorded bounce 1", *recorded["closest_b1"]),
                     ("recorded shadow", *recorded["any_hit_b1"])]
        out = {}
        checked = 0
        deepest = {}
        for name, o, d, ex, tm in sets:
            mode = "closest" if ex is None else "any-hit"
            for kernel in (NEW_WALKS + [sweep.V1] if ex is None
                           else [ANY_HIT_WALK, sweep.V1]):
                what = f"{label} {name} {mode} {kernel}"
                ki, kt, kc = sweep.run(walk, kernel, o, d, ex, tm,
                                       count_steps=True)
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
                        fail(f"{what}: stack {k_stack} in the kernel, "
                             f"{p_stack} in the plain version")
                    if p_stack["refused"]:
                        fail(f"{what}: {p_stack['refused']} pushes refused")
                    deepest[kernel] = max(deepest.get(kernel, 0),
                                          p_stack["deepest"])
                checked += 1
                if name in ("recorded bounce 1", "recorded shadow"):
                    gap = torch.nan_to_num(kt - pt, nan=0.0).abs().max()
                    out[(kernel, mode)] = (took, float(gap))
        rows = {k: tr.frontier_stack_rows(int(k.split("=")[1]), walk["depth"])
                for k in deepest}
        print(f"[new walks] {label}: {checked} (kernel, ray set) pairs, each "
              f"with and without count_steps, on {len(sets)} ray sets: ids "
              f"equal, t bit-equal, counters equal to the plain version on "
              f"every ray; no push refused, deepest stack (of its rows) "
              f"{ {k: f'{v} of {rows[k]}' for k, v in deepest.items()} }")
        return out

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
        images = {impl: r_.get_pass("beauty").reshape(res, res, 4)[..., :3]
                  for impl, r_ in renderers.items()}
        close = np.isclose(images["counting"], images["argsort"], rtol=1e-4,
                           atol=1e-5).all(axis=-1).mean()
        print(f"[counting] Renderer.step {res}x{res}, {cfg.max_bounces} "
              f"bounces, ms/sample in turns (2 rounds of {n} samples): "
              f"sort_impl=argsort {[round(t, 1) for t in times['argsort']]}, "
              f"sort_impl=counting "
              f"{[round(t, 1) for t in times['counting']]}; 10 launches per "
              f"sample under both; after {1 + 2 * n} samples "
              f"{close * 100:.2f}% of pixels within rtol 1e-4 / atol 1e-5, "
              f"means {images['counting'].mean():.6f} / "
              f"{images['argsort'].mean():.6f}")
        if (not np.isfinite(images["counting"]).all()
                or not images["counting"].mean() > 0 or close < 0.99):
            fail("sort_impl=counting: the render is not finite, positive "
                 "and equal to the argsort render on 99% of pixels")
        return times

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
    phase_done("phase 9", t0)

    # ---- 10. kernel timing at config 5's shapes -----------------------------
    t0 = time.time()
    timing5, shapes5 = timing_at_recorded_shapes("config5", cfg5, ir5,
                                                 depth5)
    phase_done("phase 10", t0)
    err3 = {k: max(v) for k, v in errs.items()}

    # ---- 11. the kernel's variants against the plain version ---------------
    t0 = time.time()
    plain_ms = {}
    for label, tables, dep, rays, rec, only in (
            ("65,522 tris", ir["kernel"], depth, rays_main, shapes, None),
            ("999,698 tris", ir5["kernel"], depth5, rays5, shapes5,
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
    grad_launches = gradient_at_full_width(cfg, ir)
    phase_done("phase 14", t0)

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
          f"{srv['streams']} (default stream {srv['default_stream']}); "
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
          f"to, after abort: {srv['pause']}")
    if srv_closest != 5 * n_srv or srv_any_hit != 5 * n_srv:
        fail(f"server: (c) {srv_closest} closest-hit and {srv_any_hit} "
             f"any-hit launches over {n_srv} samples, expected 5 and 5 per "
             f"sample")
    add_path_launches("server path", {DEFAULT: 10 * n_srv}, srv_variants)
    if srv["sync_counts"] != (10 * n_srv, 5 * n_srv):
        fail(f"server: the synchronous render made {srv['sync_counts']} "
             f"launches")
    if len(srv["streams"]) != 1 or srv["streams"][0] == srv["default_stream"]:
        fail(f"server: the render thread's launches went to streams "
             f"{srv['streams']}, not one stream of its own")
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
                  f"ms/sample, peak {r['peak_mib']:.0f} MiB, launches "
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
          f"{g['grad_max_diff_over_leaf_max']:.3g} (gate rtol 1e-5). The 2 "
          f"ranks share one card: no scaling is claimed.")
    phase_done("phase 19", t0)

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

    kern = [
        entry("bvh_traverse closest-hit", row12,
              main_closest + grad_launches[("near", 0)][0] + srv_closest,
              err12["closest"], timing["closest_b1"], against_v1(
                  timing["closest_b1"], False, depth,
                  {"ms_bounce0": timing["closest_b0"]["ms"],
                   "ms_v1_bounce0": timing["closest_b0"]["ms_v1"],
                   "launches_forward_path": main_closest,
                   "launches_gradient_path": grad_launches[("near", 0)][0],
                   "launches_server_path": srv_closest})),
        entry("bvh_traverse any-hit", row12,
              main_any_hit + grad_launches[("near", 0)][1] + srv_any_hit,
              err12["any_hit"], timing["any_hit_b1"], against_v1(
                  timing["any_hit_b1"], True, depth,
                  {"launches_forward_path": main_any_hit,
                   "launches_gradient_path":
                       grad_launches[("near", 0)][1],
                   "launches_server_path": srv_any_hit})),
        entry("bvh_traverse closest-hit, stream residency (config 5)", row3,
              c5_closest, err3["closest"], timing5["closest_b1"], against_v1(
                  timing5["closest_b1"], False, depth5,
                  {"ms_bounce0": timing5["closest_b0"]["ms"],
                   "ms_v1_bounce0": timing5["closest_b0"]["ms_v1"]})),
        entry("bvh_traverse any-hit, stream residency (config 5, merged "
              "2N-ray shadow launch)", row3, c5_any_hit, err3["any_hit"],
              timing5["any_hit_b1"],
              against_v1(timing5["any_hit_b1"], True, depth5, {})),
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
        extra = {"launches_render_paths": 0,
                 "counters_per_ray": r_["counters"],
                 "vs_binary": r_["vs_binary"],
                 "ms_by_ray_set": {
                     f"{sc} {rs}": c_["ms"]
                     for (sc, rs, k_), c_ in by_cell.items()
                     if k_ == kernel and c_["mode"] == r_["mode"]},
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
        "denoise_round_trip_ms", "peak_mib", "a_max_abs_diff", "b_close")}
    server_numbers.update(readback_info_ms_median=info_med,
                          readback_pass_ms_median=pass_med)
    print(json.dumps({"kernels": kern, "instruments": instruments,
                      "counting_ms_per_sample": counting_ms,
                      "server_path": server_numbers,
                      "host_runtime": host, "sharding": shard}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
