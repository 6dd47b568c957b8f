"""Multi-process dry run of the sharded render path.

    python -m elevenrender_tpu_torch.parallel.dryrun --ranks N [--device cpu]

The counterpart of the JAX package's ``__graft_entry__.py
dryrun_multichip``: ``dryrun_multichip(n)`` spawns ``n`` ranks (one
process each, joined by ``torch.distributed``) on the 32x32 Cornell box.
Every rank builds the scene, renders one sample of its slice through
``Renderer(config, ir, mesh=mesh)`` (on a card a replay of the sample
captured at the slice's offset) and reads the image back
(``Renderer.read_image``: rank 0 gets the gathered image), then the
sharded loss and gradients
against a zero target (``mesh.sharded_loss_and_grad``, on a card a
replay of the captured loss-and-gradient graph; gradients
all-reduced).  The parent
process checks both for finite values and against the same work in one
process (the image bit for bit, the loss and gradients within rtol
1e-5, which is only another order of the same sums), and prints one
line.

The JAX version has a third stage, ``shard_map`` with the Pallas
traversal inside each shard, because GSPMD cannot partition a
``pallas_call``.  Here there is nothing to partition: every rank is its
own process and launches the CUDA traversal kernel itself on its card,
so the forward step above is that stage.

``run_ranks`` is the spawner the tests and ``chip_smoke.py`` use too.
Each rank runs ``run_tasks`` on a list of tasks (dicts: a scene, a
resolution, samples; see ``run_tasks``) and sends its results back.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch

from ..core.device import resolve_device
from . import distributed
from . import mesh as pm

# A rank that has not reported this long after the spawn is taken as
# lost: every rank is ended and the run fails.
JOIN_TIMEOUT_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _scene(name: str, res: int, grid: int | None, device):
    from ..scene import demo
    if name == "cornell":
        return demo.cornell_scene(res=res, device=device)
    build = {"heightfield": demo.heightfield_scene,
             "textured": demo.textured_heightfield_scene}[name]
    return build(grid=grid, res=res, device=device)


def run_tasks(mesh: pm.PixelMesh, tasks: list) -> list:
    """Run ``tasks`` on this rank, in order; returns one dict each.

    A task: ``{"kind": "render" | "grad", "scene": "cornell" |
    "heightfield" | "textured", "res": int, "grid": int (heightfields),
    "samples": int, "bounces": int (default the scene's), "warmup":
    bool}``; a "grad" task's target is a black image.  Every rank builds
    the scene itself and renders its slice from fresh state.

    A render steps a ``Renderer`` on ``mesh`` ``samples`` times and
    returns ``passes`` (the gathered [P, npix, 4] of ``read_image`` as
    numpy on rank 0, None elsewhere), this rank's ``launches``
    (closest-hit, any-hit kernel launches over the samples),
    ``ms_per_sample`` (host clock, synchronized), ``peak_mib`` (CUDA)
    and ``tris``.  A grad returns ``loss``, ``grads`` (the material
    tree, numpy) and ``ms`` (host clock, synchronized).  On a card the
    steps are graph replays (the renderer's captured sample,
    ``mesh.sharded_loss_and_grad``): with ``warmup`` the first call,
    which runs eagerly and captures, is made before the timed ones (for
    a render, by a renderer of its own on the same IR, whose capture the
    timed one replays)."""
    from ..convert import params_to_numpy
    from ..ops import traverse as tr
    from ..render.grad import float_subtree
    from ..render.renderer import Renderer

    cuda = mesh.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(mesh.device)

    out = []
    for task in tasks:
        _, config, ir = _scene(task["scene"], task["res"], task.get("grid"),
                               mesh.device)
        config = config.replace(compat=False)
        if "bounces" in task:
            config = config.replace(max_bounces=task["bounces"])
        ir = pm.replicate_ir(ir, mesh)
        if task["kind"] == "grad":
            target = torch.zeros(
                (mesh.local_pixels(config.x_res * config.y_res), 3),
                device=mesh.device)
            params = {"materials": float_subtree(ir["materials"])}

            def grad_step():
                return pm.sharded_loss_and_grad(config, ir, params, target,
                                                task["samples"], mesh)

            if task.get("warmup"):
                grad_step()
            sync()
            t0 = time.perf_counter()
            loss, grads = grad_step()
            sync()
            out.append({"loss": float(loss),
                        "grads": params_to_numpy(grads),
                        "ms": (time.perf_counter() - t0) * 1e3})
            continue
        if task.get("warmup"):
            Renderer(config, ir, mesh=mesh).step(1)
        renderer = Renderer(config, ir, mesh=mesh)
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(mesh.device)
        tr.reset_counts()
        t0 = time.perf_counter()
        renderer.step(task["samples"])
        sync()
        seconds = time.perf_counter() - t0
        launches = (tr.launches - tr.any_hit_launches, tr.any_hit_launches)
        image = renderer.read_image()
        passes = None if image is None else image["passes"]
        out.append({
            "passes": None if passes is None else passes.cpu().numpy(),
            "launches": launches,
            "ms_per_sample": seconds / task["samples"] * 1e3,
            "peak_mib": (torch.cuda.max_memory_allocated(mesh.device) / 2**20
                         if cuda else None),
            "tris": int(ir["tris"]["verts"].shape[0])})
    return out


def _rank_main(rank, world, init_method, backend, device, tasks, results,
               work):
    """One spawned rank: join the group, run ``work(mesh, tasks)``,
    report."""
    import torch.distributed as dist
    if torch.device(device).type == "cpu":
        # The ranks share the host's cores: one share each, not all, and
        # no more than the threads this process starts with (its
        # OMP_NUM_THREADS).
        torch.set_num_threads(min(torch.get_num_threads(), max(
            1, (os.cpu_count() or world) // world)))
    try:
        distributed.initialize(init_method, world, rank, backend, device)
        mesh = distributed.global_mesh(device)
        results.put((rank, "ok", work(mesh, tasks)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(tasks: list, world: int, device="cuda",
              backend: str | None = None, init_method: str | None = None,
              timeout: float = JOIN_TIMEOUT_S, work=run_tasks) -> list:
    """Spawn ``world`` ranks that each run ``work(mesh, tasks)`` (a
    module-level function: the ranks import it by name) and return their
    results, by rank.  ``init_method`` defaults to TCP on a
    free localhost port; ``backend`` to ``initialize``'s choice for
    ``device``.  A rank that fails, or has not reported within
    ``timeout`` seconds, ends the run: every rank still alive is killed
    and ``RuntimeError`` raised with what the ranks said."""
    if init_method is None:
        init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, init_method, backend, str(device),
                               tasks, results, work))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    # A rank that exited without a report, and since when.
    silent = {}
    try:
        while len(got) < world and not errors:
            try:
                rank, status, payload = results.get(timeout=0.5)
                # A failed rank ends the wait: the others may wait on it
                # in a collective forever.
                (got if status == "ok" else errors)[rank] = payload
                continue
            except queue.Empty:
                pass
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r not in got and p.exitcode is not None:
                    silent.setdefault(r, now)
            # Its report may still be in the pipe for a moment.
            lost = [r for r, t in silent.items() if r not in got
                    and now - t > 5.0]
            errors.update({r: f"exited with code {procs[r].exitcode} "
                              f"without a report" for r in lost})
            if now > deadline:
                errors.update({r: f"no report within {timeout:.0f} s"
                               for r in range(world) if r not in got})
        for p in procs:
            p.join(max(deadline - time.monotonic(), 5.0) if not errors
                   else 5.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    if errors:
        raise RuntimeError("sharded run failed:\n" + "\n".join(
            f"rank {r}: {msg}" for r, msg in sorted(errors.items())))
    return [got[r] for r in range(world)]


DRYRUN_TASKS = [{"kind": "render", "scene": "cornell", "res": 32,
                 "samples": 1},
                {"kind": "grad", "scene": "cornell", "res": 32,
                 "samples": 1}]


def _max_rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def dryrun_multichip(n_devices: int, device="cuda", backend=None,
                     init_method: str | None = None) -> str:
    """The sharded forward step and the sharded loss and gradients on
    ``n_devices`` spawned ranks, checked against one process; returns
    (and prints) one line.  On one card, more than one rank needs
    ``backend="gloo"``: NCCL refuses two ranks on one device."""
    dev = resolve_device(device)
    ranks = run_ranks(DRYRUN_TASKS, n_devices, dev, backend, init_method)
    alone = run_tasks(pm.make_mesh(device=dev), DRYRUN_TASKS)
    image = ranks[0][0]["passes"]
    if any(r[0]["passes"] is not None for r in ranks[1:]):
        raise AssertionError("an image was gathered off rank 0")
    if not np.isfinite(image).all() or not image[0, :, :3].max() > 0.0:
        raise AssertionError("the sharded image is not finite and lit")
    if not np.array_equal(image, alone[0]["passes"]):
        raise AssertionError("the sharded image differs from one process's")
    loss = ranks[0][1]["loss"]
    g = ranks[0][1]["grads"]["materials"]["albedo"]
    want = alone[1]["grads"]["materials"]["albedo"]
    if not (np.isfinite(loss) and np.isfinite(g).all()):
        raise AssertionError("the sharded loss or gradients are not finite")
    for r in ranks[1:]:
        if r[1]["loss"] != loss or not np.array_equal(
                r[1]["grads"]["materials"]["albedo"], g):
            raise AssertionError("the ranks' all-reduced gradients differ")
    if not (np.isclose(loss, alone[1]["loss"], rtol=1e-5, atol=0.0)
            and np.allclose(g, want, rtol=1e-5,
                            atol=1e-5 * np.abs(want).max())):
        raise AssertionError("the sharded loss or gradients differ from one "
                             "process's beyond rtol 1e-5")
    line = (f"dryrun_multichip({n_devices}, {dev.type}): image "
            f"bit-equal to one process (max {image[0, :, :3].max():.4f}), "
            f"loss={loss:.6f} (one process {alone[1]['loss']:.6f}), "
            f"|dL/dalbedo|={np.abs(g).sum():.6f} (max rel diff "
            f"{_max_rel(g, want):.3g}) OK")
    print(line)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None,
                    help="default: nccl on cuda, gloo on cpu")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device, args.backend)


if __name__ == "__main__":
    main()
