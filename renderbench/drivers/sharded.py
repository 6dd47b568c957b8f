"""The sharded driver: an artist's progressive render over the cards of
one host, the image's pixel rows split over the ranks, one rank a card.

The port renders on a pixel mesh through its normal entry,
``Renderer(config, ir, mesh=mesh)``: each rank holds its slice of the
image and replays the sample captured at its slice's pixel offset, and
the readback gathers the image to rank 0.  Rank 0 is the harness's own
process, on its device (``cuda:0``), with the IR the harness built;
ranks 1 to ``ranks - 1`` are child processes started here, on ``cuda:1``
and up (gloo ranks on the CPU in the harness's own tests), each making
the same raw scene from the configuration and the seed and having the
port build it.  They join one process group (NCCL on cards) through a
store that rank 0 holds, on a free localhost port.

- Set-up: on every rank ``warmup_samples`` samples (the eager sample,
  the capture, a replay), each followed by the completion mark below,
  and one readback.
- Window: every rank calls ``Renderer.step(1)`` back to back, with at
  most ``in_flight`` samples queued on its card, and after each sample
  queues a 4-byte all-reduce on its stream: a rank's all-reduce
  completes only when every rank's sample has, so the event rank 0
  records after it marks the whole image's sample (the harness's mark,
  not the program's).  Every ``gather_every`` samples every rank calls
  ``Renderer.read_image``, which gathers the image to rank 0: the
  viewer's refresh.  Rank 0 closes the window at the first completion it
  sees after ``seconds``: it writes the window's sample count into the
  store, ``in_flight`` samples beyond that completion, a count no rank
  has passed, since no rank runs more than ``in_flight`` samples ahead
  of the marks; every rank stops there.
- ``spp_per_s`` and ``sample_p95_ms`` as ``progressive.py`` defines
  them, on rank 0's marks.
- After the window rank 0 hands the other ranks their work through the
  store, one command at a time: a readback (``outputs``), a traced unit
  (one whole-image sample on every rank, traced on rank 0), the end
  (``release``).  With the port's tracing on (``renderbench/program.py``)
  every rank also reports its spans where rank 0 does, after the set-up
  and after the window: on a mesh that report is a collective.

Failing fast: before it starts anything, ``setup`` checks that the
port's ``Renderer`` takes a mesh, and raises at once if not.  Every wait
of rank 0 has a deadline of the port's collective timeout and ends early
when a rank has exited; a rank left without work that long, or whose
parent has gone, leaves.  When rank 0 fails, or exits, every child is
ended.

What is compared with the reference: every pass and the sample count of
``check_pixels`` pixels drawn from the seed, read from the gathered
image after all the samples the ranks ran (``check.progressive``; the
semantics are per global pixel, so the one-card reference is this
deployment's reference too).
"""

from __future__ import annotations

import datetime
import inspect
import multiprocessing as mp
import os
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import check
from ..clock import Mark, sync

HOST = "127.0.0.1"
TOTAL = "renderbench/total"
# How long the end of the run waits for a rank to leave.
JOIN_S = 30.0


def _timeout() -> float:
    """The port's collective timeout (``parallel/distributed.py``)."""
    from elevenrender_tpu_torch.parallel.distributed import \
        COLLECTIVE_TIMEOUT_S
    return float(COLLECTIVE_TIMEOUT_S)


def takes_mesh() -> bool:
    from elevenrender_tpu_torch.render.renderer import Renderer
    return "mesh" in inspect.signature(Renderer).parameters


class _Rank:
    """One rank's renderer and its part of the run's protocol."""

    def __init__(self, renderer, mesh, store, mix, others=()):
        self.renderer = renderer
        self.mesh = mesh
        self.store = store
        self.mix = mix
        self.others = list(others)  # rank 0: the child processes
        self.cuda = mesh.device.type == "cuda"
        self.flag = torch.zeros(1, dtype=torch.int32, device=mesh.device)
        self.samples = 0
        self.timeout = _timeout()

    def mark(self) -> Mark:
        """The completion mark after the work queued so far: a 4-byte
        all-reduce, then an event."""
        dist.all_reduce(self.flag, op=dist.ReduceOp.MAX,
                        group=self.mesh.group)
        return Mark(self.mesh.device).record()

    def wait(self, mark: Mark) -> None:
        """Wait for ``mark``, at most the collective timeout, and no
        longer than a child rank lives."""
        if not self.cuda:
            return
        deadline = time.monotonic() + self.timeout
        while not mark.event.query():
            self.check_others()
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {self.mesh.rank}: a sample not "
                                   f"done within {self.timeout:.0f} s")
            time.sleep(1e-4)

    def check_others(self) -> None:
        for r, p in enumerate(self.others, 1):
            if p.exitcode is not None:
                raise RuntimeError(f"rank {r} exited with code {p.exitcode}")

    def sample(self) -> Mark:
        self.renderer.step(1)
        self.samples += 1
        return self.mark()

    def read(self):
        return self.renderer.read_image()

    def warm_up(self) -> None:
        for _ in range(self.mix["warmup_samples"]):
            done = self.sample()
        self.read()
        self.wait(done)
        self.wait(self.mark())

    def run_window(self, seconds: float | None) -> tuple:
        """(the window's marks, after a first mark that lines the ranks
        up; its host-clock start): rank 0 passes ``seconds`` and closes the window, the others
        pass None and follow (the module docstring)."""
        depth, every = self.mix["in_flight"], self.mix["gather_every"]
        self.wait(self.mark())
        t0 = time.perf_counter()
        start = Mark(self.mesh.device).record()
        done, total = [], None
        while total is None or len(done) < total:
            i = len(done)
            if i >= depth:
                self.wait(done[i - depth])
                if total is None:
                    if seconds is None:
                        if self.store.check([TOTAL]):
                            total = int(self.store.get(TOTAL))
                            continue
                    elif time.perf_counter() - t0 >= seconds:
                        total = i + depth
                        self.store.set(TOTAL, str(total))
            done.append(self.sample())
            if (i + 1) % every == 0:
                self.read()
        self.wait(done[-1])
        sync(self.mesh.device)
        return [start] + done, t0


# -- rank 0 -------------------------------------------------------------

def _end(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join(5.0)


def _leave_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def setup(run) -> dict:
    if not takes_mesh():
        raise RuntimeError("the port's Renderer takes no mesh: this port "
                           "cannot render on a pixel mesh")

    from elevenrender_tpu_torch.core import spans
    from elevenrender_tpu_torch.parallel.mesh import make_mesh
    from elevenrender_tpu_torch.render.renderer import Renderer

    ranks = int(run["cfg"]["ranks"])
    dev = run["device"]
    if dev.type == "cuda" and torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks need {ranks} cards; found "
                           f"{torch.cuda.device_count()}")
    timeout = datetime.timedelta(seconds=_timeout())
    store = dist.TCPStore(HOST, 0, ranks, True, timeout,
                          wait_for_workers=False)
    common = {"seed": run["seed"], "cfg": run["cfg"], "mix": run["mix"],
              "device": dev.type, "trace": spans.enabled(),
              "port": store.port, "ranks": ranks, "parent": os.getpid()}
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(r, common), daemon=True)
             for r in range(1, ranks)]
    for p in procs:
        p.start()
    try:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=0, world_size=ranks,
                                timeout=timeout)
        mesh = make_mesh(device=dev)
        rank = _Rank(Renderer(run["config"], run["ir"], mesh=mesh), mesh,
                     store, run["mix"], procs)
        rank.warm_up()
    except BaseException:
        _end(procs)
        raise
    return {"rank": rank, "procs": procs, "store": store, "commands": 0}


def _command(st, cmd: str) -> None:
    st["rank"].check_others()
    st["store"].set(f"renderbench/cmd/{st['commands']}", cmd)
    st["commands"] += 1


def window(st, run, seconds: float) -> dict:
    rank = st["rank"]
    try:
        marks, t0 = rank.run_window(seconds)
    except BaseException:
        _end(st["procs"])
        raise
    elapsed = time.perf_counter() - t0
    n = len(marks) - 1
    gaps = [a.elapsed_ms(b) for a, b in zip(marks, marks[1:])]
    return {"attempted": n, "failed": 0,
            "metrics": {"spp_per_s": n / elapsed,
                        "sample_p95_ms": float(np.percentile(gaps, 95))},
            "notes": {"samples": n, "window_s": elapsed,
                      "sample_p50_ms": float(np.percentile(gaps, 50)),
                      "ranks": rank.mesh.world}}


def outputs(st, run) -> dict:
    _command(st, "read")
    image = st["rank"].read()
    pix = check.pixels(run)
    idx = pix.to(image["passes"].device)
    return {"pix": pix, "n_samples": st["rank"].samples,
            "passes": image["passes"][:, idx, :3].cpu(),
            "samples": image["samples"][idx].cpu()}


def unit(st, run):
    """One traced unit: one whole-image sample, every rank's."""
    def one():
        _command(st, "unit")
        st["rank"].sample()
    return one, 1


def release(st) -> None:
    procs = st.get("procs", [])
    try:
        if st.get("store") is not None:
            st["store"].set(f"renderbench/cmd/{st['commands']}", "release")
        for p in procs:
            p.join(JOIN_S)
    finally:
        _end(procs)
        _leave_group()
        st.clear()


def judge(run, out) -> tuple:
    return check.progressive(run, out)


# -- ranks 1 and up ---------------------------------------------------------

def _watch_parent(parent: int) -> None:
    """End this process when the harness's process is gone."""
    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(0.5)
    threading.Thread(target=watch, daemon=True).start()


def _commands(rank: _Rank) -> None:
    """Run rank 0's commands until ``release``; leave after the
    collective timeout without one."""
    n = 0
    while True:
        key = f"renderbench/cmd/{n}"
        try:
            rank.store.wait([key], datetime.timedelta(seconds=rank.timeout))
        except RuntimeError:
            return  # no command within the timeout: the run has moved on
        cmd = rank.store.get(key).decode()
        n += 1
        if cmd == "release":
            return
        if cmd == "read":
            rank.read()
        elif cmd == "unit":
            rank.wait(rank.sample())
        else:
            raise ValueError(f"unknown command {cmd!r}")


def _child(r: int, common: dict) -> None:
    """Rank ``r``: join, build, warm up, follow the window and the
    commands."""
    _watch_parent(common["parent"])
    try:
        from elevenrender_tpu_torch.core import spans
        from elevenrender_tpu_torch.parallel.mesh import make_mesh
        from elevenrender_tpu_torch.render.renderer import Renderer

        from .. import port, scene

        ranks = common["ranks"]
        if common["device"] == "cuda":
            dev = torch.device("cuda", r)
            torch.cuda.set_device(dev)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(min(torch.get_num_threads(), max(
                1, (os.cpu_count() or ranks) // ranks)))
        if common["trace"]:
            spans.enable(True)
        timeout = datetime.timedelta(seconds=_timeout())
        store = dist.TCPStore(HOST, common["port"], ranks, False, timeout)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=store, rank=r, world_size=ranks,
                                timeout=timeout)
        mesh = make_mesh(device=dev)
        config, ir = port.build(scene.make(common["cfg"], common["seed"]),
                                dev)
        rank = _Rank(Renderer(config, ir, mesh=mesh), mesh, store,
                     common["mix"])
        rank.warm_up()
        if common["trace"]:
            spans.report()
            spans.reset()
        rank.run_window(None)
        if common["trace"]:
            spans.report()
        _commands(rank)
        _leave_group()
    except Exception:
        # Out at once: a rank whose peers are gone may hang in its
        # collectives' teardown.
        traceback.print_exc()
        os._exit(1)
