"""Render lifecycle: progressive loop, pass and progress readback, saving.

Port of ``elevenrender_tpu/render/renderer.py``.  The reference launches a
render thread that submits one kernel per sample and reads passes and
progress through a second SYCL queue while it renders.  Here:

- Samples go through the compiled dispatch (``render/dispatch.py``): on
  a card one progressive sample is captured once as a CUDA graph (after
  one eager warm-up sample) and every later sample is a replay of it.
- ``step(n)`` renders n samples synchronously on the caller's stream.
- ``start`` renders in a background thread, in chunks of samples.  On a
  card the thread runs on a CUDA stream of its own, which first waits
  for the caller's stream (where the IR and the first state were
  uploaded); a replay launches on the current stream, so the graph
  follows it.  After each chunk the thread records an event, waits for
  it and publishes (state, event) as the snapshot, under a lock.
- Readback (``get_pass``, ``get_render_info``, checkpoints) takes the
  snapshot and reads it on a readback stream that waits for that
  snapshot's event only, never for the chunk that is running; the copy
  to the host is synchronous.  The graph advances its own state buffers
  in place, so the renderer takes the ``_safe`` form: each step or chunk
  ends with a device copy of them, which no later replay writes, and
  that copy is the snapshot.  It stays valid while the next chunk runs.
- A chunk that raises ends the thread: the error is logged and kept in
  ``error``, and the snapshot, so the progress, stays where it was.

On the CPU the thread runs the same torch ops, with no streams and no
graph.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading

import numpy as np
import torch

from ..convert import ir_to
from ..core import child
from ..core.device import resolve_device
from ..utils.logging import get_logger
from . import denoise as denoise_mod
from .dispatch import render_samples_jit_safe
from .integrator import (BEAUTY, BITANGENT, DENOISE, NORMAL, TANGENT,
                         init_state, recommended_samples_per_dispatch)

log = get_logger()

_PASS_NAMES = {"beauty": BEAUTY, "denoise": DENOISE, "normal": NORMAL,
               "tangent": TANGENT, "bitangent": BITANGENT}


# The Chrome trace categories of device work, and the sessions
# ``Renderer.profile`` may take for one sample.
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
PROFILE_TRIES = 4


def parse_pass(name: str) -> int:
    """Case-insensitive pass name; unknown names mean beauty."""
    return _PASS_NAMES.get(name.lower(), BEAUTY)


def find_device(name: str) -> torch.device:
    """The device a config's ``device`` string names: "" means cuda:0;
    "cuda", "cuda:N" and "cpu" mean what they say.  Any other name, or
    a card index that does not exist, logs a warning and means cuda:0,
    never the CPU."""
    if not name:
        return torch.device("cuda", 0)
    try:
        dev = torch.device(name)
    except RuntimeError:
        dev = None
    if dev is not None and dev.type == "cpu":
        return dev
    if dev is not None and dev.type == "cuda" and (
            dev.index is None or dev.index < torch.cuda.device_count()):
        return dev
    log.warning("Device %r not found; using cuda:0", name)
    return torch.device("cuda", 0)


def checkpoint_state(data, config, device) -> dict:
    """The accumulation state on ``device`` from a checkpoint's arrays
    (``passes``, ``samples``, ``rng`` and, where the config counts rays,
    ``ray_count``, 0 if the file has none), as this package and the JAX
    package write them."""
    state = {
        "passes": torch.tensor(np.asarray(data["passes"], np.float32),
                               device=device),
        "samples": torch.tensor(np.asarray(data["samples"], np.int64),
                                device=device),
        "rng": torch.tensor(np.asarray(data["rng"], np.int64),
                            device=device),
    }
    if config.count_rays:
        state["ray_count"] = (
            torch.tensor(np.asarray(data["ray_count"], np.float32),
                         device=device) if "ray_count" in data
            else torch.zeros((), device=device))
    return state


class Renderer:
    """Progressive path tracer over a built scene IR.  ``device`` None
    means ``find_device(config.device)``."""

    def __init__(self, config, ir, device=None):
        if device is None:
            device = find_device(config.device)
        self.device = resolve_device(device)
        self.config = config
        self._cuda = self.device.type == "cuda"
        self.ir = ir_to(ir, self.device)
        self.state = init_state(config, self.device)
        # The render thread's stream and the readback stream (card only).
        self._stream = self._readback = None
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._readback = torch.cuda.Stream(self.device)
        self._lock = threading.Lock()
        self._snapshot = (self.state, self._record())
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.error: BaseException | None = None

    def _record(self, stream=None):
        """An event at the end of the work enqueued so far on ``stream``
        (the current stream if None); None on the CPU."""
        if not self._cuda:
            return None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device)
                     if stream is None else stream)
        return event

    def _publish(self, state, event) -> None:
        with self._lock:
            self._snapshot = (state, event)

    # -- stepping ---------------------------------------------------------
    def _render(self, n: int) -> None:
        """n samples by replay of the captured sample, into a new state
        (the ``_safe`` form: the snapshot guarantee).  No autograd graph
        is built, even if a scene tensor requires grad: the accumulators
        would otherwise hold the graph of every sample (gradients are
        ``render/grad.py``'s entry points)."""
        self.state = render_samples_jit_safe(self.config, self.ir,
                                             self.state, n,
                                             device=self.device)

    def step(self, n: int = 1) -> None:
        """Run n progressive samples synchronously."""
        if self._cuda:
            # After a background render: its stream's state, read here.
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self._stream)
            for t in self.state.values():
                t.record_stream(current)
        self._render(n)
        self._publish(self.state, self._record())

    def start(self, sample_target: int | None = None,
              samples_per_dispatch: int | None = None) -> None:
        """Render ``sample_target`` (default ``config.sample_target``)
        more samples in a background thread, in chunks of
        ``samples_per_dispatch`` (default ``min(config.block_size,
        recommended_samples_per_dispatch)``), with a snapshot after each
        chunk.  A render already running stops at its next chunk
        boundary first."""
        target = sample_target or self.config.sample_target
        if samples_per_dispatch is None:
            samples_per_dispatch = min(
                max(1, int(self.config.block_size)),
                recommended_samples_per_dispatch(self.config, self.ir))
        chunk = max(1, min(samples_per_dispatch, target))
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            self._thread.join()
        self._stop.clear()
        self.error = None
        if self._cuda:
            # The thread's stream waits for what the caller's stream
            # enqueued (the IR and state uploads, synchronous steps), and
            # the allocator may not hand those tensors' memory to the
            # caller's stream while the render stream can still read it.
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            for leaves in (*self.ir.values(), self.state):
                for t in leaves.values():
                    t.record_stream(self._stream)

        def run():
            log.info("Rendering %dx%d at %d samples (%d per chunk) on %s",
                     self.config.x_res, self.config.y_res, target, chunk,
                     self.device)
            try:
                with torch.cuda.stream(self._stream):
                    done = 0
                    while done < target and not self._stop.is_set():
                        n = min(chunk, target - done)
                        self._render(n)
                        event = self._record(self._stream)
                        if event is not None:
                            event.synchronize()
                        done += n
                        self._publish(self.state, event)
            except Exception as e:  # noqa: BLE001 -- a thread's boundary
                self.error = e
                log.error("Render thread failed: %s", e, exc_info=True)
                return
            log.info("Render thread finished")

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self) -> None:
        if self._thread is not None:
            self._thread.join()

    # -- readback ---------------------------------------------------------
    @contextlib.contextmanager
    def _snapshot_view(self):
        """The published snapshot's state, with the current stream (on a
        card) the readback stream, waiting for the snapshot's event."""
        with self._lock:
            state, event = self._snapshot
        if not self._cuda:
            yield state
            return
        with torch.cuda.stream(self._readback):
            self._readback.wait_event(event)
            for t in state.values():
                t.record_stream(self._readback)
            yield state

    def get_pass(self, name: str, apply_denoise: bool | None = None
                 ) -> np.ndarray:
        """One pass of the snapshot as float32 [H*W*4] (RGBA per pixel)
        on the host.

        "denoise" is the beauty pass through the denoiser, guided by the
        normal pass and the first-hit albedo (which the DENOISE slot
        accumulates); the reference returns its never-written buffer
        there.  ``apply_denoise`` (default ``config.denoise``) sends any
        other pass through the colour-only denoiser, alpha set to 1."""
        pid = parse_pass(name)
        w, h = self.config.x_res, self.config.y_res
        if apply_denoise is None:
            apply_denoise = self.config.denoise
        with self._snapshot_view() as snap:
            passes = snap["passes"]
            if pid == DENOISE:
                out = denoise_mod.denoise(
                    w, h, passes[BEAUTY].reshape(-1),
                    passes[NORMAL].reshape(-1), passes[DENOISE].reshape(-1))
                return out.to("cpu").numpy()
            if apply_denoise:
                out = denoise_mod.denoise(w, h, passes[pid].reshape(-1))
                raw = out.to("cpu").numpy()
                raw[3::4] = 1.0  # alpha := 1 (CommandManager.cpp:269-271)
                return raw
            return passes[pid].to("cpu").numpy().astype(
                np.float32).reshape(-1)

    def get_render_info(self) -> dict:
        """Progress as the snapshot's first pixel's sample count."""
        with self._snapshot_view() as snap:
            samples = int(snap["samples"][0])
        if self.config.compat:
            samples -= 1  # compat counts start at 1
        return {"samples": samples}

    # -- checkpoint / resume ----------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """The snapshot's accumulation state (passes, per-pixel sample
        counts, RNG streams) as the JAX package writes it: an ``.npz``
        with ``passes`` float32, ``samples`` and ``rng`` uint32, and
        ``x_res`` / ``y_res``."""
        with self._snapshot_view() as snap:
            host = {k: snap[k].to("cpu").numpy()
                    for k in ("passes", "samples", "rng")}
        np.savez_compressed(
            path, passes=host["passes"].astype(np.float32),
            samples=host["samples"].astype(np.uint32),
            rng=host["rng"].astype(np.uint32),
            x_res=self.config.x_res, y_res=self.config.y_res)
        log.info("Checkpoint saved to %s", path)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint of this package or the JAX package;
        the resolution must be the config's.  The loaded state replaces
        ``state``; the next step copies it into the captured sample's
        buffers, as every step does with its input."""
        data = np.load(path)
        if (int(data["x_res"]) != self.config.x_res
                or int(data["y_res"]) != self.config.y_res):
            raise ValueError("checkpoint resolution mismatch")
        state = checkpoint_state(data, self.config, self.device)
        self.state = state
        self._publish(state, self._record())
        log.info("Checkpoint loaded from %s", path)

    # -- profiling and saving ---------------------------------------------
    def _profiled_sample(self, activities, part: str) -> dict:
        """One synchronous sample in a profiling session of its own,
        exported to ``part``: its Chrome trace."""
        from torch.profiler import profile
        if self._cuda:
            torch.cuda.synchronize(self.device)
        with profile(activities=activities) as prof:
            self.step(1)
            if self._cuda:
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(part)
        with open(part) as f:
            return json.load(f)

    def profile(self, path: str, n_samples: int = 4) -> None:
        """A ``torch.profiler`` trace of n synchronous samples, written
        as ``trace.json`` (Chrome / Perfetto format) into the directory
        ``path``; the renderer is n samples further on after it.

        On a card the samples are traced in a child process
        (``core/child.py``: the session never opens in this process, which
        may hold CUDA graphs), which rebuilds this renderer from CPU copies
        of its IR and state, captures the sample (one unprofiled sample,
        taken back) and traces from this renderer's state; its final
        state becomes this renderer's.

        One sample to a profiling session: on a card a session over
        several graph replays loses device records, and now and then so
        does a session of one.  Every sample replays the same graph, so
        a session that saw fewer device events (kernels, copies, sets)
        than the most seen lost records: its sample is taken back (the
        state before it restored) and traced again, up to
        ``PROFILE_TRIES`` times; a first sample, taken back, sets the
        count to reach.  The sessions' events go into the one file
        (their timestamps share the process's time base; each thread's
        and process's naming records are kept once)."""
        if child.traces_in_child(self.device):
            state = child.call_in_child(
                _profile_in_child, self.config, child.to_cpu(self.ir),
                child.to_cpu(self.state), self.device, path, n_samples)
            self.state = {k: v.to(self.device) for k, v in state.items()}
            self._publish(self.state, self._record())
            return
        self._profile_here(path, n_samples)

    def _profile_here(self, path: str, n_samples: int) -> None:
        """``profile`` in this process."""
        from torch.profiler import ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if self._cuda:
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(path, exist_ok=True)
        trace, named = None, set()
        with tempfile.TemporaryDirectory(dir=path) as tmp:
            def traced(part):
                """(the sample's trace, its device events, the state
                before it)."""
                before = self.state
                got = self._profiled_sample(activities,
                                            os.path.join(tmp, part))
                return got, sum(e.get("cat") in DEVICE_EVENTS
                                for e in got["traceEvents"]), before

            def take_back(before):
                self.state = before
                self._publish(before, self._record())

            most = 0
            if n_samples:
                _, most, before = traced("probe.json")
                take_back(before)
            for i in range(n_samples):
                for attempt in range(PROFILE_TRIES):
                    got, n, before = traced(f"{i}.json")
                    if n >= most or attempt == PROFILE_TRIES - 1:
                        break
                    take_back(before)
                if n < most:
                    log.warning("Profile: sample %d lost device records in "
                                "%d sessions", i, PROFILE_TRIES)
                most = max(most, n)
                events = []
                for e in got.pop("traceEvents"):
                    if e.get("ph") == "M":
                        key = json.dumps(
                            {k: e.get(k) for k in ("name", "pid", "tid",
                                                   "args")}, sort_keys=True)
                        if key in named:
                            continue
                        named.add(key)
                    events.append(e)
                if trace is None:
                    trace = {**got, "traceEvents": []}
                trace["traceEvents"] += events
        if trace is None:
            trace = {"traceEvents": []}
        with open(os.path.join(path, "trace.json"), "w") as f:
            json.dump(trace, f)
        log.info("Profile written to %s", path)

    def save_pass(self, name: str, path: str) -> None:
        """A pass as PNG, gamma 1/2.2 (the reference's save_pass)."""
        from ..utils.image import write_png
        data = self.get_pass(name).reshape(
            self.config.y_res, self.config.x_res, 4)
        img = np.clip(np.abs(data), 0.0, None) ** (1.0 / 2.2)
        write_png(path, np.clip(img, 0.0, 1.0))
        log.info("Saved %s", path)


def _profile_in_child(config, ir, state, device, path: str,
                      n_samples: int) -> dict:
    """``Renderer.profile``'s child side: the renderer rebuilt on
    ``device`` at ``state``, one unprofiled sample (the warm-up and the
    capture) taken back, then the traced samples.  Returns the final
    state on the CPU."""
    renderer = Renderer(config, ir, device)
    start = {k: v.to(renderer.device) for k, v in state.items()}
    renderer.state = start
    renderer.step(1)
    renderer.state = start
    renderer._publish(start, renderer._record())
    renderer._profile_here(path, n_samples)
    return child.to_cpu(renderer.state)
