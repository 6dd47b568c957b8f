"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default.  Without a card
that raises: the port never moves to the CPU on its own.  The CPU is
used only when the caller passes ``device="cpu"`` (as the tests do).

Also the port's CUDA graph policy, ``CapturedCall``, which the compiled
sample and the denoiser share.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the port's plain PyTorch path")
    return dev


_constants: dict = {}


def constant(values: tuple, device) -> torch.Tensor:
    """The float32 vector ``values`` on ``device``, uploaded on first use
    and shared read-only after (never written, never freed).  A constant
    that a render sample built per call would be a host-to-device copy
    each time, which a card completes with a stream sync, and which a
    CUDA graph cannot capture."""
    key = (tuple(values), torch.device(device))
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = torch.tensor(values, dtype=torch.float32,
                                           device=key[1])
    return t


_capture_lock = threading.Lock()
_capture_streams: dict = {}


class CapturedCall:
    """A function of static buffers, captured once as a CUDA graph on a
    card and replayed: the one capture policy of the compiled sample
    (``render/dispatch.py``) and the denoiser (``render/denoise.py``).

    ``static`` holds the buffers: clones of the first inputs, and later
    inputs are copied into them (``load``).  ``warm_up(fn)`` runs
    ``fn(static)`` eagerly, which builds and loads the kernel libraries,
    makes the one-time checks that synchronise and uploads the shared
    constants; ``capture(fn)`` then records ``fn(static)`` into
    ``graph`` (with its private memory pool), its output into ``out``;
    ``replay()`` runs it again.  A capture or a
    replay that fails raises.  On the CPU there is no graph: the caller
    runs ``fn(static)`` itself.

    Callers take a ``turn()``: one at a time, and on a card each turn's
    work on the stream it enqueues to waits for the last turn's, so the
    buffers are never written by two streams at once.  When the object is
    dropped its last turn is waited for, then the graph and its pool go
    with it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.static: dict | None = None
        self.graph = self.out = None
        self.warmup_s = self.capture_s = None
        self._lock = threading.Lock()
        self._done = None

    @contextlib.contextmanager
    def turn(self):
        with self._lock:
            if not self.cuda:
                yield
                return
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            yield
            for t in self.static.values():
                t.record_stream(stream)
            self._done = torch.cuda.Event()
            self._done.record(stream)

    def __del__(self):
        if self._done is not None:
            self._done.synchronize()

    def load(self, inputs: dict) -> None:
        if self.static is None:
            self.static = {k: v.clone() for k, v in inputs.items()}
            return
        if inputs.keys() != self.static.keys():
            raise ValueError(f"inputs {sorted(inputs)}, static buffers "
                             f"{sorted(self.static)}")
        for k, v in inputs.items():
            if v is not self.static[k]:
                self.static[k].copy_(v)

    def warm_up(self, fn):
        """``fn(static)`` eagerly, timed to its end; returns its output."""
        t0 = time.perf_counter()
        out = fn(self.static)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0
        return out

    def capture(self, fn) -> None:
        """One capture in the process at a time, on a high-priority
        stream kept for captures (the render and readback streams come
        from the default-priority pool, so no other thread's work lands
        on it), with ``capture_error_mode="thread_local"`` (a thread that
        reads back meanwhile does not abort it)."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with _capture_lock:
            stream = _capture_streams.get(self.device)
            if stream is None:
                stream = _capture_streams[self.device] = torch.cuda.Stream(
                    self.device, priority=-1)
            with torch.cuda.device(self.device), torch.cuda.graph(
                    graph, stream=stream, capture_error_mode="thread_local"):
                out = fn(self.static)
        self.capture_s = time.perf_counter() - t0
        self.graph, self.out = graph, out

    def replay(self):
        self.graph.replay()
        return self.out
