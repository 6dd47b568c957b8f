"""Device selection for the port's entry points.

Every entry point takes ``device="cuda"`` by default.  Without a card
that raises: the port never moves to the CPU on its own.  The CPU is
used only when the caller passes ``device="cpu"`` (as the tests do).

Also the port's CUDA graph policy, ``CapturedCall``, which the compiled
sample, the gradient chunks and the denoiser share.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from . import spans


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


def _capture_stream(device: torch.device):
    """The high-priority stream kept for warm-ups and captures on
    ``device``; the caller holds ``_capture_lock``."""
    stream = _capture_streams.get(device)
    if stream is None:
        stream = _capture_streams[device] = torch.cuda.Stream(device,
                                                              priority=-1)
    return stream


class CapturedCall:
    """A function of static buffers, captured once as a CUDA graph on a
    card and replayed: the one capture policy of the compiled sample and
    the gradient chunks (``render/dispatch.py``, ``render/grad.py``) and
    of the denoiser (``render/denoise.py``).

    ``static`` holds the buffers: clones of the first inputs, and later
    inputs are copied into them (``load``).  ``warm_up(fn)`` runs
    ``fn(static)`` eagerly, which builds and loads the kernel libraries,
    makes the one-time checks that synchronise, uploads the shared
    constants and, where ``fn`` runs ``torch.autograd.grad``, starts the
    autograd engine's device thread with its cuBLAS handle; ``capture(fn)``
    then records ``fn(static)`` into ``graph`` (with its private memory
    pool), its output into ``out``; ``replay()`` runs it again.  A
    captured backward pass reads its parameters as static leaf tensors
    that require grad (the caller copies new values into them before a
    replay) and writes its gradients into static buffers; which
    gradients are ``None`` is decided once, at the capture.  A capture or
    a replay that fails raises.  On the CPU there is no graph: the caller
    runs ``fn(static)`` itself.

    ``CapturedCall.captures`` counts the captures made in the process
    (an inverse-rendering loop checks with it that its steps replay).

    ``kind`` names the call in its spans (``core/spans.py``):
    ``capture.warmup.<kind>`` and ``capture.record.<kind>`` time the
    warm-up and the capture on the host, and each capture counts one
    ``capture``.  The host counters that the capture's wrappers count
    (the traversal's launches, the integrator's lanes) are taken out of
    the counters (``spans.deferred``) into ``counts``, and every replay
    (span ``replay``) adds them back.

    Callers take a ``turn()``: one at a time, and on a card each turn's
    work on the stream it enqueues to waits for the last turn's, so the
    buffers are never written by two streams at once.  When the object is
    dropped its last turn is waited for, then the graph and its pool go
    with it."""

    captures = 0

    def __init__(self, device: torch.device, kind: str):
        self.device = device
        self.cuda = device.type == "cuda"
        self.kind = kind
        self.static: dict | None = None
        self.graph = self.out = self.counts = None
        self._span_stack = None
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
        """``fn(static)`` eagerly, to its end; returns its output.
        It runs as PyTorch's recipe for capturing a backward pass runs
        its warm-up (``torch.cuda.make_graphed_callables``): on a side
        stream, between two device synchronisations.  The side stream is
        the capture stream, so the warm-up holds the capture lock: another
        thread's capture on that stream would record it otherwise.  Its
        intermediates go back to the allocator's cache of that stream,
        which only warm-ups, each after a device synchronisation, draw
        from: a capture allocates from its graph's own pool."""
        with spans.span(f"capture.warmup.{self.kind}"), _capture_lock:
            torch.cuda.synchronize(self.device)
            with torch.cuda.device(self.device), torch.cuda.stream(
                    _capture_stream(self.device)):
                out = fn(self.static)
            torch.cuda.synchronize(self.device)
        return out

    def capture(self, fn) -> None:
        """One capture in the process at a time, on a high-priority
        stream kept for captures (the render and readback streams come
        from the default-priority pool, so no other thread's work lands
        on it), with ``capture_error_mode="thread_local"`` (a thread that
        reads back meanwhile does not abort it).  A backward pass in
        ``fn`` runs on the autograd engine's device thread, on the stream
        of the forward op each node came from, which is the capture
        stream: its kernels are recorded and its memory drawn from the
        graph's pool."""
        graph = torch.cuda.CUDAGraph()
        with spans.span(f"capture.record.{self.kind}"), _capture_lock:
            stream = _capture_stream(self.device)
            with spans.deferred() as counts, spans.capturing(
                    self.device, stream) as stack:
                with torch.cuda.device(self.device), torch.cuda.graph(
                        graph, stream=stream,
                        capture_error_mode="thread_local"):
                    out = fn(self.static)
            CapturedCall.captures += 1
            spans.count("capture")
        self.graph, self.out, self.counts = graph, out, counts
        self._span_stack = stack

    def replay(self):
        with spans.span("replay"):
            self.graph.replay()
        spans.add(self.counts)
        return self.out
