"""Compiled dispatch: a progressive sample captured once as a CUDA graph
and replayed.

Port of the JAX package's jitted entry points
(``elevenrender_tpu/render/integrator.py:917-969``).  There one sample is
one compiled program issued with one dispatch.  Here one sample is one
CUDA graph: its ~6,500 kernels (~9,500 with textures and a point light),
the ten traversal launches among them, captured once and replayed with
one launch, so the host no longer issues each kernel and can run ahead
of the card.

A ``SampleGraph`` serves one (config, IR, pixel count, pixel offset,
device).  It holds, through ``CountedCall`` (``core.device.CapturedCall``,
the capture policy it shares with the gradient chunks and the denoiser,
with the launch accounting of a replay):

- ``state``, the static state buffers: the graph reads them and, by a
  copy at its end, writes the next state back into them, so one replay
  advances them by one sample in place;
- the graph and, inside it, its private memory pool (every intermediate
  of the sample, with the IR's and the buffers' addresses baked in);
- ``counts``, the host counts its capture counted (the traversal
  launches, the integrator's lanes: ``core.spans.deferred``), which each
  replay adds to the counters.

Its first run on a card is the warm-up: one eager sample (on the capture
stream, between two device synchronisations), which builds and loads
the kernel libraries, makes every one-time check that synchronises (the
leaf-range check, the occupancy query) and uploads the shared
constants, and then the capture of the next sample from that sample's
result.  The capture (``CapturedCall.capture``) runs one at a
time, on a stream kept for captures, with
``capture_error_mode="thread_local"``, so a thread that reads back while
another captures does not abort the capture.  A capture or a
replay that fails raises; nothing falls back to eager execution.  On the
CPU the same class runs the eager sample into the same buffers.

n samples are n replays of the one-sample graph.  A graph of n unrolled
samples would save n - 1 graph launches of a few microseconds each, and
cost n times the capture time and a pool per n.

The entry points keep the JAX package's names.  ``render_sample_jit``
and ``render_samples_jit`` ("donated") return the static buffers
themselves: the next call for the same key overwrites them, and handing
them back in skips the copy into them.  The ``_safe`` forms return a
device copy, which no later replay writes: the renderer publishes it as
its snapshot while the next chunk runs.  The JAX package's
``_warn_oversized_dispatch`` has no counterpart: it guards a TPU
worker's per-dispatch watchdog, which the H100 does not have, and a
replay here is one sample whatever n.

``SampleGraph(record=True)`` is the gradient path's pass-1 unit
(``render/grad.py _accum_fwd_chunk_record``): its graph also writes the
sample's trace record (hit ids, occlusion bits) into buffers of the
graph, which every replay overwrites, so ``run`` copies each sample's
record out into a stack [n, ...] it allocates per call.

Captures are cached per IR, keyed weakly on its geometry tensor
``ir["tris"]["verts"]`` (as ``ops/traverse.py`` keys its leaf-range
check) and on the identities of all its tensors (``cached``; the
gradient path's graphs and parameter buffers live in the same cache): a
new IR gets a new capture, and when an IR's geometry tensor is dropped
its captures, their pools and the IR's other tensors (which an entry
holds, since its graph reads them) go with it.
"""

from __future__ import annotations

import threading

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core import spans
from ..core.device import CapturedCall, resolve_device
from . import shaders as shader_registry
from .integrator import render_sample


def graph_device(device) -> torch.device:
    """The device a capture is keyed on: a card with its index."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class CountedCall(CapturedCall):
    """A ``CapturedCall`` run one call at a time by ``run(fn)``, whose
    replays keep the host counters as ``CapturedCall`` does.  ``held``:
    tensors to keep alive while the graph may read them."""

    def __init__(self, device: torch.device, held, kind: str):
        super().__init__(device, kind)
        self._held = list(held)

    def run(self, fn):
        """``fn(static)`` once.  On the CPU, ``fn`` itself.  On a card the
        first run is the eager warm-up, then the capture of the next run
        (which executes nothing), so it returns the warm-up's output; every
        later run replays the graph and returns its output buffers."""
        if not self.cuda:
            return fn(self.static)
        if self.graph is None:
            out = self.warm_up(fn)
            self.capture(fn)
            return out
        return self.replay()


class SampleGraph:
    """One progressive sample of ``config`` over the pixels of the state
    it first runs, from ``pixel_offset``, on ``device``, captured as a
    CUDA graph on a card (``CountedCall``: the state is its static
    buffers, and the sample writes its result back into them).  With
    ``record`` the sample also returns its trace record (the module
    docstring).  ``held``: tensors to keep alive while the graph may read
    them."""

    def __init__(self, config, pixel_offset: int = 0, device="cuda",
                 held=(), record: bool = False):
        self.config = config
        self.pixel_offset = pixel_offset
        self.device = graph_device(device)
        self.record = record
        self._call = CountedCall(self.device, held,
                                 "record" if record else "sample")

    @property
    def state(self) -> dict | None:
        return self._call.static

    @property
    def counts(self) -> dict | None:
        return self._call.counts

    def run(self, ir, state: dict, n: int = 1, safe: bool = False):
        """n samples from ``state``.  Returns the static buffers, or with
        ``safe`` a copy of them; with ``record``, (that, the n samples'
        trace records stacked [n, ...]).  Serialised as
        ``CapturedCall.turn`` says.  Host span ``dispatch``: the inputs
        copied in, the replays (span ``replay``) and the copies out."""
        if self.record and n < 1:
            raise ValueError(f"a recording run needs n >= 1, got {n}")
        if n < 1:
            return state
        call = self._call

        def sample(st):
            out = render_sample(self.config, ir, st, self.pixel_offset,
                                record=self.record, device=self.device)
            trace = None
            if self.record:
                out, trace = out
            with spans.span("accumulate", self.device):
                for k, v in out.items():
                    st[k].copy_(v)
            return trace

        with spans.span("dispatch"), call.turn(), torch.no_grad():
            call.load(state)
            stack = None
            for i in range(n):
                trace = call.run(sample)
                if self.record:
                    if stack is None:
                        stack = {k: v.new_empty((n, *v.shape))
                                 for k, v in trace.items()}
                    for k, v in trace.items():
                        stack[k][i].copy_(v)
            out = ({k: v.clone() for k, v in call.static.items()} if safe
                   else dict(call.static))
            return (out, stack) if self.record else out


# Geometry tensor -> {key: entry}, held weakly (module docstring).
_graphs = WeakIdKeyDictionary()
_graphs_lock = threading.Lock()


def ir_leaves(ir: dict) -> list:
    """The IR's tensors in a fixed order: by group, then by name."""
    return [t for grp in sorted(ir) for _, t in sorted(ir[grp].items())]


def cached(ir: dict, key, make):
    """The cache entry ``key`` of ``ir`` (its tensors' identities, the
    shader registry version and whether tracing is on, ``spans.enabled``,
    join the key), made by ``make(held)`` on first use: ``held`` is the
    IR's tensors but the geometry tensor, which the entry keeps alive
    while the IR is."""
    anchor = ir["tris"]["verts"]
    leaves = ir_leaves(ir)
    key = (key, tuple(id(t) for t in leaves),
           shader_registry.registry_version(), spans.enabled())
    with _graphs_lock:
        entries = _graphs.get(anchor)
        if entries is None:
            entries = _graphs[anchor] = {}
        entry = entries.get(key)
        if entry is None:
            entry = entries[key] = make(
                [t for t in leaves if t is not anchor])
    return entry


def sample_graph(config, ir, npix: int, pixel_offset: int = 0,
                 device="cuda", record: bool = False) -> SampleGraph:
    """The cached ``SampleGraph`` of this config, IR (its tensors'
    identities), pixel count and offset, device, shader registry version
    and ``record``; made on first use, captured at its first run."""
    dev = graph_device(device)
    return cached(ir, ("sample", config, npix, pixel_offset, dev, record),
                  lambda held: SampleGraph(config, pixel_offset, dev, held,
                                           record))


def _run(config, ir, state, n, pixel_offset, device, safe):
    graph = sample_graph(config, ir, state["samples"].shape[0], pixel_offset,
                         device)
    return graph.run(ir, state, n, safe=safe)


def render_sample_jit(config, ir, state, pixel_offset: int = 0,
                      device="cuda") -> dict:
    """One sample by replay ("donated"): returns the captured sample's
    state buffers, which the next call for the same key overwrites."""
    return _run(config, ir, state, 1, pixel_offset, device, False)


def render_sample_jit_safe(config, ir, state, pixel_offset: int = 0,
                           device="cuda") -> dict:
    """One sample by replay; returns a copy that no later call writes."""
    return _run(config, ir, state, 1, pixel_offset, device, True)


def render_samples_jit(config, ir, state, n: int, pixel_offset: int = 0,
                       device="cuda") -> dict:
    """n samples, n replays of one captured sample ("donated")."""
    return _run(config, ir, state, n, pixel_offset, device, False)


def render_samples_jit_safe(config, ir, state, n: int,
                            pixel_offset: int = 0, device="cuda") -> dict:
    """n samples by replay; returns a copy that no later call writes."""
    return _run(config, ir, state, n, pixel_offset, device, True)
