"""The port's spans and counters: one registry.

A span is a named stretch of the program's work, ``with span(name):``;
a counter is a named count, ``count(name, n)`` for a host int and
``count_device(name, tensor)`` for a 0-d tensor added on the device that
holds it.  ``report()`` returns what was recorded since the last
``reset()``; ``series(name)`` a span's last ``RING`` device durations.

Off (the default; ``enable(True)`` turns it on).  ``span`` checks one
flag and returns one shared null context, ``count_device`` does
nothing: nothing is launched, nothing is captured into a graph, nothing
is recorded.  The one exception: inside a ``torch.profiler`` session a
span is a host range named ``er.<name>`` there too, so a trace names the
program's phases and each idle gap after the span its host was in.  The
range is an ordinary CPU op of the profiler, not a user annotation: a
user annotation would also add a device-side range over the annotated
kernels to the trace, and every reader of device events would count it.

On.  Every span is that host range, and the registry keeps each span's
count and host seconds, on the clock the profiler stamps its host events
with (``time.time_ns``), and the last occurrence's host interval.  A
span given a ``device`` also times the device's work: on a card a
one-thread stamp kernel (``csrc/spans.cu``) runs on the current stream
at the span's entry and at its exit, and reads the card's nanosecond
clock; a stack in device memory keeps the open spans, so nested spans
give inclusive and self time (self: inclusive less the direct
children's inclusive time); per span the device keeps the inclusive
total, the self total, the count and a ring of the last ``RING``
inclusive durations.  Nothing syncs the host: ``report()`` synchronises
each card once.  Inside a CUDA graph's capture the stamps become kernel
nodes, so each replay accumulates; the spans inside a graph keep their
nesting on a stack of the graph's own (``capturing``), eager spans on
one stack per stream.  On the CPU a stamp reads the host clock
(``time.perf_counter_ns``), the work being done when the call returns,
with a stack per thread.

Host counters always count: the traversal's launch counters
(``ops/traverse.py``) are host counters of this registry, and so are
``capture`` (a CUDA graph captured) and ``kernel_build`` (a kernel
library compiled).  A counter's name is a string, or a (group, key)
pair for a family such as the traversal's launches by variant.  A
capture runs the wrappers that count but launches nothing, so
``deferred()`` takes the counts made inside it back out and hands them
to the graph, whose every replay adds them (``add``).  Device counters
count only when tracing is on.

Graph keys include ``enabled()`` (``render/dispatch.py cached``): a
graph captured with the stamps in it is never replayed with tracing off,
nor the reverse.

On a pixel mesh (``join_mesh``, which ``Renderer`` calls with its mesh)
``report()`` is a collective of the mesh's process group, which every
rank calls at the same point, outside the timed work, until the group
is destroyed or a ``Renderer`` without a mesh is built (which calls
``join_mesh(None)``): a report made on one rank alone in that time waits
for the others up to the group's timeout.  An object
all-gather brings each rank's ``sample`` span totals and lane counters
into every rank's report (``ranks``), and the counter ``ranks`` is the
mesh's size.  The readback's gather is span ``gather`` with the
counters ``gathers`` (every rank) and ``gather_bytes`` (the bytes rank 0
received from the other ranks).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import threading
import time

import torch
import torch.distributed as dist

# The device stack's frames and each span's ring (csrc/spans.cu kDepth,
# kRing); the span rows and device counters a device holds.
DEPTH = 32
RING = 4096
MAX_SPANS = 64
MAX_COUNTERS = 16

_enabled = False
_NULL = contextlib.nullcontext()
_profiling = torch.autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast

_lock = threading.Lock()
_counts: dict = {}   # host counters: name -> int
_host: dict = {}     # span -> [count, host ns, last start ns, last end ns]
_rows: dict = {}     # span with device time -> row of the device tables
_counter_rows: dict = {}  # device counter -> row
_tables: dict = {}   # card -> _Table
_capturing: dict = {}  # card -> (the capture stream's handle, its stack)
_local = threading.local()  # the CPU stack of this thread
_mesh = None  # (process group, rank, world) of the pixel mesh joined


class _Table:
    """A card's sums (4 a span row: inclusive ns, self ns, exits, next
    ring slot, then one error count), rings, device counters and eager
    stacks (one per stream, by the stream's handle)."""

    def __init__(self, device):
        self.sums = torch.zeros(MAX_SPANS * 4 + 1, dtype=torch.int64,
                                device=device)
        self.ring = torch.zeros(MAX_SPANS * RING, dtype=torch.int64,
                                device=device)
        self.counters = torch.zeros(MAX_COUNTERS, dtype=torch.float64,
                                    device=device)
        self.errors = self.sums[MAX_SPANS * 4:]
        self.stacks: dict = {}


class _CpuTable:
    """The same records for work on the CPU, on the host."""

    def __init__(self):
        self.sums: dict = {}  # span -> [inclusive ns, self ns, exits]
        self.rings: dict = {}
        self.counters: dict = {}


_cpu = _CpuTable()
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .. import kernels
        lib = kernels.load("spans")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.er_span_enter.argtypes = [p, i, p]
        lib.er_span_exit.argtypes = [p, p, p, p, i, p]
        for fn in (lib.er_span_enter, lib.er_span_exit):
            fn.restype = ctypes.c_int
        lib.er_span_error_string.argtypes = [i]
        lib.er_span_error_string.restype = ctypes.c_char_p
        for fn, want in ((lib.er_span_depth, DEPTH),
                         (lib.er_span_ring, RING)):
            fn.argtypes = []
            fn.restype = ctypes.c_int
            if fn() != want:
                raise RuntimeError(f"csrc/spans.cu {fn.__name__} is {fn()}, "
                                   f"core/spans.py expects {want}")
        _lib = lib
    return _lib


def enable(on: bool = True) -> None:
    """Turn tracing on or off.  Turning it on where a card is present
    builds and loads the stamp library first, so no span times it."""
    global _enabled
    if on and torch.cuda.is_available():
        _library()
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def _row(table: dict, name: str, limit: int) -> int:
    row = table.get(name)
    if row is None:
        with _lock:
            row = table.get(name)
            if row is None:
                if len(table) >= limit:
                    raise RuntimeError(f"more than {limit} names in the "
                                       f"registry's device table: {name!r}")
                row = table[name] = len(table)
    return row


def _table(device: torch.device) -> _Table:
    table = _tables.get(device)
    if table is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the span registry's first device record "
                               "was asked for inside a CUDA graph capture")
        table = _tables[device] = _Table(device)
    return table


def _stack(device: torch.device, stream) -> torch.Tensor:
    """The stack of spans recorded on ``stream``: the graph's own while
    a capture (``capturing``) records that stream, else the stream's."""
    handle = stream.cuda_stream
    cap = _capturing.get(device)
    if cap is not None and cap[0] == handle:
        return cap[1]
    table = _table(device)
    stack = table.stacks.get(handle)
    if stack is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a device span inside a CUDA graph capture "
                               "that core.device.CapturedCall did not make")
        stack = table.stacks[handle] = torch.zeros(
            1 + 3 * DEPTH, dtype=torch.int64, device=device)
    return stack


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + _library().er_span_error_string(rc).decode())


class _Span:
    __slots__ = ("name", "device", "range", "t0", "mark")

    def __init__(self, name: str, device):
        self.name = name
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device

    def __enter__(self):
        self.range = _range("er." + self.name)
        self.range.__enter__()
        dev = self.device
        if dev is not None:
            if dev.type == "cuda":
                row = _row(_rows, self.name, MAX_SPANS)
                stream = torch.cuda.current_stream(dev)
                self.mark = _stack(dev, stream)
                _check(_library().er_span_enter(
                    self.mark.data_ptr(), row, stream.cuda_stream),
                    "er_span_enter")
            else:
                frames = getattr(_local, "frames", None)
                if frames is None:
                    frames = _local.frames = []
                frames.append([self.name, 0, 0])
                self.mark = frames
                frames[-1][1] = time.perf_counter_ns()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        dev = self.device
        if dev is not None:
            if dev.type == "cuda":
                table = _tables[dev]
                _check(_library().er_span_exit(
                    self.mark.data_ptr(), table.sums.data_ptr(),
                    table.ring.data_ptr(), table.errors.data_ptr(),
                    _rows[self.name],
                    torch.cuda.current_stream(dev).cuda_stream),
                    "er_span_exit")
            else:
                _cpu_exit(self.mark, time.perf_counter_ns())
        self.range.__exit__(*exc)
        t1 = time.time_ns()
        with _lock:
            rec = _host.get(self.name)
            if rec is None:
                rec = _host[self.name] = [0, 0, 0, 0]
            rec[0] += 1
            rec[1] += t1 - self.t0
            rec[2], rec[3] = self.t0, t1
        return False


def _cpu_exit(frames: list, t: int) -> None:
    name, t0, children = frames.pop()
    inclusive = t - t0
    with _lock:
        sums = _cpu.sums.get(name)
        if sums is None:
            sums = _cpu.sums[name] = [0, 0, 0]
            _cpu.rings[name] = collections.deque(maxlen=RING)
        sums[0] += inclusive
        sums[1] += inclusive - children
        sums[2] += 1
        _cpu.rings[name].append(inclusive)
    if frames:
        frames[-1][2] += inclusive


def span(name: str, device=None):
    """A context manager around the work of span ``name``.  ``device``:
    the device whose work the span brackets (a card: stamps on its
    current stream; the CPU: the host clock), or None for a span of host
    work alone."""
    if _enabled:
        return _Span(name, device)
    if _profiling():
        return _range("er." + name)
    return _NULL


def count(name, n: int = 1) -> None:
    """Add ``n`` to host counter ``name``; counts whether tracing is on
    or off."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counter(name) -> int:
    """Host counter ``name``'s value."""
    return _counts.get(name, 0)


def group(name: str) -> dict:
    """The host counters (``name``, key) of a family, as {key: value}."""
    with _lock:
        return {k[1]: v for k, v in _counts.items()
                if isinstance(k, tuple) and k[0] == name}


def count_device(name: str, value: torch.Tensor) -> None:
    """Add the 0-d tensor ``value`` to device counter ``name`` on its
    device, launching one add; nothing with tracing off."""
    if not _enabled:
        return
    value = value.detach()
    if value.device.type == "cuda":
        row = _row(_counter_rows, name, MAX_COUNTERS)
        _table(value.device).counters[row].add_(value)
    else:
        with _lock:
            _cpu.counters[name] = _cpu.counters.get(name, 0.0) + float(value)


@contextlib.contextmanager
def deferred():
    """Take the host counts made inside the block back out of the
    counters, and yield them ({name: count}, filled in on exit): the
    counts of one replay of the graph the block captures."""
    with _lock:
        before = dict(_counts)
    taken: dict = {}
    try:
        yield taken
    finally:
        with _lock:
            taken.update({k: v - before.get(k, 0) for k, v in _counts.items()
                          if v != before.get(k, 0)})
            _counts.clear()
            _counts.update(before)


def add(counts: dict | None) -> None:
    """Add a ``deferred`` record to the host counters."""
    if not counts:
        return
    with _lock:
        for k, v in counts.items():
            _counts[k] = _counts.get(k, 0) + v


@contextlib.contextmanager
def capturing(device: torch.device, stream):
    """Around a CUDA graph's capture on ``stream``: the device spans it
    records keep their nesting on a fresh stack of the graph's own, so
    two graphs replayed at once on two streams never share one.  Yields
    that stack, which the graph keeps alive (None with tracing off or
    on the CPU)."""
    if not _enabled or device.type != "cuda":
        yield None
        return
    _table(device)
    stack = torch.zeros(1 + 3 * DEPTH, dtype=torch.int64, device=device)
    _capturing[device] = (stream.cuda_stream, stack)
    try:
        yield stack
    finally:
        _capturing.pop(device, None)


def join_mesh(mesh) -> None:
    """Make ``report()`` a collective over ``mesh``'s process group (the
    module docstring); a mesh without a group, or None, makes it this
    process's own again."""
    global _mesh
    _mesh = (None if mesh is None or mesh.group is None
             else (mesh.group, mesh.rank, mesh.world))


def _key(name) -> str:
    return name if isinstance(name, str) else "/".join(map(str, name))


def report() -> dict:
    """{"spans": {name: {"count", "host_s", "last_ns": [start, end],
    and for a span with device time "device_count", "device_ms"
    (inclusive), "self_ms"}}, "counters": {name: value, group: {key:
    value}}, "errors": device frames not counted (too deep or
    unmatched)}, and on a joined mesh "ranks": each rank's {"rank",
    "sample": {"device_ms", "device_count"}, "lanes", "alive_lanes"}, by
    rank.  Device times are summed over the cards and the CPU.
    Synchronises each card once."""
    out: dict = {}
    with _lock:
        for name, (n, ns, t0, t1) in _host.items():
            out[name] = {"count": n, "host_s": ns / 1e9, "last_ns": [t0, t1]}
        cpu = {k: list(v) for k, v in _cpu.sums.items()}
        counters: dict = {}
        for name, v in _counts.items():
            if isinstance(name, tuple):
                counters.setdefault(name[0], {})[_key(name[1])] = v
            else:
                counters[name] = v
        device_counters = dict(_cpu.counters)
    errors = 0
    device = {}
    for dev, table in list(_tables.items()):
        torch.cuda.synchronize(dev)
        sums = table.sums.cpu().tolist()
        values = table.counters.cpu().tolist()
        errors += sums[-1]
        for name, row in list(_rows.items()):
            inc, slf, n = sums[4 * row:4 * row + 3]
            if n:
                acc = device.setdefault(name, [0, 0, 0])
                acc[0] += inc
                acc[1] += slf
                acc[2] += n
        for name, row in list(_counter_rows.items()):
            if values[row]:
                device_counters[name] = device_counters.get(name, 0.0) \
                    + values[row]
    for name, (inc, slf, n) in cpu.items():
        acc = device.setdefault(name, [0, 0, 0])
        acc[0] += inc
        acc[1] += slf
        acc[2] += n
    for name, (inc, slf, n) in device.items():
        rec = out.setdefault(name, {"count": 0, "host_s": 0.0})
        rec.update(device_count=n, device_ms=inc / 1e6, self_ms=slf / 1e6)
    counters.update(device_counters)
    got = {"spans": out, "counters": counters, "errors": errors}
    if _mesh is not None and dist.is_available() and dist.is_initialized():
        grp, rank, world = _mesh
        sample = out.get("sample", {})
        mine = {"rank": rank,
                "sample": {"device_ms": sample.get("device_ms", 0.0),
                           "device_count": sample.get("device_count", 0)},
                "lanes": counters.get("lanes", 0),
                "alive_lanes": counters.get("alive_lanes", 0.0)}
        every = [None] * world
        dist.all_gather_object(every, mine, group=grp)
        counters["ranks"] = world
        got["ranks"] = every
    return got


def series(name: str) -> list:
    """Span ``name``'s last ``RING`` inclusive device durations in ms,
    oldest first (the first card that has any, else the CPU's)."""
    row = _rows.get(name)
    if row is not None:
        for dev, table in list(_tables.items()):
            torch.cuda.synchronize(dev)
            nxt = int(table.sums[4 * row + 3])
            if not nxt:
                continue
            ring = table.ring[row * RING:(row + 1) * RING].cpu()
            if nxt > RING:
                cut = nxt % RING
                ring = torch.cat([ring[cut:], ring[:cut]])
            else:
                ring = ring[:nxt]
            return [v / 1e6 for v in ring.tolist()]
    with _lock:
        ring = _cpu.rings.get(name)
        return [v / 1e6 for v in ring] if ring else []


def reset(names=None) -> None:
    """Forget what was recorded: everything, or only the host counters
    ``names`` (a group's name resets the whole group).  The cards' sums
    are zeroed after a synchronisation, so no stamp in flight lands
    after the reset."""
    with _lock:
        if names is not None:
            names = set(names)
            for k in [k for k in _counts if k in names or (
                    isinstance(k, tuple) and k[0] in names)]:
                del _counts[k]
            return
        _counts.clear()
        _host.clear()
        _cpu.sums.clear()
        _cpu.rings.clear()
        _cpu.counters.clear()
    for dev, table in list(_tables.items()):
        torch.cuda.synchronize(dev)
        table.sums.zero_()
        table.ring.zero_()
        table.counters.zero_()
        torch.cuda.synchronize(dev)
