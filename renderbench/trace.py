"""The traced run: one unit of work in a profiling session of its own,
and what the device trace says of it.

A unit is what the cell's driver names (one progressive sample, or one
optimiser step).  Each session profiles one unit in the run's own
process, after the timed window; a session over several graph replays
can lose device records, so the harness takes ``SESSIONS`` sessions and
keeps the one that saw the most device events.

Frozen copies, as of the benchmark's first version, of
``elevenrender_tpu_torch/profile_step.py``: ``busy_union_us`` (its
``busy_union_ms``: the union of the device events' intervals, so that
overlapping kernels count once) and ``group`` (its ``_group``: the
kernel families by name).
"""

from __future__ import annotations

import time

import torch

from .clock import sync

SESSIONS = 3
TOP = 10


def group(name: str) -> str:
    n = name.lower()
    if "bvh_traverse" in n:
        return "traversal"
    if "sort" in n or "radix" in n:
        return "sort"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather"
    if "reduce" in n:
        return "reductions"
    return "elementwise and other"


def busy_union_us(spans) -> float:
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def _session(unit, device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        unit()
        sync(device)
        wall = time.perf_counter() - t0
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.name, e.time_range.start, e.time_range.end) for e in events
           if e.device_type == cuda and e.time_range.end > e.time_range.start]
    host = [(e.name, e.time_range.start, e.time_range.end, e.thread)
            for e in events if e.device_type != cuda]
    return {"wall_s": wall, "device": dev, "host": host}


def profile_units(unit, device) -> dict:
    """``SESSIONS`` sessions of ``unit()``; the fullest one."""
    best = None
    for _ in range(SESSIONS):
        got = _session(unit, device)
        if best is None or len(got["device"]) > len(best["device"]):
            best = got
    return best


def summary(session: dict) -> dict:
    """Device busy seconds, the traced window, launches, device seconds
    by kernel family and by kernel, and the breakdown: the top device
    operations and the longest idle gaps, each gap named by the host op
    that was running when it opened.  The traced window (``window_s``)
    is the unit's span on the device, from its first operation's start
    to its last one's end: the session's edges (the host's call before
    the first launch, the synchronisation after the last) are not the
    unit's, and in the timed window the next queued unit hides them.
    ``wall_s`` is the session's host-clock time around the unit."""
    dev = session["device"]
    by_name, by_group = {}, {}
    for name, lo, hi in dev:
        by_name[name] = by_name.get(name, 0.0) + (hi - lo) / 1e6
        g = group(name)
        by_group[g] = by_group.get(g, 0.0) + (hi - lo) / 1e6
    spans = sorted((lo, hi) for _, lo, hi in dev)
    busy = busy_union_us(spans) / 1e6
    gaps = []
    if spans:
        # Idle gaps inside the device's own span of the session.
        end = spans[0][1]
        for lo, hi in spans[1:]:
            if lo > end:
                gaps.append((end, lo))
            end = max(end, hi)
    named = []
    host = session["host"]
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        cover = [h for h in host if h[1] <= lo < h[2]]
        name = max(cover, key=lambda h: h[1])[0] if cover else "(none)"
        named.append([name, (hi - lo) / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    span = (max(hi for _, hi in spans) - spans[0][0]) / 1e6 if spans else 0.0
    return {"busy_s": busy, "window_s": span, "wall_s": session["wall_s"],
            "launches": len(dev), "by_group": by_group,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": named}}
