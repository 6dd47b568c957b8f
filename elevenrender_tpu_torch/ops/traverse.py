"""BVH traversal: the CUDA kernel's wrapper, its plain version, brute force.

``traverse`` is what the integrator calls.  On a CUDA tensor it launches
the hand-written kernel ``csrc/bvh_traverse.cu`` (the port of the TPU
kernel ``elevenrender_tpu/ops/bvh_pallas.py:_kernel``) or raises; on a
CPU tensor, and only there, it runs ``traverse_plain``, a lockstep
per-ray stack walk in PyTorch with the kernel's visit order, prune,
Möller-Trumbore arithmetic and any-hit rule, so the two give the same
ids and bit-equal t.  ``brute_force`` tests every tri, for tiny scenes.

The kernel runs a persistent grid (``persistent_grid``: the SMs times the
blocks of the variant that fit on one; a probe runs on its full scan's
grid) whose warps take rays from a
zeroed int32 work counter (``work_counter``).  ``traverse_v1`` launches
the kernel's first version, ``csrc/bvh_traverse_v1.cu`` (one thread per
ray, default variant only), which the traversal sweep times it against;
it computes the same function, and on a CPU tensor runs
``traverse_plain`` too.

Both take the TPU kernel's variants: ``order`` ("near": nearer child
first; "sign": the child on the side the ray comes from, by a per-node
code), ``leaf_aabb`` (0; 1 or 2: a box test in front of each aligned
group of 8 or 4 leaf slots, a pure cull), ``leaf_mode`` ("full";
"noscan" and "skip" are timing probes that miss every ray) and
``count_steps`` (a third result, int32 [N, 4] per ray: node visits,
leaf-parent visits, 8-aligned slot groups of the leaf ranges entered,
Möller-Trumbore tests executed).

``frontier=K`` (2..8) selects the frontier-K walk instead, the port of
``elevenrender_tpu/ops/bvh_pallas.py:_kernel_frontier``: the kernel
``csrc/bvh_frontier.cu`` on a CUDA tensor, ``traverse_frontier_plain`` on
a CPU tensor.  It pops up to K stack entries per step and slab-tests all
their children with the best_t of the step's start, then scans leaves and
pushes in pop order; the same tables, the same t bit for bit, ids up to
equal-t ties, closest-hit and any-hit, ``count_steps`` in the same four
columns.  ``order``, ``leaf_aabb`` and ``leaf_mode`` do not apply to it
and are ignored, as the TPU kernel ignores them.  The kernel walks one
ray per tile of ``frontier_tile(K)`` lanes, with the ray's stack in shared
memory (``frontier_shared_bytes`` a block), on a persistent grid
(``tile_grid``) fed by the same kind of work counter.

Kernel tables (``pack_tables``, built by ``build_ir``/``ir_from_numpy``):
  boxes   f32 [NN, 12]: row p = both children of interior node p
          (left bmin, left bmax, right bmin, right bmax), read as 3 float4;
  leaves  i32 [NN, 4]:  row p = (l_from, l_to, r_from, r_to) of leaf
          parent p;
  tris    f32 [T, 12]:  (v0, 0, e1, 0, e2, 0) per tri in leaf order, with
          e1 = v1 - v0 and e2 = v2 - v0 precomputed in float32;
  order   i32 [NN]:     row p = the ordering code of interior node p: the
          axis of largest separation of its children's centres, + 3 if
          the left child lies on the positive side of it;
  groups8 f32 [ceil(T/8), 8], groups4 f32 [ceil(T/4), 8]: row g = the
          box (bmin, 0, bmax, 0) of leaf-order slots [8g, 8g+8) or
          [4g, 4g+4), read as 2 float4.
"""

from __future__ import annotations

import collections.abc
import contextlib
import ctypes
import sys
import types

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..core import spans
from .bvh import preorder_indices
from .intersect import moller_trumbore

# The binary kernels' deepest tree: a stack entry is (node << 5) | depth
# in an int32 (csrc/bvh_traverse.cu bvh_traverse_max_depth).
MAX_DEPTH = 25
THREADS = 128  # a block of every traversal kernel (bvh_*_threads)
RUN = 32       # rays a warp takes from the work counter at once
FRONTIERS = range(2, 9)    # the frontier-K walk's K
FRONTIER_MAX_DEPTH = 20    # csrc/bvh_frontier.cu kMaxDepth
# The lane-tile kernels (csrc/bvh_frontier.cu, csrc/bvh_wide.cu): one ray
# per tile of lanes, a tile takes one ray at a time from the work counter,
# and a block's stacks live in at most SHARED_LIMIT bytes of shared memory
# (more needs an opt-in).
SHARED_LIMIT = 48 * 1024
# The frontier kernel's scan scratch, per warp: a range table of 64
# (start, shift) int32 pairs and one 8-byte key for each of up to 16 tiles.
FRONTIER_SCRATCH = 2 * 64 * 4 + 16 * 8
# The kernel indexes tris, boxes and rays with 32-bit ints as 3*i + k
# (float4 rows; 3 floats per ray): the most rows of each it can address.
MAX_ROWS = (2**31 - 1) // 3

ORDERS = ("near", "sign")
LEAF_MODES = ("full", "noscan", "skip")
_GROUP_TABLE = {1: "groups8", 2: "groups4"}
_GROUP_SHIFT = {1: 3, 2: 2}

# Kernel launches since the last reset: host counters of the span
# registry (``core/spans.py``) under these names.  ``launches`` and
# ``any_hit_launches`` count the binary kernel (csrc/bvh_traverse.cu),
# ``v1_launches`` its first version (csrc/bvh_traverse_v1.cu),
# ``frontier_launches`` the frontier-K kernel (csrc/bvh_frontier.cu),
# ``wide_launches`` the 8-wide kernel (csrc/bvh_wide.cu, launched by
# experiments/bvh_wide.py).  ``variant_launches`` splits them all by
# (order, leaf_aabb, leaf_mode, count_steps); the first version's order
# reads "binary-v1", the frontier walk's "frontier=K", the wide walk's
# "wide".  A wrapper counts where it launches; a CUDA graph
# (``core.device.CapturedCall``) takes its capture's counts out and adds
# them back on each replay.  The module's attributes of these names, and
# the functions below, are views of the registry's counters.
_COUNTERS = ("launches", "any_hit_launches", "v1_launches",
             "frontier_launches", "wide_launches")
_VARIANTS = "variant_launches"


class _Variants(collections.abc.Mapping):
    """``variant_launches``: the registry's (``_VARIANTS``, key)
    counters as a read-only dict of key -> launches."""

    def __getitem__(self, key):
        return spans.group(_VARIANTS)[key]

    def __iter__(self):
        return iter(spans.group(_VARIANTS))

    def __len__(self):
        return len(spans.group(_VARIANTS))

    def __repr__(self):
        return repr(spans.group(_VARIANTS))


variant_launches = _Variants()

# The frontier walk's stack over the rays of its last count_steps launch
# or plain run: the deepest any ray's stack grew (entries) and the pushes
# refused because it was full.  A refused push may lose a hit.
frontier_stack = {"deepest": 0, "refused": 0}


def reset_counts() -> None:
    spans.reset([*_COUNTERS, _VARIANTS])


def count_variant(key) -> None:
    spans.count((_VARIANTS, key))


def launch_counts() -> dict:
    """Every launch counter, ``variant_launches`` copied."""
    return {**{k: spans.counter(k) for k in _COUNTERS},
            "variant_launches": dict(variant_launches)}


@contextlib.contextmanager
def deferred_counts():
    """Take the launches counted inside the block back out of the
    counters, and yield them (filled in on exit) in ``launch_counts``'
    shape: ``spans.deferred`` seen through the launch counters."""
    taken: dict = {}
    try:
        with spans.deferred() as counts:
            yield taken
    finally:
        taken.update({k: counts.get(k, 0) for k in _COUNTERS})
        taken["variant_launches"] = {
            k[1]: v for k, v in counts.items()
            if isinstance(k, tuple) and k[0] == _VARIANTS}


def add_counts(counts: dict) -> None:
    """Add a ``deferred_counts`` record to the counters: the launches of
    one replay of the graph it was captured with."""
    spans.add({**{k: counts[k] for k in _COUNTERS},
               **{(_VARIANTS, k): v
                  for k, v in counts["variant_launches"].items()}})


class _Module(types.ModuleType):
    """This module, with each of ``_COUNTERS`` an attribute that reads
    and writes the registry's counter."""


for _name in _COUNTERS:
    setattr(_Module, _name, property(
        lambda self, n=_name: spans.counter(n),
        lambda self, v, n=_name: spans.count(n, v - spans.counter(n))))
sys.modules[__name__].__class__ = _Module


def frontier_stack_rows(frontier: int, depth: int) -> int:
    """Capacity of the frontier walk's per-ray stack, the TPU kernel's
    allocation; a push needs ``sp < rows - 1``."""
    return 4 * frontier * depth + 8


def frontier_tile(frontier: int) -> int:
    """Lanes of the tile that walks one ray of the frontier-K kernel: K
    rounded up to a power of two (2, 4, 4, 8, 8, 8, 8 for K = 2..8)."""
    if frontier not in FRONTIERS:
        raise ValueError(f"frontier {frontier!r}: expected 2..{FRONTIERS[-1]}")
    return 2 if frontier <= 2 else 4 if frontier <= 4 else 8


def frontier_shared_bytes(frontier: int, depth: int) -> int:
    """Dynamic shared memory of one block of the frontier-K kernel: each
    warp's ``FRONTIER_SCRATCH``, then one stack of ``frontier_stack_rows``
    int32 for each of its tiles.  Raises where a block would not fit in
    ``SHARED_LIMIT``."""
    tiles = THREADS // frontier_tile(frontier)
    nbytes = (THREADS // 32 * FRONTIER_SCRATCH
              + tiles * frontier_stack_rows(frontier, depth) * 4)
    if nbytes > SHARED_LIMIT:
        raise ValueError(f"frontier {frontier} at depth {depth}: {nbytes} "
                         f"bytes a block, over {SHARED_LIMIT}")
    return nbytes


def tile_grid(n: int, sm_count: int, blocks_per_sm: int, tile: int) -> int:
    """Blocks of a lane-tile kernel's persistent grid for ``n`` rays: every
    block that fits on the card at once, but no more than the rays fill
    (a tile takes one ray at a time, a block holds ``THREADS // tile``
    tiles)."""
    if sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"{sm_count} SMs x {blocks_per_sm} blocks: the "
                         f"kernel does not fit on the card")
    return max(1, min(sm_count * blocks_per_sm,
                      -(-n // (THREADS // tile))))


def pack_tables(node_bmin, node_bmax, node_from, node_to, verts_sorted,
                depth: int) -> dict:
    """Host-side kernel tables (numpy) from the flat BVH arrays and the
    leaf-ordered tri vertices [T, 3, 3]."""
    node_bmin = np.asarray(node_bmin, np.float32)
    node_bmax = np.asarray(node_bmax, np.float32)
    nn = node_bmin.shape[0]
    boxes = np.zeros((nn, 12), np.float32)
    leaves = np.zeros((nn, 4), np.int32)
    order = np.zeros((nn,), np.int32)
    pre = preorder_indices(depth)
    for d in range(depth):
        p = pre[d]
        l = p + 1
        r = p + (1 << (depth - d))
        boxes[p, 0:3] = node_bmin[l]
        boxes[p, 3:6] = node_bmax[l]
        boxes[p, 6:9] = node_bmin[r]
        boxes[p, 9:12] = node_bmax[r]
        with np.errstate(invalid="ignore"):  # empty nodes have no centre
            diff = ((node_bmin[r] + node_bmax[r]) * 0.5
                    - (node_bmin[l] + node_bmax[l]) * 0.5)
            ax = np.argmax(np.abs(diff), axis=1)
            left_pos = diff[np.arange(len(ax)), ax] < 0.0
        order[p] = ax + 3 * left_pos
        if d == depth - 1:
            leaves[p, 0] = node_from[l]
            leaves[p, 1] = node_to[l]
            leaves[p, 2] = node_from[r]
            leaves[p, 3] = node_to[r]
    v = np.asarray(verts_sorted, np.float32).reshape(-1, 3, 3)
    n_tris = v.shape[0]
    tris = np.zeros((n_tris, 12), np.float32)
    tris[:, 0:3] = v[:, 0]
    tris[:, 4:7] = v[:, 1] - v[:, 0]
    tris[:, 8:11] = v[:, 2] - v[:, 0]
    # Group boxes over the corners the kernel's arithmetic sees:
    # v0, v0 + e1, v0 + e2.
    corners = np.stack([tris[:, 0:3], tris[:, 0:3] + tris[:, 4:7],
                        tris[:, 0:3] + tris[:, 8:11]], axis=1)
    tmin = corners.min(axis=1) if n_tris else np.zeros((0, 3), np.float32)
    tmax = corners.max(axis=1) if n_tris else np.zeros((0, 3), np.float32)
    out = {"boxes": boxes, "leaves": leaves, "tris": tris, "order": order}
    for mode, name in _GROUP_TABLE.items():
        size = 1 << _GROUP_SHIFT[mode]
        n_groups = -(-n_tris // size)
        pad = n_groups * size - n_tris
        gmin = np.concatenate([tmin, np.full((pad, 3), np.inf, np.float32)])
        gmax = np.concatenate([tmax, np.full((pad, 3), -np.inf, np.float32)])
        table = np.zeros((n_groups, 8), np.float32)
        table[:, 0:3] = gmin.reshape(n_groups, size, 3).min(axis=1)
        table[:, 4:7] = gmax.reshape(n_groups, size, 3).max(axis=1)
        out[name] = table
    return out


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------

def traverse(tables: dict, ray_o, ray_d, depth: int, exclude=None,
             t_max=None, order: str = "near", leaf_aabb: int = 0,
             leaf_mode: str = "full", count_steps: bool = False,
             frontier: int = 1):
    """Nearest hit (or, with ``exclude`` [N] i32 and ``t_max`` [N] f32,
    occlusion) of rays [N, 3] against the tables' BVH.

    Returns (idx [N] i32, t [N] f32): the leaf-order tri id (-1 on a
    miss) and its distance.  In any-hit mode ``idx >= 0`` is the
    occlusion flag and t is -inf on a hit.  With ``count_steps`` a third
    result, the per-ray work counts [N, 4] i32 (see the module's note).
    ``order``, ``leaf_aabb`` and ``leaf_mode`` as the module's note says;
    an unknown value raises ``ValueError``.  ``frontier`` > 1 selects the
    frontier-K walk (K = 2..8, else ``ValueError``), which has no such
    variants: the three flags are then ignored."""
    if (exclude is None) != (t_max is None):
        raise ValueError("exclude and t_max come together (any-hit mode)")
    check_variant(order, leaf_aabb, leaf_mode)
    if frontier != 1:
        check_frontier(frontier, depth)
        if ray_o.device.type == "cpu":
            return traverse_frontier_plain(tables, ray_o, ray_d, depth,
                                           frontier, exclude, t_max,
                                           count_steps)
        if ray_o.device.type != "cuda":
            raise ValueError(f"traverse: unsupported device {ray_o.device}")
        return _launch_frontier(tables, ray_o, ray_d, depth, frontier,
                                exclude, t_max, count_steps)
    if ray_o.device.type == "cpu":
        return traverse_plain(tables, ray_o, ray_d, depth, exclude, t_max,
                              order, leaf_aabb, leaf_mode, count_steps)
    if ray_o.device.type != "cuda":
        raise ValueError(f"traverse: unsupported device {ray_o.device}")
    return _launch(tables, ray_o, ray_d, depth, exclude, t_max, order,
                   leaf_aabb, leaf_mode, count_steps)


def check_variant(order, leaf_aabb, leaf_mode):
    if order not in ORDERS:
        raise ValueError(f"order {order!r}: expected one of {ORDERS}")
    if leaf_aabb not in (0, 1, 2):
        raise ValueError(f"leaf_aabb {leaf_aabb!r}: expected 0, 1 or 2")
    if leaf_mode not in LEAF_MODES:
        raise ValueError(f"leaf_mode {leaf_mode!r}: expected one of "
                         f"{LEAF_MODES}")


def check_frontier(frontier, depth):
    if frontier not in FRONTIERS:
        raise ValueError(f"frontier {frontier!r}: expected 1 (the binary "
                         f"walk) or 2..{FRONTIERS[-1]}")
    if not 1 <= depth <= FRONTIER_MAX_DEPTH:
        raise ValueError(f"bvh depth {depth} outside the frontier walk's "
                         f"range [1, {FRONTIER_MAX_DEPTH}]")


def _check(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_lib = None


def _library():
    global _lib
    if _lib is None:
        from .. import kernels
        lib = kernels.load("bvh_traverse")
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.bvh_traverse.argtypes = [p] * 13 + [i] * 8 + [p]
        lib.bvh_traverse.restype = ctypes.c_int
        lib.bvh_traverse_blocks_per_sm.argtypes = [i] * 6 + [p]
        lib.bvh_traverse_blocks_per_sm.restype = ctypes.c_int
        lib.bvh_traverse_stack_bytes.argtypes = [i]
        lib.bvh_traverse_stack_bytes.restype = ctypes.c_int
        lib.bvh_traverse_error_string.argtypes = [ctypes.c_int]
        lib.bvh_traverse_error_string.restype = ctypes.c_char_p
        for fn, want in ((lib.bvh_traverse_threads, THREADS),
                         (lib.bvh_traverse_max_depth, MAX_DEPTH)):
            fn.argtypes = []
            fn.restype = ctypes.c_int
            if fn() != want:
                raise RuntimeError(f"csrc/bvh_traverse.cu {fn.__name__} is "
                                   f"{fn()}, ops/traverse.py expects {want}")
        _lib = lib
    return _lib


def persistent_grid(n: int, sm_count: int, blocks_per_sm: int) -> int:
    """Blocks of the binary kernel's persistent grid for ``n`` rays: every
    block that fits on the card at once, but no more than the rays fill
    (a warp takes ``RUN`` rays at a time)."""
    if sm_count < 1 or blocks_per_sm < 1:
        raise ValueError(f"{sm_count} SMs x {blocks_per_sm} blocks: the "
                         f"kernel does not fit on the card")
    warps = -(-n // RUN)
    return max(1, min(sm_count * blocks_per_sm,
                      -(-warps // (THREADS // 32))))


def work_counter(device) -> torch.Tensor:
    """The persistent grid's work counter, the next ray a warp takes: one
    int32, which the C entry point zeroes on the stream before its
    launch (a memset costs less than ``torch.zeros``' own kernel)."""
    return torch.empty((1,), dtype=torch.int32, device=device)


def stack_bytes(depth: int) -> int:
    """Dynamic shared memory of one block of the binary kernel at
    ``depth``, its threads' stacks, as the C side launches it (loads the
    library: card only)."""
    return _library().bvh_traverse_stack_bytes(depth)


# (device index, kernel, its query's arguments) -> (SMs, blocks of that
# kernel per SM; a binary probe's are its full scan's).
_occupancy: dict = {}


def _fit(lib, name: str, dev, *args) -> tuple[int, int]:
    """(SMs of ``dev``, blocks per SM) of the traversal kernel that
    ``lib``'s ``{name}_blocks_per_sm(*args, &blocks)`` answers for: the
    persistent grid's two factors, asked once per device."""
    key = (dev.index, name, args)
    fit = _occupancy.get(key)
    if fit is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = getattr(lib, f"{name}_blocks_per_sm")(
                *args, ctypes.addressof(out))
            if rc != 0:
                raise RuntimeError(
                    f"{name} occupancy query failed: "
                    + getattr(lib, f"{name}_error_string")(rc).decode())
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
        fit = _occupancy[key] = (sms, out.value)
    return fit


def blocks_per_sm(device, depth: int, any_hit: bool = False) -> int:
    """Blocks of the binary kernel's default variant that fit on one SM of
    ``device`` at ``depth``: the persistent grid's second factor."""
    return _fit(_library(), "bvh_traverse", torch.device(device),
                int(any_hit), 0, 0, 0, 0, depth)[1]


# Leaf table -> (its _version, tri rows) when it passed the check.  Keyed
# on the tensor object, held weakly: a new table is checked even where
# the allocator hands it a freed table's address, and a dropped table
# leaves no entry behind.
_checked_leaves = WeakIdKeyDictionary()


def _check_leaf_ranges(leaves, t_rows):
    """Every leaf range of ``leaves`` lies in [0, t_rows).  Checked once
    per table (one device sync), then remembered until the table
    changes."""
    if _checked_leaves.get(leaves) == (leaves._version, t_rows):
        return
    lo = leaves[:, 0::2]
    hi = leaves[:, 1::2]
    if bool(((lo < 0) | (hi < lo) | (hi > t_rows)).any()):
        raise ValueError(f"leaf table has a tri range outside [0, {t_rows})")
    _checked_leaves[leaves] = (leaves._version, t_rows)


def _check_launch(tables, ray_o, ray_d, depth, exclude, t_max):
    """What every launch checks: the binary tables, the rays and the
    any-hit inputs, on the rays' device.  Returns (n, nn, t_rows)."""
    dev = ray_o.device
    n = ray_o.shape[0]
    nn = tables["boxes"].shape[0]
    if nn != (1 << (depth + 1)) - 1:
        raise ValueError(f"boxes has {nn} rows, depth {depth} needs "
                         f"{(1 << (depth + 1)) - 1}")
    _check("boxes", tables["boxes"], torch.float32, (nn, 12), dev)
    _check("leaves", tables["leaves"], torch.int32, (nn, 4), dev)
    t_rows = tables["tris"].shape[0]
    _check("tris", tables["tris"], torch.float32, (t_rows, 12), dev)
    if t_rows > MAX_ROWS or n > MAX_ROWS:
        raise ValueError(f"{t_rows} tris and {n} rays: the kernel's 32-bit "
                         f"indexing serves at most {MAX_ROWS} of each")
    _check_leaf_ranges(tables["leaves"], t_rows)
    _check("ray_o", ray_o, torch.float32, (n, 3), dev)
    _check("ray_d", ray_d, torch.float32, (n, 3), dev)
    if exclude is not None:
        _check("exclude", exclude, torch.int32, (n,), dev)
        _check("t_max", t_max, torch.float32, (n,), dev)
    return n, nn, t_rows


def _ptr(x):
    return None if x is None else x.data_ptr()


def _outputs(n, dev, count_steps):
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    counts = (torch.empty((n, 4), dtype=torch.int32, device=dev)
              if count_steps else None)
    return idx, t, counts


def _check_depth(depth):
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"bvh depth {depth} outside the kernel's range "
                         f"[1, {MAX_DEPTH}]")


def _launch(tables, ray_o, ray_d, depth, exclude, t_max, order="near",
            leaf_aabb=0, leaf_mode="full", count_steps=False):
    check_variant(order, leaf_aabb, leaf_mode)
    dev = ray_o.device
    _check_depth(depth)
    n, nn, t_rows = _check_launch(tables, ray_o, ray_d, depth, exclude, t_max)
    code = groups = None
    if order == "sign":
        code = tables["order"]
        _check("order", code, torch.int32, (nn,), dev)
    scans = leaf_mode == "full"
    if leaf_aabb and scans:
        groups = tables[_GROUP_TABLE[leaf_aabb]]
        size = 1 << _GROUP_SHIFT[leaf_aabb]
        _check(_GROUP_TABLE[leaf_aabb], groups, torch.float32,
               (-(-t_rows // size), 8), dev)
    any_hit = exclude is not None
    idx, t, counts = _outputs(n, dev, count_steps)
    work = work_counter(dev)
    lib = _library()
    flags = (int(any_hit), int(count_steps), int(order == "sign"),
             leaf_aabb if scans else 0, LEAF_MODES.index(leaf_mode))
    with torch.cuda.device(dev):
        grid = persistent_grid(n, *_fit(lib, "bvh_traverse", dev, *flags,
                                        depth))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bvh_traverse(
            _ptr(tables["boxes"]), _ptr(tables["leaves"]),
            _ptr(tables["tris"]), _ptr(code), _ptr(groups), _ptr(ray_o),
            _ptr(ray_d), _ptr(exclude), _ptr(t_max), _ptr(idx), _ptr(t),
            _ptr(counts), _ptr(work), n, depth, *flags, grid, stream)
    if rc != 0:
        raise RuntimeError("bvh_traverse launch failed: "
                           + lib.bvh_traverse_error_string(rc).decode())
    if n > 0:
        spans.count("launches")
        spans.count("any_hit_launches", int(any_hit))
        count_variant((order, leaf_aabb, leaf_mode, bool(count_steps)))
    if count_steps:
        return idx, t, counts
    return idx, t


def traverse_v1(tables: dict, ray_o, ray_d, depth: int, exclude=None,
                t_max=None, count_steps: bool = False):
    """``traverse``'s default variant through the kernel's first version,
    ``csrc/bvh_traverse_v1.cu``, on a CUDA tensor (the traversal sweep's
    walk "binary-v1"); ``traverse_plain`` on a CPU tensor.  The same
    results and counters as ``traverse``."""
    if (exclude is None) != (t_max is None):
        raise ValueError("exclude and t_max come together (any-hit mode)")
    if ray_o.device.type == "cpu":
        return traverse_plain(tables, ray_o, ray_d, depth, exclude, t_max,
                              count_steps=count_steps)
    if ray_o.device.type != "cuda":
        raise ValueError(f"traverse: unsupported device {ray_o.device}")
    return _launch_v1(tables, ray_o, ray_d, depth, exclude, t_max,
                      count_steps)


_v1_lib = None


def _v1_library():
    global _v1_lib
    if _v1_lib is None:
        from .. import kernels
        lib = kernels.load("bvh_traverse_v1")
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.bvh_traverse_v1.argtypes = [p] * 10 + [i] * 4 + [p]
        lib.bvh_traverse_v1.restype = ctypes.c_int
        lib.bvh_traverse_v1_error_string.argtypes = [ctypes.c_int]
        lib.bvh_traverse_v1_error_string.restype = ctypes.c_char_p
        _v1_lib = lib
    return _v1_lib


def _launch_v1(tables, ray_o, ray_d, depth, exclude, t_max,
               count_steps=False):
    dev = ray_o.device
    _check_depth(depth)
    n, _, _ = _check_launch(tables, ray_o, ray_d, depth, exclude, t_max)
    any_hit = exclude is not None
    idx, t, counts = _outputs(n, dev, count_steps)
    lib = _v1_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bvh_traverse_v1(
            _ptr(tables["boxes"]), _ptr(tables["leaves"]),
            _ptr(tables["tris"]), _ptr(ray_o), _ptr(ray_d), _ptr(exclude),
            _ptr(t_max), _ptr(idx), _ptr(t), _ptr(counts), n, depth,
            int(any_hit), int(count_steps), stream)
    if rc != 0:
        raise RuntimeError("bvh_traverse_v1 launch failed: "
                           + lib.bvh_traverse_v1_error_string(rc).decode())
    if n > 0:
        spans.count("v1_launches")
        count_variant(("binary-v1", 0, "full", bool(count_steps)))
    if count_steps:
        return idx, t, counts
    return idx, t


_frontier_lib = None


def _frontier_library():
    global _frontier_lib
    if _frontier_lib is None:
        from .. import kernels
        lib = kernels.load("bvh_frontier")
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.bvh_frontier.argtypes = [p] * 12 + [i] * 6 + [p]
        lib.bvh_frontier.restype = ctypes.c_int
        lib.bvh_frontier_blocks_per_sm.argtypes = [i] * 3 + [p]
        lib.bvh_frontier_blocks_per_sm.restype = ctypes.c_int
        lib.bvh_frontier_error_string.argtypes = [ctypes.c_int]
        lib.bvh_frontier_error_string.restype = ctypes.c_char_p
        for name in ("max_depth", "threads"):
            getattr(lib, f"bvh_frontier_{name}").restype = ctypes.c_int
        lib.bvh_frontier_tile_width.argtypes = [i]
        lib.bvh_frontier_tile_width.restype = ctypes.c_int
        lib.bvh_frontier_shared_bytes.argtypes = [i, i]
        lib.bvh_frontier_shared_bytes.restype = ctypes.c_int
        c_side = (lib.bvh_frontier_max_depth(), lib.bvh_frontier_threads())
        if c_side != (FRONTIER_MAX_DEPTH, THREADS):
            raise RuntimeError(f"csrc/bvh_frontier.cu (kMaxDepth, kThreads) "
                               f"= {c_side}, ops/traverse.py expects "
                               f"{(FRONTIER_MAX_DEPTH, THREADS)}")
        for k in FRONTIERS:
            if lib.bvh_frontier_tile_width(k) != frontier_tile(k):
                raise RuntimeError(f"csrc/bvh_frontier.cu tile width for "
                                   f"K={k} disagrees with frontier_tile")
            for dep in range(1, FRONTIER_MAX_DEPTH + 1):
                if (lib.bvh_frontier_shared_bytes(k, dep)
                        != frontier_shared_bytes(k, dep)):
                    raise RuntimeError(
                        f"csrc/bvh_frontier.cu shared bytes for K={k}, "
                        f"depth {dep} disagree with frontier_shared_bytes")
        _frontier_lib = lib
    return _frontier_lib


def frontier_blocks_per_sm(device, frontier: int, depth: int,
                           count_steps: bool = False) -> int:
    """Blocks of the frontier-K kernel that fit on one SM of ``device`` at
    ``depth``: the persistent grid's second factor."""
    return _fit(_frontier_library(), "bvh_frontier", torch.device(device),
                frontier, int(count_steps), depth)[1]


def _launch_frontier(tables, ray_o, ray_d, depth, frontier, exclude, t_max,
                     count_steps=False):
    check_frontier(frontier, depth)
    dev = ray_o.device
    n, _, _ = _check_launch(tables, ray_o, ray_d, depth, exclude, t_max)
    any_hit = exclude is not None
    idx, t, counts = _outputs(n, dev, count_steps)
    stats = (torch.zeros((2,), dtype=torch.int32, device=dev)
             if count_steps else None)
    work = work_counter(dev)
    lib = _frontier_library()
    with torch.cuda.device(dev):
        grid = tile_grid(n, *_fit(lib, "bvh_frontier", dev, frontier,
                                  int(count_steps), depth),
                         frontier_tile(frontier))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bvh_frontier(
            _ptr(tables["boxes"]), _ptr(tables["leaves"]),
            _ptr(tables["tris"]), _ptr(ray_o), _ptr(ray_d), _ptr(exclude),
            _ptr(t_max), _ptr(idx), _ptr(t), _ptr(counts), _ptr(stats),
            _ptr(work), n, depth, frontier, int(any_hit), int(count_steps),
            grid, stream)
    if rc != 0:
        raise RuntimeError("bvh_frontier launch failed: "
                           + lib.bvh_frontier_error_string(rc).decode())
    if n > 0:
        spans.count("frontier_launches")
        count_variant((f"frontier={frontier}", 0, "full", bool(count_steps)))
    if count_steps:
        if n > 0:
            deepest, refused = stats.tolist()  # the instrument may sync
            frontier_stack.update(deepest=deepest, refused=refused)
        return idx, t, counts
    return idx, t


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------

def _mn(a, b):
    return torch.where(a < b, a, b)


def _mx(a, b):
    return torch.where(a > b, a, b)


def _slab_parts(bmin, bmax, o, inv):
    """The slab test without its prune: (the ray meets the box, its entry
    distance).  bmin/bmax/o/inv broadcastable [..., 3]."""
    t1 = (bmin[..., 0] - o[..., 0]) * inv[..., 0]
    t2 = (bmax[..., 0] - o[..., 0]) * inv[..., 0]
    t3 = (bmin[..., 1] - o[..., 1]) * inv[..., 1]
    t4 = (bmax[..., 1] - o[..., 1]) * inv[..., 1]
    t5 = (bmin[..., 2] - o[..., 2]) * inv[..., 2]
    t6 = (bmax[..., 2] - o[..., 2]) * inv[..., 2]
    tmin = _mx(_mx(_mn(t1, t2), _mn(t3, t4)), _mn(t5, t6))
    tmax = _mn(_mn(_mx(t1, t2), _mx(t3, t4)), _mx(t5, t6))
    return ~((tmax < 0.0) | (tmin > tmax)), tmin


def _slab(bmin, bmax, o, inv, best_t):
    meets, tmin = _slab_parts(bmin, bmax, o, inv)
    hit = meets & (tmin < best_t)
    return hit, torch.where(hit, tmin, torch.full_like(tmin, float("inf")))


def _mt(tri, o, d):
    """The kernel's Möller-Trumbore, op for op: tri [..., 12], o/d
    broadcastable [..., 3].  Returns (ok without the best_t test, t)."""
    v0x, v0y, v0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 4], tri[..., 5], tri[..., 6]
    e2x, e2y, e2z = tri[..., 8], tri[..., 9], tri[..., 10]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30,
                                torch.full_like(det, 1e-30), det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((torch.abs(det) > 1e-7) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 0.0))
    return ok, t


# Elements of one batched leaf scan ([rays, slots]): 2^23 bound the
# scan's temporaries to about 2 GB at the main path's ray counts.
_LEAF_CHUNK = 1 << 23


def _groups_of_8(frm, to, over):
    return torch.where(over & (to > frm), ((to - 1) >> 3) - (frm >> 3) + 1,
                       torch.zeros_like(frm))


def _leaf_scan(tris, lv, l_over, r_over, o, d, best_idx, best_t, excl,
               any_hit):
    """Scans the right child's slots then the left's for each ray, in one
    batched pass, with the sequential rules: closest-hit keeps the first
    slot (in scan order) of least t below best_t; any-hit keeps the first
    accepted slot.  Returns (idx, t, hit, tested slots, an any-hit ray
    was resolved in the right child)."""
    nr = torch.where(r_over, lv[:, 3] - lv[:, 2], torch.zeros_like(lv[:, 0]))
    nl = torch.where(l_over, lv[:, 1] - lv[:, 0], torch.zeros_like(lv[:, 0]))
    total = nr + nl
    width = int(total.max()) if total.numel() else 0
    out_idx = best_idx.clone()
    out_t = best_t.clone()
    hit = torch.zeros_like(l_over)
    in_right = torch.zeros_like(l_over)
    tested = total.clone()
    if width == 0:
        return out_idx, out_t, hit, tested, in_right
    rows = max(1, _LEAF_CHUNK // width)
    j = torch.arange(width, device=o.device)
    for s in range(0, lv.shape[0], rows):
        e = min(s + rows, lv.shape[0])
        jr = j[None, :]
        slot = torch.where(jr < nr[s:e, None], lv[s:e, 2:3] + jr,
                           lv[s:e, 0:1] + (jr - nr[s:e, None]))
        valid = jr < total[s:e, None]
        tri = tris[torch.where(valid, slot, torch.zeros_like(slot))]
        ok, t = _mt(tri, o[s:e, None, :], d[s:e, None, :])
        ok = valid & ok & (t < best_t[s:e, None])
        if any_hit:
            ok = ok & (slot != excl[s:e, None])
            first = torch.argmax(ok.to(torch.int8), dim=1)
            has = ok.any(dim=1)
            pick_t = torch.full_like(best_t[s:e], float("-inf"))
            tested[s:e] = torch.where(has, first + 1, total[s:e])
        else:
            tm = torch.where(ok, t, torch.full_like(t, float("inf")))
            tmin = tm.min(dim=1).values
            has = ok.any(dim=1)
            first = torch.argmax((ok & (tm == tmin[:, None])).to(torch.int8),
                                 dim=1)
            pick_t = tmin
        pick = slot.gather(1, first[:, None])[:, 0]
        out_idx[s:e] = torch.where(has, pick, out_idx[s:e])
        out_t[s:e] = torch.where(has, pick_t, out_t[s:e])
        hit[s:e] = has
        if any_hit:
            in_right[s:e] = has & (first < nr[s:e])
    return out_idx, out_t, hit, tested, in_right


def _leaf_scan_grouped(tris, boxes, shift, lv, l_over, r_over, o, d, inv,
                       best_idx, best_t, excl, any_hit):
    """``_leaf_scan`` behind the group boxes (``leaf_aabb`` 1 or 2): the
    right child's aligned groups of ``1 << shift`` slots, then the
    left's; a group is tested only if its box passes the slab test with
    the best_t of that moment.  Same results as ``_leaf_scan``."""
    size = 1 << shift
    dev = o.device
    zero = torch.zeros_like(lv[:, 0])

    def n_groups(frm, to, over):
        return torch.where(over & (to > frm),
                           ((to - 1) >> shift) - (frm >> shift) + 1, zero)

    ngr = n_groups(lv[:, 2], lv[:, 3], r_over)
    ngl = n_groups(lv[:, 0], lv[:, 1], l_over)
    total = ngr + ngl
    width = int(total.max()) if total.numel() else 0
    out_idx = best_idx.clone()
    out_t = best_t.clone()
    hit = torch.zeros_like(l_over)
    in_right = torch.zeros_like(l_over)
    tested = zero.clone()
    if width == 0:
        return out_idx, out_t, hit, tested, in_right
    rows = max(1, _LEAF_CHUNK // (width * size))
    j = torch.arange(width, device=dev)[None, :]
    k = torch.arange(size, device=dev)[None, None, :]
    for s in range(0, lv.shape[0], rows):
        e = min(s + rows, lv.shape[0])
        c = lv[s:e]
        right = j < ngr[s:e, None]
        g = torch.where(right, (c[:, 2:3] >> shift) + j,
                        (c[:, 0:1] >> shift) + (j - ngr[s:e, None]))
        gvalid = j < total[s:e, None]
        g = torch.where(gvalid, g, torch.zeros_like(g))
        frm = torch.where(right, c[:, 2:3], c[:, 0:1])
        to = torch.where(right, c[:, 3:4], c[:, 1:2])
        s0 = torch.maximum(frm, g << shift)
        s1 = torch.minimum(to, (g + 1) << shift)
        box = boxes[g]
        meets, entry = _slab_parts(box[..., 0:3], box[..., 4:7],
                                   o[s:e, None, :], inv[s:e, None, :])
        meets = meets & gvalid
        slot = (g << shift)[:, :, None] + k
        svalid = (gvalid[:, :, None] & (slot >= s0[:, :, None])
                  & (slot < s1[:, :, None]))
        tri = tris[torch.where(svalid, slot, torch.zeros_like(slot))]
        ok, t = _mt(tri, o[s:e, None, None, :], d[s:e, None, None, :])
        ok = ok & svalid
        bt = best_t[s:e]
        bi = best_idx[s:e]
        if any_hit:
            # best_t stays t_max until the ray is resolved.
            passed = meets & (entry < bt[:, None])
            ok = (ok & passed[:, :, None] & (t < bt[:, None, None])
                  & (slot != excl[s:e, None, None]))
            flat = ok.reshape(e - s, -1)
            has = flat.any(dim=1)
            first = torch.argmax(flat.to(torch.int8), dim=1)
            done = (svalid & passed[:, :, None]).reshape(e - s, -1).cumsum(1)
            tested[s:e] = torch.where(has, done.gather(1, first[:, None])[:, 0],
                                      done[:, -1])
            pick = slot.reshape(e - s, -1).gather(1, first[:, None])[:, 0]
            out_idx[s:e] = torch.where(has, pick, bi)
            out_t[s:e] = torch.where(has, torch.full_like(bt, float("-inf")),
                                     bt)
            hit[s:e] = has
            in_right[s:e] = has & ((first // size) < ngr[s:e])
            continue
        n_tested = torch.zeros_like(ngr[s:e])
        for q in range(width):
            passed = meets[:, q] & (entry[:, q] < bt)
            okq = ok[:, q] & passed[:, None] & (t[:, q] < bt[:, None])
            tm = torch.where(okq, t[:, q], torch.full_like(t[:, q],
                                                          float("inf")))
            tmin = tm.min(dim=1).values
            has = okq.any(dim=1)
            first = torch.argmax((okq & (tm == tmin[:, None])).to(torch.int8),
                                 dim=1)
            pick = slot[:, q].gather(1, first[:, None])[:, 0]
            bi = torch.where(has, pick, bi)
            bt = torch.where(has, tmin, bt)
            n_tested = n_tested + torch.where(passed, s1[:, q] - s0[:, q],
                                              torch.zeros_like(n_tested))
            hit[s:e] |= has
        out_idx[s:e] = bi
        out_t[s:e] = bt
        tested[s:e] = n_tested
    return out_idx, out_t, hit, tested, in_right


def traverse_plain(tables: dict, ray_o, ray_d, depth: int, exclude=None,
                   t_max=None, order: str = "near", leaf_aabb: int = 0,
                   leaf_mode: str = "full", count_steps: bool = False):
    """The kernel's walk as lockstep PyTorch over the still-active rays,
    with the kernel's arguments.

    Same results as the kernel for every variant (ids equal, t bit-equal)
    and, with ``count_steps``, the same per-ray counts [N, 4] i32: node
    visits, leaf-parent visits, 8-aligned slot groups of the leaf ranges
    entered, Möller-Trumbore tests (the inputs to the kernel's bound)."""
    check_variant(order, leaf_aabb, leaf_mode)
    dev = ray_o.device
    n = ray_o.shape[0]
    any_hit = exclude is not None
    boxes, leaves, tris = tables["boxes"], tables["leaves"], tables["tris"]
    leaves = leaves.to(torch.int64)
    sign = order == "sign"
    code = tables["order"].to(torch.int64) if sign else None
    grouped = leaf_aabb != 0 and leaf_mode == "full"
    group_boxes = tables[_GROUP_TABLE[leaf_aabb]] if grouped else None
    inv = 1.0 / ray_d
    best_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_t = (t_max.clone() if any_hit
              else torch.full((n,), float("inf"), device=dev))
    excl = exclude.to(torch.int64) if any_hit else None
    stack_node = torch.full((n, depth + 2), -1, dtype=torch.int64, device=dev)
    stack_dep = torch.zeros((n, depth + 2), dtype=torch.int64, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    ndep = torch.zeros_like(node)
    sp = torch.ones_like(node)
    counts = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        nd, dep, bt = node[act], ndep[act], best_t[act]
        o, iv = ray_o[act], inv[act]
        b = boxes[nd]
        l_over, l_near = _slab(b[:, 0:3], b[:, 3:6], o, iv, bt)
        r_over, r_near = _slab(b[:, 6:9], b[:, 9:12], o, iv, bt)
        alp = dep == depth - 1
        counts[act, 0] += 1
        resolved = torch.zeros_like(alp)
        at_leaf = alp & (l_over | r_over)
        if leaf_mode != "skip" and bool(at_leaf.any()):
            sel = at_leaf.nonzero()[:, 0]
            ga = act[sel]
            lv = leaves[nd[sel]]
            lo, ro = l_over[sel], r_over[sel]
            counts[ga, 1] += 1
            in_right = torch.zeros_like(lo)
            if leaf_mode == "full":
                args = (lv, lo, ro, ray_o[ga], ray_d[ga])
                rest = (best_idx[ga], best_t[ga],
                        excl[ga] if any_hit else None, any_hit)
                if grouped:
                    idx2, t2, hit, tested, in_right = _leaf_scan_grouped(
                        tris, group_boxes, _GROUP_SHIFT[leaf_aabb], *args,
                        inv[ga], *rest)
                else:
                    idx2, t2, hit, tested, in_right = _leaf_scan(
                        tris, *args, *rest)
                best_idx[ga] = idx2
                best_t[ga] = t2
                counts[ga, 3] += tested
                if any_hit:
                    resolved[sel] = hit
            # An any-hit ray resolved in the right child never enters
            # the left.
            counts[ga, 2] += (_groups_of_8(lv[:, 2], lv[:, 3], ro)
                              + _groups_of_8(lv[:, 0], lv[:, 1],
                                             lo & ~in_right))
        trav_l = l_over & ~alp
        trav_r = r_over & ~alp
        push = trav_l & trav_r
        pop = ~trav_l & ~trav_r
        l_idx = nd + 1
        r_idx = nd + (1 << (depth - dep))
        if sign:
            c = code[nd]
            left_pos = c >= 3
            ax = torch.where(left_pos, c - 3, c)
            along = ray_d[act].gather(1, ax[:, None])[:, 0]
            l_first = (along >= 0.0) != left_pos
        else:
            l_first = l_near <= r_near
        first = torch.where(l_first, l_idx, r_idx)
        second = torch.where(l_first, r_idx, l_idx)
        s = sp[act]
        if bool(push.any()):
            stack_node[act[push], s[push]] = second[push]
            stack_dep[act[push], s[push]] = dep[push] + 1
        sp_pop = torch.clamp(s - 1, min=0)
        popped_node = stack_node[act, sp_pop]
        popped_dep = stack_dep[act, sp_pop]
        node[act] = torch.where(push, first, torch.where(
            trav_l, l_idx, torch.where(trav_r, r_idx, popped_node)))
        ndep[act] = torch.where(pop, popped_dep, dep + 1)
        sp[act] = torch.where(push, s + 1, torch.where(pop, s - 1, s))
        done = (pop & (popped_node < 0)) | resolved
        act = act[~done]
    out = (best_idx.to(torch.int32), best_t)
    if count_steps:
        return out + (counts.to(torch.int32),)
    return out


def _grown(stack, need):
    """``stack`` [n, w] with at least ``need`` columns (doubling)."""
    w = stack.shape[1]
    if need <= w:
        return stack
    pad = torch.zeros((stack.shape[0], max(w, need - w)), dtype=stack.dtype,
                      device=stack.device)
    return torch.cat([stack, pad], dim=1)


def traverse_frontier_plain(tables: dict, ray_o, ray_d, depth: int,
                            frontier: int, exclude=None, t_max=None,
                            count_steps: bool = False):
    """The frontier-K kernel's walk (csrc/bvh_frontier.cu) as lockstep
    PyTorch over the still-active rays: per step each ray pops up to
    ``frontier`` stack entries, slab-tests all their children with the
    best_t of the step's start, then takes the entries in pop order: leaf
    scans (right child, then left, with the running best_t) at leaf
    parents, elsewhere a push of the farther child and then the nearer.
    The stack holds ``frontier_stack_rows`` entries and a push needs
    ``sp < rows - 1``, as in the kernel; ``frontier_stack`` reports the
    deepest stack and the refused pushes of this run.

    Same results as the kernel: ids equal, t bit-equal and, with
    ``count_steps``, the same per-ray counts [N, 4] i32 (node visits,
    leaf-parent visits, 8-aligned slot groups entered, tri tests); an
    any-hit ray stops at the entry that resolves it."""
    check_frontier(frontier, depth)
    dev = ray_o.device
    n = ray_o.shape[0]
    any_hit = exclude is not None
    boxes, tris = tables["boxes"], tables["tris"]
    leaves = tables["leaves"].to(torch.int64)
    cap = frontier_stack_rows(frontier, depth)
    inv = 1.0 / ray_d
    best_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_t = (t_max.clone() if any_hit
              else torch.full((n,), float("inf"), device=dev))
    excl = exclude.to(torch.int64) if any_hit else None
    # The stack's storage grows on demand; its capacity is ``cap``.
    stack_node = torch.zeros((n, min(cap, 2 * depth + 8)), dtype=torch.int64,
                             device=dev)
    stack_dep = torch.zeros_like(stack_node)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    counts = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    deepest = 1 if n else 0
    refused = 0
    act = torch.arange(n, device=dev)
    while act.numel():
        s = sp[act]
        k = torch.clamp(s, max=frontier)
        o, iv, d = ray_o[act], inv[act], ray_d[act]
        bt0 = best_t[act]
        ent = []
        for j in range(frontier):
            valid = k > j
            pos = torch.clamp(s - 1 - j, min=0)
            nd = stack_node[act, pos]
            dep = stack_dep[act, pos]
            b = boxes[nd]
            l_over, l_near = _slab(b[:, 0:3], b[:, 3:6], o, iv, bt0)
            r_over, r_near = _slab(b[:, 6:9], b[:, 9:12], o, iv, bt0)
            ent.append((valid, nd, dep, l_over & valid, r_over & valid,
                        l_near, r_near))
        s = s - k
        counts[act, 0] += k
        resolved = torch.zeros_like(ent[0][0])
        for valid, nd, dep, l_over, r_over, l_near, r_near in ent:
            live = valid & ~resolved
            alp = dep == depth - 1
            at_leaf = live & alp & (l_over | r_over)
            if bool(at_leaf.any()):
                sel = at_leaf.nonzero()[:, 0]
                ga = act[sel]
                lv = leaves[nd[sel]]
                lo, ro = l_over[sel], r_over[sel]
                idx2, t2, hit, tested, in_right = _leaf_scan(
                    tris, lv, lo, ro, ray_o[ga], ray_d[ga], best_idx[ga],
                    best_t[ga], excl[ga] if any_hit else None, any_hit)
                best_idx[ga] = idx2
                best_t[ga] = t2
                counts[ga, 1] += 1
                counts[ga, 2] += (_groups_of_8(lv[:, 2], lv[:, 3], ro)
                                  + _groups_of_8(lv[:, 0], lv[:, 1],
                                                 lo & ~in_right))
                counts[ga, 3] += tested
                if any_hit:
                    resolved[sel] = hit
            trav = live & ~alp
            l_idx = nd + 1
            r_idx = nd + (1 << (depth - dep))
            l_first = l_near <= r_near
            first = torch.where(l_first, l_idx, r_idx)
            second = torch.where(l_first, r_idx, l_idx)
            first_ok = torch.where(l_first, l_over, r_over) & trav
            second_ok = torch.where(l_first, r_over, l_over) & trav
            for child, ok in ((second, second_ok), (first, first_ok)):
                room = s < cap - 1
                refused += int((ok & ~room).sum())
                push = ok & room
                if bool(push.any()):
                    need = int(s[push].max()) + 1
                    stack_node = _grown(stack_node, need)
                    stack_dep = _grown(stack_dep, need)
                    stack_node[act[push], s[push]] = child[push]
                    stack_dep[act[push], s[push]] = dep[push] + 1
                    s = s + push.to(s.dtype)
            deepest = max(deepest, int(s.max()))
        sp[act] = s
        act = act[(s > 0) & ~resolved]
    frontier_stack.update(deepest=deepest, refused=refused)
    out = (best_idx.to(torch.int32), best_t)
    if count_steps:
        return out + (counts.to(torch.int32),)
    return out


# --------------------------------------------------------------------------
# Brute force
# --------------------------------------------------------------------------

def brute_force(tri_verts, ray_o, ray_d, chunk: int = 512):
    """Tests every tri (in chunks of ``chunk``): (idx [N] i64, t [N] f32),
    first least t on ties, as the JAX package's ``brute_force``."""
    T = tri_verts.shape[0]
    N = ray_o.shape[0]
    dev = ray_o.device
    best_idx = torch.full((N,), -1, dtype=torch.int64, device=dev)
    best_t = torch.full((N,), float("inf"), device=dev)
    if T == 0:
        return best_idx, best_t
    n_chunks = -(-T // chunk)
    pad = n_chunks * chunk - T
    v = torch.cat([tri_verts, torch.zeros((pad, 3, 3), dtype=tri_verts.dtype,
                                          device=dev)])
    for c in range(n_chunks):
        base = c * chunk
        vb = v[base:base + chunk]
        valid, t, _, _ = moller_trumbore(
            ray_o[:, None, :], ray_d[:, None, :],
            vb[None, :, 0], vb[None, :, 1], vb[None, :, 2])
        idx = base + torch.arange(chunk, device=dev)[None, :]
        valid = valid & (idx < T)
        t = torch.where(valid, t, torch.full_like(t, float("inf")))
        arg = torch.argmin(t, dim=1)
        tmin = t.gather(1, arg[:, None])[:, 0]
        better = tmin < best_t
        best_idx = torch.where(better, base + arg, best_idx)
        best_t = torch.where(better, tmin, best_t)
    return best_idx, best_t
