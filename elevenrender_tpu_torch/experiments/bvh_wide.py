"""The 8-wide collapsed BVH: tables, the CUDA kernel's wrapper, its plain
version.

Port of ``elevenrender_tpu/experiments/bvh_wide.py`` (``wide_levels``,
``pack_bvh_wide``, ``traverse_wide`` and its Pallas ``_kernel``).  The
binary build is unchanged and the tri table is the binary kernel's
(``ops/traverse.pack_tables``'s ``tris``); at pack time three binary
levels collapse into one wide level, so a visit slab-tests 8 boxes and
the walk has a third of the levels.  No render path reaches it
(``trace_mode="pallas_wide"`` renders with the binary kernel, as in the
JAX package); ``sweep_traverse`` measures it beside the binary walk.

``traverse_wide`` launches ``csrc/bvh_wide.cu`` on CUDA tensors or
raises; on CPU tensors, and only there, it runs ``traverse_wide_plain``,
the same walk as lockstep PyTorch, which gives the same ids, bit-equal t
and the same counters.  Closest-hit only, as the TPU kernel.  The kernel
walks one ray per tile of ``WIDE`` lanes, lane e owning child e, with the
ray's stack (``stack_rows``) in shared memory (``shared_bytes`` a block),
on a persistent grid (``ops/traverse.tile_grid``) fed by a work counter.

Tables (``pack_bvh_wide``), the port's layout of the reference's content:
  nodes8 f32 [R, 8, 8]: row of wide node (k, i) at level_offsets[k] + i;
         child e = (bmin.xyz, 0, bmax.xyz, 0), read as 2 float4.  The
         children of (k, i) are the binary nodes three levels down (or
         2^r levels below a remainder root), left to right: wide nodes
         (k + 1, 8 i + e), or leaves at the last level.  A root with
         fewer than 8 children pads with far point boxes (1e30).
  leaf8  i32 [R_last, 16]: row i of the last level = the 8 children's
         tri ranges (from, to) in leaf order, read as 4 int4.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import spans
from ..ops import traverse as traverse_ops
from ..ops.bvh import preorder_indices
from ..ops.traverse import (_check, _fit, _groups_of_8, _leaf_scan,
                            _outputs, _ptr, _slab)

WIDE = 8         # also the lanes of the tile that walks one ray
MAX_LEVELS = 8   # csrc/bvh_wide.cu kMaxLevels: depth <= 24
FAR = 1e30       # the padded children of a short root
_INDEX_BITS = 28
# The wide kernel's scan scratch, per warp: a range table of 32 (start,
# shift) int32 pairs and one 8-byte key for each of its 4 tiles.
SCRATCH = 2 * 32 * 4 + 4 * 8


def wide_levels(depth: int) -> list[int]:
    """Binary depths of the wide levels: [0, r, r+3, ..., D-3] with
    r = D mod 3; the remainder rides at the root, which then has 2^r
    children.  Needs depth >= 3."""
    if depth < 3:
        raise ValueError(f"a wide BVH needs depth >= 3, got {depth}")
    r = depth % 3
    return [0] + list(range(r if r else 3, depth - 2, 3))


def level_offsets(depth: int) -> list[int]:
    """First row of each wide level in ``nodes8``."""
    off = [0]
    for d in wide_levels(depth)[:-1]:
        off.append(off[-1] + (1 << d))
    return off


def root_children(depth: int) -> int:
    levels = wide_levels(depth)
    return 1 << (levels[1] if len(levels) > 1 else depth)


def stack_rows(n_levels: int) -> int:
    """Entries of the wide walk's per-ray stack for a tree of ``n_levels``
    wide levels: 7 a level (the passing children other than the one
    descended into) and the sentinel, with room to spare."""
    return 7 * n_levels + 4


def shared_bytes(n_levels: int) -> int:
    """Dynamic shared memory of one block of the wide kernel: each warp's
    ``SCRATCH``, then one stack of ``stack_rows`` int32 for each of its
    tiles of ``WIDE`` lanes.  Raises where a tree has more wide levels than
    the kernel serves."""
    if not 1 <= n_levels <= MAX_LEVELS:
        raise ValueError(f"{n_levels} wide levels: the kernel serves 1.."
                         f"{MAX_LEVELS}")
    threads = traverse_ops.THREADS
    return threads // 32 * SCRATCH + threads // WIDE * stack_rows(n_levels) * 4


def pack_bvh_wide(bvh: dict) -> dict:
    """Host-side collapse of the flat binary BVH (node_bmin, node_bmax,
    node_from, node_to in preorder, and depth) into the wide tables:
    {"nodes8": f32 [R, 8, 8], "leaf8": i32 [R_last, 16]} as numpy."""
    depth = int(bvh["depth"])
    levels = wide_levels(depth)
    pre = preorder_indices(depth)
    bmin = np.asarray(bvh["node_bmin"], np.float32)
    bmax = np.asarray(bvh["node_bmax"], np.float32)
    sizes = [1 << d for d in levels]
    nodes = np.zeros((sum(sizes), WIDE, 8), np.float32)
    # A point box far away: a slab test passes it only for a ray whose
    # three entry distances coincide; the walk also masks it by index.
    nodes[:, :, 0:3] = FAR
    nodes[:, :, 4:7] = FAR
    off = 0
    for k, d in enumerate(levels):
        below = depth if k == len(levels) - 1 else levels[k + 1]
        fan = 1 << (below - d)
        rows = off + np.arange(sizes[k])
        for c in range(fan):
            idxs = pre[below][np.arange(sizes[k]) * fan + c]
            nodes[rows, c, 0:3] = bmin[idxs]
            nodes[rows, c, 4:7] = bmax[idxs]
        off += sizes[k]
    n_last = sizes[-1]
    fan = 1 << (depth - levels[-1])
    leaf = np.zeros((n_last, 2 * WIDE), np.int32)
    for c in range(fan):
        idxs = pre[depth][np.arange(n_last) * fan + c]
        leaf[:, 2 * c + 0] = np.asarray(bvh["node_from"])[idxs]
        leaf[:, 2 * c + 1] = np.asarray(bvh["node_to"])[idxs]
    return {"nodes8": nodes, "leaf8": leaf}


def traverse_wide(nodes8, leaf8, tris, ray_o, ray_d, depth: int,
                  count_steps: bool = False):
    """Nearest hit of rays [N, 3] by the 8-wide walk: (idx [N] i32, the
    leaf-order tri id or -1; t [N] f32), the binary walk's t bit for bit
    and its ids up to equal-t ties.  ``nodes8``/``leaf8`` from
    ``pack_bvh_wide``; ``tris`` is ``pack_tables``'s.  With
    ``count_steps`` a third result [N, 4] i32 per ray: wide-node visits,
    last-level visits that scanned, 8-aligned slot groups entered, tri
    tests."""
    if ray_o.device.type == "cpu":
        return traverse_wide_plain(nodes8, leaf8, tris, ray_o, ray_d, depth,
                                   count_steps)
    if ray_o.device.type != "cuda":
        raise ValueError(f"traverse_wide: unsupported device {ray_o.device}")
    return _launch(nodes8, leaf8, tris, ray_o, ray_d, depth, count_steps)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from .. import kernels
        lib = kernels.load("bvh_wide")
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.bvh_wide.argtypes = ([p] * 9 + [i, ctypes.POINTER(ctypes.c_int)]
                                 + [i] * 4 + [p])
        lib.bvh_wide.restype = ctypes.c_int
        lib.bvh_wide_blocks_per_sm.argtypes = [i, i, p]
        lib.bvh_wide_blocks_per_sm.restype = ctypes.c_int
        lib.bvh_wide_shared_bytes.argtypes = [i]
        lib.bvh_wide_shared_bytes.restype = ctypes.c_int
        lib.bvh_wide_error_string.argtypes = [ctypes.c_int]
        lib.bvh_wide_error_string.restype = ctypes.c_char_p
        for name in ("max_levels", "threads"):
            getattr(lib, f"bvh_wide_{name}").restype = ctypes.c_int
        c_side = (lib.bvh_wide_max_levels(), lib.bvh_wide_threads())
        want = (MAX_LEVELS, traverse_ops.THREADS)
        if c_side != want:
            raise RuntimeError(f"csrc/bvh_wide.cu (kMaxLevels, kThreads) = "
                               f"{c_side}, experiments/bvh_wide.py expects "
                               f"{want}")
        for m in range(1, MAX_LEVELS + 1):
            if lib.bvh_wide_shared_bytes(m) != shared_bytes(m):
                raise RuntimeError(f"csrc/bvh_wide.cu shared bytes for {m} "
                                   f"levels disagree with shared_bytes")
        _lib = lib
    return _lib


def blocks_per_sm(device, n_levels: int, count_steps: bool = False) -> int:
    """Blocks of the wide kernel that fit on one SM of ``device`` for a
    tree of ``n_levels`` wide levels: the persistent grid's second
    factor."""
    return _fit(_library(), "bvh_wide", torch.device(device),
                int(count_steps), n_levels)[1]


# (data_ptr, version, tri rows) of leaf8 tables already checked.
_checked_leaf8: set = set()


def _check_tables(nodes8, leaf8, tris, depth, dev):
    """Shapes, types and device of the three tables, and (once per leaf8
    table) that every tri range lies in the tri table.  Returns
    (level offsets, root children)."""
    off = level_offsets(depth)
    if len(off) > MAX_LEVELS:
        raise ValueError(f"bvh depth {depth} has {len(off)} wide levels, "
                         f"the kernel serves {MAX_LEVELS}")
    levels = wide_levels(depth)
    rows = off[-1] + (1 << levels[-1])
    _check("nodes8", nodes8, torch.float32, (rows, WIDE, 8), dev)
    _check("leaf8", leaf8, torch.int32, (1 << levels[-1], 2 * WIDE), dev)
    t_rows = tris.shape[0]
    _check("tris", tris, torch.float32, (t_rows, 12), dev)
    key = (leaf8.data_ptr(), leaf8._version, t_rows)
    if key not in _checked_leaf8:
        lo, hi = leaf8[:, 0::2], leaf8[:, 1::2]
        if bool(((lo < 0) | (hi < lo) | (hi > t_rows)).any()):
            raise ValueError(f"leaf8 has a tri range outside [0, {t_rows})")
        _checked_leaf8.add(key)
    return off, root_children(depth)


def _launch(nodes8, leaf8, tris, ray_o, ray_d, depth, count_steps=False):
    dev = ray_o.device
    n = ray_o.shape[0]
    off, n_root = _check_tables(nodes8, leaf8, tris, depth, dev)
    if tris.shape[0] > traverse_ops.MAX_ROWS or n > traverse_ops.MAX_ROWS:
        raise ValueError(f"{tris.shape[0]} tris and {n} rays: the kernel's "
                         f"32-bit indexing serves at most "
                         f"{traverse_ops.MAX_ROWS} of each")
    _check("ray_o", ray_o, torch.float32, (n, 3), dev)
    _check("ray_d", ray_d, torch.float32, (n, 3), dev)
    idx, t, counts = _outputs(n, dev, count_steps)
    work = traverse_ops.work_counter(dev)
    lib = _library()
    with torch.cuda.device(dev):
        grid = traverse_ops.tile_grid(
            n, *_fit(lib, "bvh_wide", dev, int(count_steps), len(off)), WIDE)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bvh_wide(
            nodes8.data_ptr(), leaf8.data_ptr(), tris.data_ptr(),
            ray_o.data_ptr(), ray_d.data_ptr(), idx.data_ptr(), t.data_ptr(),
            _ptr(counts), work.data_ptr(), n,
            (ctypes.c_int * len(off))(*off), len(off), n_root,
            int(count_steps), grid, stream)
    if rc != 0:
        raise RuntimeError("bvh_wide launch failed: "
                           + lib.bvh_wide_error_string(rc).decode())
    if n > 0:
        spans.count("wide_launches")
        traverse_ops.count_variant(("wide", 0, "full", bool(count_steps)))
    if count_steps:
        return idx, t, counts
    return idx, t


def traverse_wide_plain(nodes8, leaf8, tris, ray_o, ray_d, depth: int,
                        count_steps: bool = False):
    """The 8-wide kernel's walk as lockstep PyTorch over the still-active
    rays: a visit slab-tests the node's 8 boxes with the current best_t;
    at the last level every child that passed is scanned, e = 0..7, with
    the running best_t, then the ray pops; elsewhere it descends into
    the passing child of least entry distance (the lowest e on a tie)
    after pushing the others, e = 7 down to 0.  Same ids, bit-equal t
    and the same counters [N, 4] i32 as the kernel."""
    dev = ray_o.device
    n = ray_o.shape[0]
    off_list, n_root = _check_tables(nodes8, leaf8, tris, depth, dev)
    m = len(off_list)
    off = torch.tensor(off_list, dtype=torch.int64, device=dev)
    leaf8 = leaf8.to(torch.int64)
    inv = 1.0 / ray_d
    inf = float("inf")
    best_idx = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_t = torch.full((n,), inf, device=dev)
    # Stack entries (k << 28) | i; entry 0 is the sentinel -1.
    stack = torch.full((n, stack_rows(m)), -1, dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    lev = torch.zeros((n,), dtype=torch.int64, device=dev)
    idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    counts = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    real = torch.arange(WIDE, device=dev) < n_root
    act = torch.arange(n, device=dev)
    while act.numel():
        k, i, s = lev[act], idx[act], sp[act]
        o, iv = ray_o[act], inv[act]
        row = nodes8[off[k] + i]                                   # [m, 8, 8]
        hits, nears = _slab(row[:, :, 0:3], row[:, :, 4:7], o[:, None, :],
                            iv[:, None, :], best_t[act][:, None])
        hits = hits & ((k > 0)[:, None] | real[None, :])
        nears = torch.where(hits, nears, torch.full_like(nears, inf))
        counts[act, 0] += 1
        some = hits.any(dim=1)
        is_last = k == m - 1
        at_leaf = is_last & some
        if bool(at_leaf.any()):
            sel = at_leaf.nonzero()[:, 0]
            ga = act[sel]
            counts[ga, 1] += 1
            lrow = leaf8[i[sel]]
            zero = torch.zeros_like(lrow[:, 0])
            for e in range(WIDE):
                he = hits[sel, e]
                if not bool(he.any()):
                    continue
                lv = torch.stack([lrow[:, 2 * e], lrow[:, 2 * e + 1], zero,
                                  zero], dim=1)
                idx2, t2, _, tested, _ = _leaf_scan(
                    tris, lv, he, torch.zeros_like(he), ray_o[ga], ray_d[ga],
                    best_idx[ga], best_t[ga], None, False)
                best_idx[ga] = idx2
                best_t[ga] = t2
                counts[ga, 2] += _groups_of_8(lv[:, 0], lv[:, 1], he)
                counts[ga, 3] += tested
        desc = some & ~is_last
        # The first least entry distance: strict '<' from e = 0 up.
        e_star = torch.zeros_like(k)
        n_star = nears[:, 0]
        for e in range(1, WIDE):
            better = nears[:, e] < n_star
            e_star = torch.where(better, torch.full_like(e_star, e), e_star)
            n_star = torch.where(better, nears[:, e], n_star)
        child_base = i * WIDE
        for e in range(WIDE - 1, -1, -1):
            push = hits[:, e] & desc & (e_star != e)
            if bool(push.any()):
                stack[act[push], s[push]] = (((k[push] + 1) << _INDEX_BITS)
                                             | (child_base[push] + e))
                s = s + push.to(s.dtype)
        pop = ~desc
        s_pop = torch.clamp(s - 1, min=0)
        popped = stack[act, s_pop]
        sp[act] = torch.where(pop, s_pop, s)
        lev[act] = torch.where(pop, popped >> _INDEX_BITS, k + 1)
        idx[act] = torch.where(pop, popped & ((1 << _INDEX_BITS) - 1),
                               child_base + e_star)
        act = act[~(pop & (popped < 0))]
    out = (best_idx.to(torch.int32), best_t)
    if count_steps:
        return out + (counts.to(torch.int32),)
    return out
