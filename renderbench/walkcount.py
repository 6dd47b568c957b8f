"""The yardstick of ``traverse_roofline_pct``: what these rays and this
scene need of a plain binary walk, counted by the benchmark itself.

The tree is a binned-SAH binary tree over the triangles (``sah_tree``):
a frozen copy, as of the benchmark's first version, of the arithmetic of
the port's numpy build (``elevenrender_tpu_torch/ops/bvh.py``,
``build_bvh(use_native=False)`` and ``default_depth``: a complete tree
of fixed depth, about 32 triangles a leaf, 14 bins an axis, the first
least cost in (axis, bin) order, left iff bin < best bin), run level by
level in torch on the rays' device.  It is walked nearer child first,
pruned by the best distance so far (closest hit) or stopped at the
first triangle met below ``t_max`` other than the excluded one (any
hit): per ray the interior nodes visited (each tests two child boxes),
the leaves scanned and the triangles tested.  The rays are those a
sample casts (``rays_of_a_sample``: the reference's own sample over
every ``STRIDE``-th pixel each way, its path rays while alive and its
shadow rays where the next-event estimate needs them).  The counts come
from the scene and the rays alone, so they stay the same whatever
kernel implements the walk.

Frozen copies, as of the benchmark's first version, of the arithmetic in
``elevenrender_tpu_torch/sweep_traverse.py`` (``bound_of``: fp32
operations of a slab test and of a triangle test, the tables read once
plus rays in and results out) and of the H100's peaks in
``sweep_traverse.py`` and ``chip_smoke.py`` (NVIDIA's data sheet, SXM,
at the full 700 W).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.boxtree import _mt

FP32_PEAK = 67e12      # FLOP/s outside the tensor cores
HBM_RATE = 3.35e12     # bytes/s
OPS_PER_SLAB = 25      # 6 sub, 6 mul, 10 min/max, 3 compares
OPS_PER_VISIT = 2 * OPS_PER_SLAB
OPS_PER_TEST = 55      # 46 arithmetic ops, 9 compares
SAH_BINS = 14
MAX_DEPTH = 15
STRIDE = 8             # counted rays: every STRIDE-th pixel each way


def depth_of(tri_count: int) -> int:
    """About 32 triangles a leaf, depth 1 to ``MAX_DEPTH``."""
    if tri_count <= 4:
        return 1
    return int(np.clip(np.ceil(np.log2(tri_count / 32.0)), 1, MAX_DEPTH))


def _area(lo, hi):
    d = hi - lo
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


def _fold(bin_lo, bin_hi, bin_empty, order):
    """Running unions of the bins in ``order`` (empty bins skipped): slot
    k holds the union of the first k bins, slot ``SAH_BINS`` of all."""
    n = bin_lo.shape[0]
    dev = bin_lo.device
    lo_k = torch.zeros((n, SAH_BINS + 1, 3), dtype=bin_lo.dtype, device=dev)
    hi_k = torch.zeros_like(lo_k)
    lo = torch.zeros((n, 3), dtype=bin_lo.dtype, device=dev)
    hi = torch.zeros_like(lo)
    empty = torch.ones(n, dtype=torch.bool, device=dev)
    for k, j in enumerate(order):
        lo_k[:, k] = lo
        hi_k[:, k] = hi
        take = ~bin_empty[:, j]
        first = (take & empty)[:, None]
        both = (take & ~empty)[:, None]
        lo = torch.where(first, bin_lo[:, j],
                         torch.where(both, torch.minimum(lo, bin_lo[:, j]),
                                     lo))
        hi = torch.where(first, bin_hi[:, j],
                         torch.where(both, torch.maximum(hi, bin_hi[:, j]),
                                     hi))
        empty = empty & ~take
    lo_k[:, SAH_BINS] = lo
    hi_k[:, SAH_BINS] = hi
    return lo_k, hi_k


def _scatter(n, key, values, how):
    fill = float("inf") if how == "amin" else float("-inf")
    out = torch.full((n, 3), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, key[:, None].expand(-1, 3), values, how)


def sah_tree(verts, device) -> dict:
    """The binned-SAH tree of ``verts`` [T, 3, 3] (float32) on
    ``device``: heap-ordered boxes ``lo`` / ``hi`` [2^(D+1) - 1, 3]
    (float32; an empty node's box is met by no ray), the leaves' ranges
    ``starts`` [2^D + 1] into the triangle table ``tri`` [T, 9] (vertex
    and two edges, in leaf order), each row's triangle id ``ids``, and
    the depth ``depth``."""
    v = torch.as_tensor(np.asarray(verts, np.float32), device=device)
    n_tri = v.shape[0]
    depth = depth_of(n_tri)
    f64 = torch.float64
    tb_lo = v.amin(dim=1)
    tb_hi = v.amax(dim=1)
    cent = (v[:, 0] + v[:, 1] + v[:, 2]) / 3.0
    perm = torch.arange(n_tri, device=device)
    node_of = torch.zeros(n_tri, dtype=torch.int64, device=device)
    starts = torch.tensor([0, n_tri], dtype=torch.int64, device=device)
    levels = []
    for d in range(depth + 1):
        n_nodes = 1 << d
        nonempty = (starts[1:] - starts[:-1]) > 0
        p_lo, p_hi = tb_lo[perm].to(f64), tb_hi[perm].to(f64)
        b_lo = torch.where(nonempty[:, None], _scatter(n_nodes, node_of, p_lo,
                                                       "amin"), 0.0)
        b_hi = torch.where(nonempty[:, None], _scatter(n_nodes, node_of, p_hi,
                                                       "amax"), 0.0)
        inf = torch.full_like(b_lo, float("inf"))
        levels.append((torch.where(nonempty[:, None], b_lo, inf).float(),
                       torch.where(nonempty[:, None], b_hi, -inf).float()))
        if d == depth:
            break
        c = cent[perm].to(f64)
        lo1, hi1 = b_lo[node_of], b_hi[node_of]
        ext = hi1 - lo1
        rel = torch.where(ext != 0.0, (c - lo1) / ext,
                          torch.zeros_like(ext))
        bins = (rel * (SAH_BINS - 1)).to(torch.int64).clamp(0, SAH_BINS - 1)
        best_cost = torch.full((n_nodes,), float("inf"), dtype=f64,
                               device=device)
        best_axis = torch.zeros(n_nodes, dtype=torch.int64, device=device)
        best_bin = torch.zeros(n_nodes, dtype=torch.int64, device=device)
        for axis in range(3):
            key = node_of * SAH_BINS + bins[:, axis]
            cnt = torch.bincount(key, minlength=n_nodes * SAH_BINS)
            none = (cnt == 0)[:, None]
            bin_lo = torch.where(none, 0.0, _scatter(n_nodes * SAH_BINS, key,
                                                     p_lo, "amin"))
            bin_hi = torch.where(none, 0.0, _scatter(n_nodes * SAH_BINS, key,
                                                     p_hi, "amax"))
            bin_lo = bin_lo.reshape(n_nodes, SAH_BINS, 3)
            bin_hi = bin_hi.reshape(n_nodes, SAH_BINS, 3)
            bin_empty = _area(bin_lo, bin_hi) <= 0.0
            pre_lo, pre_hi = _fold(bin_lo, bin_hi, bin_empty,
                                   range(SAH_BINS))
            suf_lo, suf_hi = _fold(bin_lo, bin_hi, bin_empty,
                                   range(SAH_BINS - 1, -1, -1))
            cum = torch.cumsum(cnt.reshape(n_nodes, SAH_BINS), dim=1)
            for i in range(SAH_BINS):
                n1 = (cum[:, i - 1] if i > 0
                      else torch.zeros_like(cum[:, 0])).to(f64)
                n2 = cum[:, -1].to(f64) - n1
                cost = (_area(pre_lo[:, i], pre_hi[:, i]) * n1
                        + _area(suf_lo[:, SAH_BINS - i],
                                suf_hi[:, SAH_BINS - i]) * n2)
                better = cost < best_cost
                best_cost = torch.where(better, cost, best_cost)
                best_axis = torch.where(better, axis, best_axis)
                best_bin = torch.where(better, i, best_bin)
        tri_bin = bins[torch.arange(n_tri, device=device),
                       best_axis[node_of]]
        child = node_of * 2 + (tri_bin >= best_bin[node_of]).long()
        order = torch.sort(child, stable=True).indices
        perm = perm[order]
        node_of = child[order]
        starts = torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                            torch.cumsum(torch.bincount(
                                child, minlength=2 * n_nodes), 0)])
    w = v[perm]
    return {"lo": torch.cat([lo for lo, _ in levels]),
            "hi": torch.cat([hi for _, hi in levels]),
            "starts": starts, "depth": depth, "ids": perm,
            "tri": torch.cat([w[:, 0], w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]],
                             dim=1)}


def count(tree, o, d, exclude=None, t_max=None) -> dict:
    """Interior-node visits, leaves scanned and triangle tests, summed
    over the rays (o, d) [R, 3] (float32 tensors on the tree's device) of
    the walk of ``tree`` (``sah_tree``): closest hit, or any hit with
    ``exclude`` (triangle ids) and ``t_max``; the tables' bytes; and what
    the walk found (``hit``: each ray's closest t, or whether it is
    occluded)."""
    lo, hi, tri = tree["lo"], tree["hi"], tree["tri"]
    starts, ids, depth = tree["starts"], tree["ids"], tree["depth"]
    dev = o.device
    any_hit = exclude is not None
    first_leaf = (1 << depth) - 1
    n = o.shape[0]
    safe = torch.where(d.abs() < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    inv = 1.0 / safe
    best = (t_max.clone() if any_hit
            else torch.full((n,), float("inf"), device=dev))
    found = torch.zeros((n,), dtype=torch.bool, device=dev)
    stack = torch.zeros((n, depth + 2), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    visits = torch.zeros((n,), dtype=torch.int64, device=dev)
    leaves = torch.zeros((n,), dtype=torch.int64, device=dev)
    tests = torch.zeros((n,), dtype=torch.int64, device=dev)
    act = torch.arange(n, device=dev)

    def slab(node, oo, ii, bt):
        t1 = (lo[node] - oo) * ii
        t2 = (hi[node] - oo) * ii
        tmin = torch.minimum(t1, t2).amax(dim=1)
        tmax = torch.maximum(t1, t2).amin(dim=1)
        ok = torch.isfinite(lo[node]).all(dim=1)
        hit = ok & (tmax >= 0.0) & (tmin <= tmax) & (tmin < bt)
        return hit, tmin

    def scan(rays, leaf):
        """Tests every triangle of each ray's leaf."""
        first = starts[leaf]
        size = starts[leaf + 1] - first
        leaves[rays] += 1
        tests[rays] += size
        pair = torch.repeat_interleave(torch.arange(rays.numel(),
                                                    device=dev), size)
        if not pair.numel():
            return
        offset = torch.cumsum(size, 0) - size
        row = first[pair] + torch.arange(pair.numel(), device=dev) \
            - offset[pair]
        r = rays[pair]
        ok, t = _mt(tri[row], o[r], d[r])
        ok = ok & (t < best[r])
        if any_hit:
            ok = ok & (ids[row] != exclude[r])
            found.index_fill_(0, r[ok], True)
            return
        tm = torch.where(ok, t, torch.full_like(t, float("inf")))
        best.scatter_reduce_(0, r, tm, "amin")

    while act.numel():
        top = sp[act] - 1
        node = stack[act, top]
        sp[act] = top
        oo, ii, bt = o[act], inv[act], best[act]
        visits[act] += 1
        kids = torch.stack([2 * node + 1, 2 * node + 2], dim=1)
        hits, near = [], []
        for k in range(2):
            h, t = slab(kids[:, k], oo, ii, bt)
            hits.append(h)
            near.append(t)
        leafy = kids[:, 0] >= first_leaf
        for k in range(2):
            hit = hits[k] & leafy
            if bool(hit.any()):
                scan(act[hit], kids[hit, k] - first_leaf)
        inner = ~leafy
        both = inner & hits[0] & hits[1]
        l_first = near[0] <= near[1]
        first = torch.where(l_first, kids[:, 0], kids[:, 1])
        second = torch.where(l_first, kids[:, 1], kids[:, 0])
        s = sp[act]
        one = inner & (hits[0] ^ hits[1])
        only = torch.where(hits[0], kids[:, 0], kids[:, 1])
        # Push the farther child under the nearer one.
        if bool(both.any()):
            stack[act[both], s[both]] = second[both]
            stack[act[both], s[both] + 1] = first[both]
            sp[act[both]] = s[both] + 2
        if bool(one.any()):
            stack[act[one], s[one]] = only[one]
            sp[act[one]] = s[one] + 1
        act = act[(sp[act] > 0) & ~found[act]]
    return {"rays": n, "visits": int(visits.sum()),
            "leaves": int(leaves.sum()), "tests": int(tests.sum()),
            "table_bytes": lo.shape[0] * 24 + tri.shape[0] * 36,
            "hit": found if any_hit else best}


def least_seconds(closest: dict, any_hit: dict, scale: float,
                  launches: int) -> dict:
    """The least time of a sample's traversal launches, from the walks
    of its closest-hit and any-hit rays (``count``) over a share
    1/``scale`` of its pixels: fp32 operations over the peak, or the
    tables read once a launch plus rays in (24 B) and results out (8 B;
    8 more per any-hit ray) over the memory rate; the larger of the
    two."""
    visits = (closest["visits"] + any_hit["visits"]) * scale
    tests = (closest["tests"] + any_hit["tests"]) * scale
    rays = (closest["rays"] + any_hit["rays"]) * scale
    ops = visits * OPS_PER_VISIT + tests * OPS_PER_TEST
    nbytes = (launches * closest["table_bytes"] + rays * 32
              + any_hit["rays"] * scale * 8)
    return {"seconds": max(ops / FP32_PEAK, nbytes / HBM_RATE),
            "by": "operations" if ops / FP32_PEAK >= nbytes / HBM_RATE
            else "bytes", "ops": ops, "bytes": nbytes}


class _Recorder:
    """Stands for the reference's ``BoxTree`` and keeps every query's
    rays before answering it."""

    def __init__(self, boxes):
        self.boxes = boxes
        self.closest_rays, self.any_rays = [], []

    def closest(self, o, d, active):
        self.closest_rays.append((o[active], d[active]))
        return self.boxes.closest(o, d, active)

    def occluded(self, o, d, active, exclude, t_max):
        self.any_rays.append((o[active], d[active], exclude[active],
                              t_max[active]))
        return self.boxes.occluded(o, d, active, exclude, t_max)


def rays_of_a_sample(raw: dict, device) -> tuple:
    """(the closest-hit rays (o, d), the any-hit rays (o, d, exclude,
    t_max), the pixels' share of the image) that the reference casts in
    the first sample of every ``STRIDE``-th pixel each way."""
    from .reference import render
    ref = render.prepare(raw, device)
    rec = _Recorder(ref["boxes"])
    ref["boxes"] = rec
    x_res, y_res = raw["x_res"], raw["y_res"]
    ys, xs = torch.meshgrid(torch.arange(0, y_res, STRIDE, device=device),
                            torch.arange(0, x_res, STRIDE, device=device),
                            indexing="ij")
    pix = (ys * x_res + xs).reshape(-1)
    with torch.no_grad():
        render.sample_radiance(ref, render.init_rng(pix), pix)
    closest = tuple(torch.cat(x) for x in zip(*rec.closest_rays))
    any_hit = tuple(torch.cat(x) for x in zip(*rec.any_rays))
    return closest, any_hit, x_res * y_res / pix.numel()
