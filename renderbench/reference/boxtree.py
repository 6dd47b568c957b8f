"""Ray casting of the plain reference: a breadth-first walk of a wide box
tree, with no stack, no order and no pruning by distance.

The triangles are sorted by the Morton code of their centroids and cut
into leaves of ``LEAF`` slots; every ``FAN`` boxes of one level are
bounded by one box of the next.  A query tests every (ray, box) pair of
a level, keeps the pairs whose box the ray meets, and expands them into
the boxes below, down to the triangles.  Every box is padded, so
rounding in the slab test never drops a triangle the ray meets; the
answer depends only on the triangle test, which is the port's
Möller-Trumbore formula (``ops/traverse.py:_mt``, from the vertex and
the two edges in float32) op for op.  Closest hit: the least t of every
triangle met, the least triangle id on an exact tie.  Any hit: some
triangle other than the excluded one met at t below ``t_max``.
Triangle ids are the caller's (the mesh order).
"""

from __future__ import annotations

import numpy as np
import torch

LEAF = 16
FAN = 16
PAD = 1e-4
# (ray, box) pairs expanded at once: bounds the temporaries of a step.
PAIRS = 1 << 20


def _morton(c: np.ndarray) -> np.ndarray:
    lo, hi = c.min(axis=0), c.max(axis=0)
    g = ((c - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.uint64)
    code = np.zeros(len(c), np.uint64)
    for bit in range(10):
        for axis in range(3):
            code |= ((g[:, axis] >> np.uint64(bit)) & np.uint64(1)) << \
                np.uint64(3 * bit + axis)
    return code


class BoxTree:
    def __init__(self, verts, device, q=None):
        """``verts`` [T, 3, 3] float32 (numpy); ``q`` rounds the float
        tables (the control's lower precision), or None."""
        q = q or (lambda x: x)
        verts = np.asarray(verts, np.float32)
        order = np.argsort(_morton(verts.mean(axis=1)), kind="stable")
        n = len(order)
        slots = -(-n // LEAF) * LEAF
        ids = np.full(slots, -1, np.int64)
        ids[:n] = order
        v = verts[order]
        v0 = np.zeros((slots, 3), np.float32)
        e1 = np.zeros((slots, 3), np.float32)
        e2 = np.zeros((slots, 3), np.float32)
        v0[:n] = v[:, 0]
        e1[:n] = v[:, 1] - v[:, 0]
        e2[:n] = v[:, 2] - v[:, 0]
        lo = np.full((slots, 3), np.inf, np.float32)
        hi = np.full((slots, 3), -np.inf, np.float32)
        lo[:n] = v.min(axis=1)
        hi[:n] = v.max(axis=1)
        # Level 0 holds the leaves' boxes; each level is padded to whole
        # groups of FAN with boxes marked invalid, which no ray meets.
        lo = lo.reshape(-1, LEAF, 3).min(axis=1)
        hi = hi.reshape(-1, LEAF, 3).max(axis=1)
        valid = np.ones(len(lo), bool)
        levels = []
        while True:
            if len(lo) <= FAN:
                levels.append((lo, hi, valid))
                break
            m = -(-len(lo) // FAN) * FAN
            lo = np.concatenate([lo, np.full((m - len(lo), 3), np.inf,
                                             np.float32)])
            hi = np.concatenate([hi, np.full((m - len(hi), 3), -np.inf,
                                             np.float32)])
            valid = np.concatenate([valid, np.zeros(m - len(valid), bool)])
            levels.append((lo, hi, valid))
            lo = lo.reshape(-1, FAN, 3).min(axis=1)
            hi = hi.reshape(-1, FAN, 3).max(axis=1)
            valid = valid.reshape(-1, FAN).any(axis=1)
        total = len(levels[0][0]) * LEAF
        ids = np.concatenate([ids, np.full(total - slots, -1, np.int64)])
        tri = np.zeros((total, 9), np.float32)
        tri[:slots] = np.concatenate([v0, e1, e2], axis=1)
        dev = torch.device(device)

        def box(a, pad):
            a = np.where(np.isfinite(a), a + pad, 0.0).astype(np.float32)
            return torch.tensor(a, device=dev)

        self.levels = [(box(a, -PAD), box(b, PAD), torch.tensor(c, device=dev))
                       for a, b, c in levels]
        self.ids = torch.tensor(ids, device=dev)
        self.tri = q(torch.tensor(tri, device=dev))

    def _hits(self, o, d, rays):
        """Every (ray, slot, t) with a triangle test that passes, for the
        rays ``rays`` (int64 ids into o and d)."""
        dev = o.device
        safe = torch.where(d.abs() < 1e-20,
                           torch.where(d < 0, -1e-20, 1e-20), d)
        inv = 1.0 / safe
        top = self.levels[-1][0].shape[0]
        r = rays.repeat_interleave(top)
        b = torch.arange(top, device=dev).repeat(rays.numel())
        found = []
        stack = [(len(self.levels) - 1, r, b)]
        while stack:
            level, r, b = stack.pop()
            if r.numel() > PAIRS:
                for s in range(0, r.numel(), PAIRS):
                    stack.append((level, r[s:s + PAIRS], b[s:s + PAIRS]))
                continue
            lo, hi, valid = self.levels[level]
            oo, ii = o[r], inv[r]
            t1 = (lo[b] - oo) * ii
            t2 = (hi[b] - oo) * ii
            tmin = torch.minimum(t1, t2).amax(dim=1)
            tmax = torch.maximum(t1, t2).amin(dim=1)
            keep = (tmax >= 0.0) & (tmin <= tmax) & valid[b]
            r, b = r[keep], b[keep]
            if not r.numel():
                continue
            width = FAN if level else LEAF
            r = r.repeat_interleave(width)
            b = (b[:, None] * width
                 + torch.arange(width, device=dev)[None, :]).reshape(-1)
            if level:
                stack.append((level - 1, r, b))
                continue
            for s in range(0, r.numel(), PAIRS * 4):
                rs, bs = r[s:s + PAIRS * 4], b[s:s + PAIRS * 4]
                ok, t = _mt(self.tri[bs], o[rs], d[rs])
                found.append((rs[ok], bs[ok], t[ok]))
        if not found:
            e = torch.zeros(0, dtype=torch.int64, device=dev)
            return e, e, torch.zeros(0, device=dev)
        return tuple(torch.cat(x) for x in zip(*found))

    def closest(self, o, d, active):
        """Closest-hit triangle id per ray (-1: a miss or an inactive
        ray)."""
        n = o.shape[0]
        dev = o.device
        r, slot, t = self._hits(o, d, active.nonzero()[:, 0])
        best_t = torch.full((n,), float("inf"), device=dev)
        best_t = best_t.scatter_reduce(0, r, t, "amin")
        tid = self.ids[slot]
        top = t == best_t[r]
        big = torch.iinfo(torch.int64).max
        idx = torch.full((n,), big, dtype=torch.int64, device=dev)
        idx = idx.scatter_reduce(0, r[top], tid[top], "amin")
        return torch.where(idx == big, torch.full_like(idx, -1), idx)

    def occluded(self, o, d, active, exclude, t_max):
        """Whether some triangle other than ``exclude`` lies on the ray
        below ``t_max`` (False for inactive rays)."""
        r, slot, t = self._hits(o, d, active.nonzero()[:, 0])
        good = (self.ids[slot] != exclude[r]) & (t < t_max[r])
        out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        return out.index_fill(0, r[good], True)


def _mt(tri, o, d):
    """The port's Möller-Trumbore, op for op: tri [..., 9] = (v0, e1, e2).
    Returns (passes, t)."""
    v0x, v0y, v0z = tri[..., 0], tri[..., 1], tri[..., 2]
    e1x, e1y, e1z = tri[..., 3], tri[..., 4], tri[..., 5]
    e2x, e2y, e2z = tri[..., 6], tri[..., 7], tri[..., 8]
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
