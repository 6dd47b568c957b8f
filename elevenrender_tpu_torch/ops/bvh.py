"""BVH build: binned SAH on the host, in C++ or in vectorized numpy.

The port's copy of ``elevenrender_tpu/ops/bvh.py`` (``build_bvh``,
``default_depth``, ``preorder_indices``), unchanged in its arithmetic so
both packages build the same tree:

- a fixed-depth complete binary tree, leaves only at depth D, preorder
  layout with implicit children (left = idx+1, right = idx + 2^(D-d));
- binned SAH with 14 bins per axis, first-minimum tie-break in
  (axis, bin) order, left iff bin < best bin;
- triangles permuted into leaf order, so a leaf is a contiguous range
  and a hit's tri id is its leaf-order position.

``build_bvh`` runs the port's C++ build (``ops/native.py``, from
``csrc/elevenrt.cpp``) by default, as the JAX package does; it gives the
numpy build's arrays bit for bit, in a fraction of its time.
``use_native=False`` or ``ELEVENRT_NATIVE=0`` runs the numpy build level
by level instead.
"""

from __future__ import annotations

import os

import numpy as np

SAH_BINS = 14  # Definitions.h:14
# Auto depth clamps here, as the JAX package's does, so both packages
# build the same tree for the same scene.
STREAM_MAX_DEPTH = 15


def _bounds_area(bmin, bmax):
    """2*(xy+xz+yz) (BVH.cpp:474-482); negative extents allowed as in ref."""
    d = bmax - bmin
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


def default_depth(tri_count: int) -> int:
    """Adaptive depth targeting ~32 tris per leaf, clamped to
    [1, STREAM_MAX_DEPTH] exactly as the JAX package clamps it."""
    if tri_count <= 4:
        return 1
    return int(np.clip(np.ceil(np.log2(tri_count / 32.0)), 1,
                       STREAM_MAX_DEPTH))


def preorder_indices(depth: int) -> list[np.ndarray]:
    """Preorder index of each node per level for a complete tree.

    level d has 2^d nodes in left-to-right order; children of preorder
    node idx at depth d are idx+1 and idx + 2^(D-d) (BVH.cpp:122-130).
    """
    idx = [np.zeros(1, np.int64)]
    for d in range(1, depth + 1):
        parent = idx[d - 1]
        child = np.empty(1 << d, np.int64)
        child[0::2] = parent + 1
        child[1::2] = parent + (1 << (depth - (d - 1)))
        idx.append(child)
    return idx


def build_bvh(tri_verts: np.ndarray, depth: int | None = None,
              use_native: bool | None = None) -> dict:
    """Build the flat BVH arrays.

    tri_verts: [T, 3, 3] float32.  Returns a dict of numpy arrays:
      node_bmin/node_bmax [NN,3] f32, node_from/node_to [NN] i32,
      perm [T] i32 (leaf-order permutation of the input tris),
      depth (python int), max_leaf (python int).

    ``use_native`` (default: unless ``ELEVENRT_NATIVE=0``) runs the C++
    build, which raises if the host library cannot be built; an empty
    mesh always takes the numpy path.
    """
    T = tri_verts.shape[0]
    if depth is None:
        depth = default_depth(T)
    if use_native is None:
        use_native = os.environ.get("ELEVENRT_NATIVE", "1") != "0"
    if use_native and T > 0:
        from .native import build_bvh_native
        return build_bvh_native(np.asarray(tri_verts, np.float32), depth)
    D = depth
    NN = (1 << (D + 1)) - 1

    node_bmin = np.zeros((NN, 3), np.float32)
    node_bmax = np.zeros((NN, 3), np.float32)
    node_from = np.zeros(NN, np.int32)
    node_to = np.zeros(NN, np.int32)

    if T == 0:
        return dict(node_bmin=node_bmin, node_bmax=node_bmax,
                    node_from=node_from, node_to=node_to,
                    perm=np.zeros(0, np.int32), depth=D, max_leaf=1)

    tbmin = tri_verts.min(axis=1)  # [T,3]
    tbmax = tri_verts.max(axis=1)
    cent = ((tri_verts[:, 0] + tri_verts[:, 1] + tri_verts[:, 2]) / 3.0)

    pre = preorder_indices(D)

    perm = np.arange(T, dtype=np.int64)
    # Node id (within level) of each tri; tris stay sorted by node id.
    node_of = np.zeros(T, np.int64)
    # Segment offsets for the current level: starts[n] .. starts[n+1].
    starts = np.array([0, T], np.int64)

    for d in range(D + 1):
        n_nodes = 1 << d
        counts = starts[1:] - starts[:-1]
        nonempty = counts > 0

        # Vertex bounds per node (empty -> zeros, matching the reference's
        # default-constructed Vector3 bounds).
        bmin = np.zeros((n_nodes, 3), np.float64)
        bmax = np.zeros((n_nodes, 3), np.float64)
        if nonempty.any():
            pmin = tbmin[perm]
            pmax = tbmax[perm]
            acc_min = np.full((n_nodes, 3), np.inf)
            acc_max = np.full((n_nodes, 3), -np.inf)
            np.minimum.at(acc_min, node_of, pmin)
            np.maximum.at(acc_max, node_of, pmax)
            bmin[nonempty] = acc_min[nonempty]
            bmax[nonempty] = acc_max[nonempty]

        node_bmin[pre[d]] = bmin.astype(np.float32)
        node_bmax[pre[d]] = bmax.astype(np.float32)

        if d == D:
            # Leaves: contiguous ranges in the permuted order.
            node_from[pre[d]] = starts[:-1].astype(np.int32)
            node_to[pre[d]] = starts[1:].astype(np.int32)
            break

        # --- binned SAH over 3 axes x SAH_BINS (BVH.cpp:327-415) ---------
        c = cent[perm]                    # [t,3]
        b1 = bmin[node_of]                # per-tri node bounds
        b2 = bmax[node_of]
        ext = b2 - b1
        with np.errstate(divide="ignore", invalid="ignore"):
            rel = (c - b1) / ext
        rel = np.where(ext != 0.0, rel, 0.0)   # guard at BVH.cpp:362
        bins = np.clip((rel * (SAH_BINS - 1)).astype(np.int64), 0, SAH_BINS - 1)

        best_heur = np.full(n_nodes, np.inf)
        best_axis = np.zeros(n_nodes, np.int64)
        best_bin = np.zeros(n_nodes, np.int64)

        for axis in range(3):
            key = node_of * SAH_BINS + bins[:, axis]
            cnt = np.bincount(key, minlength=n_nodes * SAH_BINS)
            cnt = cnt.reshape(n_nodes, SAH_BINS)
            bin_min = np.full((n_nodes * SAH_BINS, 3), np.inf)
            bin_max = np.full((n_nodes * SAH_BINS, 3), -np.inf)
            np.minimum.at(bin_min, key, tbmin[perm])
            np.maximum.at(bin_max, key, tbmax[perm])
            bin_min = bin_min.reshape(n_nodes, SAH_BINS, 3)
            bin_max = bin_max.reshape(n_nodes, SAH_BINS, 3)
            # Reference union skips "empty" operands (area <= 0,
            # BVH.cpp:447-460); an unfilled bin here is +-inf which we
            # replace by the zero bounds the reference would keep.
            empty_bin = cnt == 0
            bin_min[empty_bin] = 0.0
            bin_max[empty_bin] = 0.0
            bin_area = _bounds_area(bin_min, bin_max)
            bin_empty = bin_area <= 0.0  # includes degenerate flat bins

            # Prefix/suffix folds of (bounds union, count) over bins with
            # the reference's empty-skip semantics.
            def sweep(idx_order):
                accs_min = np.zeros((n_nodes, SAH_BINS + 1, 3))
                accs_max = np.zeros((n_nodes, SAH_BINS + 1, 3))
                acc_min = np.zeros((n_nodes, 3))
                acc_max = np.zeros((n_nodes, 3))
                acc_empty = np.ones(n_nodes, bool)
                for k, j in enumerate(idx_order):
                    accs_min[:, k] = acc_min
                    accs_max[:, k] = acc_max
                    take_bin = ~bin_empty[:, j]
                    use_bin = take_bin & acc_empty
                    both = take_bin & ~acc_empty
                    acc_min = np.where(use_bin[:, None], bin_min[:, j],
                                       np.where(both[:, None],
                                                np.minimum(acc_min, bin_min[:, j]),
                                                acc_min))
                    acc_max = np.where(use_bin[:, None], bin_max[:, j],
                                       np.where(both[:, None],
                                                np.maximum(acc_max, bin_max[:, j]),
                                                acc_max))
                    acc_empty = acc_empty & ~take_bin
                accs_min[:, SAH_BINS] = acc_min
                accs_max[:, SAH_BINS] = acc_max
                return accs_min, accs_max

            pref_min, pref_max = sweep(range(SAH_BINS))
            suff_min_r, suff_max_r = sweep(range(SAH_BINS - 1, -1, -1))
            # suffix fold k steps from the right == union of bins [S-k, S)
            cum = np.cumsum(cnt, axis=1)
            for i in range(SAH_BINS):
                count1 = cum[:, i - 1] if i > 0 else np.zeros(n_nodes, np.int64)
                count2 = cum[:, -1] - count1
                area1 = _bounds_area(pref_min[:, i], pref_max[:, i])
                area2 = _bounds_area(suff_min_r[:, SAH_BINS - i],
                                     suff_max_r[:, SAH_BINS - i])
                heur = area1 * count1 + area2 * count2
                upd = heur < best_heur
                best_heur = np.where(upd, heur, best_heur)
                best_axis = np.where(upd, axis, best_axis)
                best_bin = np.where(upd, i, best_bin)

        # --- partition (BVH.cpp:402-414): left iff bin < bestBin ---------
        tri_bin = bins[np.arange(len(perm)), best_axis[node_of]]
        go_left = tri_bin < best_bin[node_of]
        child = node_of * 2 + (~go_left).astype(np.int64)
        order = np.argsort(child, kind="stable")
        perm = perm[order]
        node_of = child[order]
        new_counts = np.bincount(child, minlength=2 * n_nodes)
        starts = np.concatenate([[0], np.cumsum(new_counts)])

    max_leaf = int((starts[1:] - starts[:-1]).max()) if T else 1
    return dict(node_bmin=node_bmin, node_bmax=node_bmax,
                node_from=node_from, node_to=node_to,
                perm=perm.astype(np.int32), depth=D,
                max_leaf=max(max_leaf, 1))
