"""MikkTSpace-equivalent tangent generation, vectorized numpy.

The port's copy of ``elevenrender_tpu/scene/tangents.py``, unchanged in
its arithmetic: per-face signed-UV tangents, corners welded on exact
(position, normal, uv) and split by face orientation, angle-weighted
normal-projected accumulation, degenerate-face fixups, and a per-face
handedness sign.  Only its grouping is faster: ``_weld``, a hash sort in
place of a sort of 8-field records (the same groups), and the groups'
sums by ``np.bincount`` in place of ``np.add.at`` (the same order of
additions).
"""

from __future__ import annotations

import numpy as np


def _normalize_rows(a, eps=1e-20):
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.maximum(n, eps), n[..., 0]


# The weld hash's multiplier (2^64 over the golden ratio, odd).
_HASH_MUL = np.uint64(0x9E3779B97F4A7C15)


def _weld(key: np.ndarray) -> np.ndarray:
    """One label per distinct row of ``key`` [N, k] float64, rows equal by
    value (-0.0 and 0.0 alike).  Rows are grouped by a 64-bit hash of
    their bits, one sort of N integers; if two different rows share a
    hash (or a NaN), the exact sort of the rows decides.  Only which rows
    share a label matters to the caller (each group's sum runs in row
    order), so the labels need not be the sort's."""
    bits = np.ascontiguousarray(key + 0.0).view(np.uint64)  # -0.0 -> 0.0
    h = np.zeros(len(bits), np.uint64)
    for col in bits.T:
        h ^= col
        h *= _HASH_MUL
        h ^= h >> np.uint64(29)
    _, first, weld = np.unique(h, return_index=True, return_inverse=True)
    weld = weld.reshape(-1)
    if np.array_equal(key[first][weld], key):
        return weld
    keyv = np.ascontiguousarray(key).view([('', key.dtype)] * key.shape[1])
    return np.unique(keyv, return_inverse=True)[1].reshape(-1)


def compute_tangents(verts: np.ndarray, uvs: np.ndarray,
                     normals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """verts [T,3,3], uvs [T,3,2], normals [T,3,3] ->
    (tangents [T,3,3] per corner, signs [T] per face)."""
    T = verts.shape[0]
    if T == 0:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0,), np.float32)

    verts = np.asarray(verts, np.float64)
    uvs = np.asarray(uvs, np.float64)
    normals = np.asarray(normals, np.float64)

    # ---- 1. per-face signed-division tangent (+u direction) -------------
    e1 = verts[:, 1] - verts[:, 0]          # [T,3]
    e2 = verts[:, 2] - verts[:, 0]
    du1 = uvs[:, 1, 0] - uvs[:, 0, 0]
    dv1 = uvs[:, 1, 1] - uvs[:, 0, 1]
    du2 = uvs[:, 2, 0] - uvs[:, 0, 0]
    dv2 = uvs[:, 2, 1] - uvs[:, 0, 1]
    det = du1 * dv2 - du2 * dv1             # signed UV area x2

    fn = np.cross(e1, e2)
    pos_area = np.linalg.norm(fn, axis=-1)
    degenerate = (np.abs(det) < 1e-25) | (pos_area < 1e-25)
    orient = det >= 0.0                     # ORIENT_PRESERVING

    r = 1.0 / np.where(degenerate, 1.0, det)
    face_tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]  # [T,3]

    # ---- 2. weld corners, split groups by orientation --------------------
    weld = _weld(np.concatenate([verts.reshape(-1, 3),
                                 normals.reshape(-1, 3),
                                 uvs.reshape(-1, 2)], axis=1))   # [T*3]
    group = weld * 2 + np.repeat(orient, 3).astype(np.int64)

    # ---- 3. angle-weighted, normal-projected accumulation ----------------
    # Interior angle at each corner: between the two emanating edges.
    nxt = verts[:, [1, 2, 0], :] - verts                  # [T,3c,3]
    prv = verts[:, [2, 0, 1], :] - verts
    nxt_n, _ = _normalize_rows(nxt)
    prv_n, _ = _normalize_rows(prv)
    cosang = np.clip(np.sum(nxt_n * prv_n, axis=-1), -1.0, 1.0)
    angle = np.arccos(cosang)                             # [T,3c]

    # Project the face tangent onto each corner's normal plane, normalize.
    ft = np.repeat(face_tan[:, None, :], 3, axis=1)       # [T,3c,3]
    proj = ft - normals * np.sum(ft * normals, axis=-1, keepdims=True)
    proj_n, proj_len = _normalize_rows(proj)
    ok = (~degenerate)[:, None] & (proj_len > 1e-20)      # [T,3c]

    w = np.where(ok, angle, 0.0).reshape(-1)              # [T*3]
    contrib = proj_n.reshape(-1, 3) * w[:, None]

    n_groups = int(group.max()) + 1 if group.size else 1
    # Each group's sum in corner order, as ``np.add.at`` adds (the JAX
    # package's form), one component at a time.
    acc = np.stack([np.bincount(group, contrib[:, k], n_groups)
                    for k in range(3)], axis=1)

    corner_tan = acc[group].reshape(T, 3, 3)
    corner_len = np.linalg.norm(corner_tan, axis=-1)
    have = corner_len > 1e-20

    # ---- 4. degenerate / empty-group fixups -------------------------------
    # Copy from a good corner welded at the same position+uv (any
    # orientation — FixDegenerates matches by pos+texcoord).
    if not have.all():
        weld_pu = _weld(np.concatenate([verts.reshape(-1, 3),
                                        uvs.reshape(-1, 2)], axis=1))
        flat_have = have.reshape(-1)
        donor = np.full(int(weld_pu.max()) + 1, -1, np.int64)
        good_idx = np.where(flat_have)[0]
        donor[weld_pu[good_idx]] = good_idx   # any good corner per weld
        src = donor[weld_pu]                  # [T*3] donor corner or -1
        flat_tan = corner_tan.reshape(-1, 3)
        can_copy = (~flat_have) & (src >= 0)
        flat_tan[can_copy] = flat_tan[np.clip(src[can_copy], 0, None)]
        corner_tan = flat_tan.reshape(T, 3, 3)
        have = have | can_copy.reshape(T, 3)

    # Last resort: any vector orthogonal to the corner normal.
    fallback = np.cross(normals, np.where(
        np.abs(normals[..., 0:1]) < 0.9, [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    corner_tan = np.where(have[..., None], corner_tan, fallback)

    # ---- 5. orthonormalize against the corner normal ---------------------
    t = corner_tan - normals * np.sum(corner_tan * normals, axis=-1,
                                      keepdims=True)
    t_n, t_len = _normalize_rows(t)
    t = np.where((t_len > 1e-20)[..., None], t_n,
                 _normalize_rows(fallback)[0])

    # Degenerate faces carry no meaningful det sign; +1 is as good as the
    # donor's (the reconstruction multiplies a copied tangent by it on a
    # zero-area face nothing samples).
    signs = np.where(orient, 1.0, -1.0)
    return np.ascontiguousarray(t, np.float32), signs.astype(np.float32)
