"""Ray-triangle intersection and hit attributes on tensors.

Port of ``elevenrender_tpu/ops/intersect.py``: Möller-Trumbore, the full
smooth-shading hit (interpolated normal/tangent, geometric normal flipped
against the ray, the shadow-terminator fix, bitangent = sign * n x t),
and the packed [T, 40] per-tri attribute row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.vecmath import cross, dot, normalize

EPSILON = 1e-7


def moller_trumbore(ray_o, ray_d, v0, v1, v2):
    """Geometric test only: (valid, t, u, v); t == 0 is accepted."""
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = cross(ray_d, edge2)
    det = dot(edge1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30,
                                torch.full_like(det, 1e-30), det)

    tvec = ray_o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot(ray_d, qvec) * inv_det
    t = dot(edge2, qvec) * inv_det

    valid = ((torch.abs(det) > EPSILON)
             & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & (t >= 0.0))
    return valid, t, u, v


def _project_on_plane(p, origin, normal):
    return p - dot(p - origin, normal)[..., None] * normal


def full_hit(ray_o, ray_d, tri):
    """All shading attributes of the given triangles (see ``gather_tri``
    for the dict layout)."""
    v0 = tri["verts"][..., 0, :]
    v1 = tri["verts"][..., 1, :]
    v2 = tri["verts"][..., 2, :]
    valid, t, u, v = moller_trumbore(ray_o, ray_d, v0, v1, v2)

    uv0 = tri["uvs"][..., 0, :]
    uv1 = tri["uvs"][..., 1, :]
    uv2 = tri["uvs"][..., 2, :]
    t_uv = uv0 + (uv1 - uv0) * u[..., None] + (uv2 - uv0) * v[..., None]

    geom_pos = ray_o + ray_d * t[..., None]

    n0 = tri["normals"][..., 0, :]
    n1 = tri["normals"][..., 1, :]
    n2 = tri["normals"][..., 2, :]
    shading_normal = normalize(n0 + (n1 - n0) * u[..., None]
                               + (n2 - n0) * v[..., None])

    edge1 = v1 - v0
    edge2 = v2 - v0
    comp_normal = normalize(cross(edge1, edge2))
    comp_normal = torch.where(dot(comp_normal, ray_d)[..., None] > 0.0,
                              -comp_normal, comp_normal)

    tg0 = tri["tangents"][..., 0, :]
    tg1 = tri["tangents"][..., 1, :]
    tg2 = tri["tangents"][..., 2, :]
    shading_tangent = (tg0 + (tg1 - tg0) * u[..., None]
                       + (tg2 - tg0) * v[..., None])

    p0 = _project_on_plane(geom_pos, v0, n0)
    p1 = _project_on_plane(geom_pos, v1, n1)
    p2 = _project_on_plane(geom_pos, v2, n2)
    shading_pos = p0 + (p1 - p0) * u[..., None] + (p2 - p0) * v[..., None]
    convex = dot(shading_pos - geom_pos, shading_normal) > 0.0
    position = torch.where(convex[..., None], shading_pos, geom_pos)

    bitangent = tri["sign"][..., None] * cross(shading_normal,
                                               shading_tangent)

    return {
        "valid": valid,
        "t": t,
        "position": position,
        "normal": shading_normal,
        "gnormal": comp_normal,
        "tangent": shading_tangent,
        "bitangent": bitangent,
        "tu": t_uv[..., 0],
        "tv": t_uv[..., 1],
        "mat": tri["mat"],
    }


def gather_tri(tris: dict, idx):
    """Per-tri attributes at ``idx`` (clamped into range) from the packed
    [T, 40] row: verts 0:9, normals 9:18, uvs 18:24, tangents 24:33,
    sign 33, material id 34."""
    packed = tris["packed"]
    safe = torch.clamp(idx, 0, tris["verts"].shape[0] - 1)
    row = packed[safe]
    lead = row.shape[:-1]
    return {
        "verts": row[..., 0:9].reshape(lead + (3, 3)),
        "normals": row[..., 9:18].reshape(lead + (3, 3)),
        "uvs": row[..., 18:24].reshape(lead + (3, 2)),
        "tangents": row[..., 24:33].reshape(lead + (3, 3)),
        "sign": row[..., 33],
        "mat": row[..., 34].to(torch.int64),
    }


def pack_tri_attributes(verts, normals, uvs, tangents, sign, mat):
    """Build the [T, 40] packed attribute matrix (numpy, host side)."""
    T = verts.shape[0]
    row = np.zeros((max(T, 1), 40), np.float32)
    if T:
        row[:, 0:9] = verts.reshape(T, 9)
        row[:, 9:18] = normals.reshape(T, 9)
        row[:, 18:24] = uvs.reshape(T, 6)
        row[:, 24:33] = tangents.reshape(T, 9)
        row[:, 33] = sign
        row[:, 34] = mat.astype(np.float32)
    return row
