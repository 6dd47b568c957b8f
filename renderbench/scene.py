"""The raw scene of a configuration, made from the run's seed.

``make(cfg, seed)`` turns a configuration file (``renderbench/configs``)
into plain numpy arrays: the triangles with their normals, uvs, tangents
and material ids, the materials, the textures, the environment image,
the camera and the point lights.  Both sides take these and nothing
else: the port builds its scene IR from them (``renderbench/port.py``)
and the reference its own tables (``reference/render.prepare``).

The generators are frozen copies, as of the benchmark's first version,
of ``elevenrender_tpu_torch/scene/demo.py`` (the noisy heightfield, its
face normals and planar uvs, the sky, the checker and flat normal maps;
the heightfield's noise now drawn from the run's seed) and
``scene/tangents.py`` (the MikkTSpace-equivalent tangents).
"""

from __future__ import annotations

import numpy as np

FILTERS = {"nearest": 0, "bilinear": 1}


def heightfield_tris(grid: int, extent: float, amplitude: float,
                     frequency: float, noise: float, seed: int):
    rng = np.random.default_rng(seed)
    xs = np.linspace(-extent, extent, grid, dtype=np.float32)
    xx, zz = np.meshgrid(xs, xs, indexing="ij")
    yy = (amplitude * np.sin(frequency * xx) * np.cos(frequency * zz)
          + noise * rng.standard_normal((grid, grid))).astype(np.float32)
    p = np.stack([xx, yy, zz], axis=-1)
    i0, i1, i2, i3 = p[:-1, :-1], p[1:, :-1], p[1:, 1:], p[:-1, 1:]
    t1 = np.stack([i0, i1, i2], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([i0, i2, i3], axis=2).reshape(-1, 3, 3)
    return np.concatenate([t1, t2]).astype(np.float32)


def heightfield_mesh(spec: dict, seed: int) -> dict:
    verts = heightfield_tris(spec["grid"], spec["extent"], spec["amplitude"],
                             spec["frequency"], spec["noise"], seed)
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    fn = np.cross(e2, e1)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    ext = spec["extent"]
    uvs = np.zeros((len(verts), 3, 2), np.float32)
    uvs[:, :, 0] = (verts[:, :, 0] + ext) / (2 * ext)
    uvs[:, :, 1] = (verts[:, :, 2] + ext) / (2 * ext)
    tangents, sign = tangents_of(verts, uvs, normals)
    return {"verts": verts, "normals": normals, "uvs": uvs,
            "tangents": tangents, "sign": sign,
            "mat": np.zeros(len(verts), np.int64)}


def _unit_rows(a, eps=1e-20):
    n = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.maximum(n, eps), n[..., 0]


_HASH_MUL = np.uint64(0x9E3779B97F4A7C15)


def _weld(key: np.ndarray) -> np.ndarray:
    """One label per distinct row of ``key`` [N, k] float64 (-0.0 and 0.0
    alike): a 64-bit hash of each row's bits, one sort of N integers; the
    exact sort of the rows where two different rows share a hash."""
    bits = np.ascontiguousarray(key + 0.0).view(np.uint64)
    h = np.zeros(len(bits), np.uint64)
    for col in bits.T:
        h ^= col
        h *= _HASH_MUL
        h ^= h >> np.uint64(29)
    _, first, weld = np.unique(h, return_index=True, return_inverse=True)
    weld = weld.reshape(-1)
    if np.array_equal(key[first][weld], key):
        return weld
    keyv = np.ascontiguousarray(key).view([("", key.dtype)] * key.shape[1])
    return np.unique(keyv, return_inverse=True)[1].reshape(-1)


def tangents_of(verts, uvs, normals):
    """Per-corner tangents [T, 3, 3] and per-face signs [T]: per-face
    signed-uv tangents, corners welded on (position, normal, uv) and
    split by orientation, angle-weighted and projected sums, the
    degenerate fixups, the orthonormalisation."""
    T = verts.shape[0]
    verts = np.asarray(verts, np.float64)
    uvs = np.asarray(uvs, np.float64)
    normals = np.asarray(normals, np.float64)
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    du1 = uvs[:, 1, 0] - uvs[:, 0, 0]
    dv1 = uvs[:, 1, 1] - uvs[:, 0, 1]
    du2 = uvs[:, 2, 0] - uvs[:, 0, 0]
    dv2 = uvs[:, 2, 1] - uvs[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    pos_area = np.linalg.norm(np.cross(e1, e2), axis=-1)
    degenerate = (np.abs(det) < 1e-25) | (pos_area < 1e-25)
    orient = det >= 0.0
    r = 1.0 / np.where(degenerate, 1.0, det)
    face_tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]

    weld = _weld(np.concatenate([verts.reshape(-1, 3), normals.reshape(-1, 3),
                                 uvs.reshape(-1, 2)], axis=1))
    group = weld * 2 + np.repeat(orient, 3).astype(np.int64)
    nxt_n, _ = _unit_rows(verts[:, [1, 2, 0], :] - verts)
    prv_n, _ = _unit_rows(verts[:, [2, 0, 1], :] - verts)
    angle = np.arccos(np.clip(np.sum(nxt_n * prv_n, axis=-1), -1.0, 1.0))
    ft = np.repeat(face_tan[:, None, :], 3, axis=1)
    proj = ft - normals * np.sum(ft * normals, axis=-1, keepdims=True)
    proj_n, proj_len = _unit_rows(proj)
    ok = (~degenerate)[:, None] & (proj_len > 1e-20)
    w = np.where(ok, angle, 0.0).reshape(-1)
    contrib = proj_n.reshape(-1, 3) * w[:, None]
    n_groups = int(group.max()) + 1
    acc = np.stack([np.bincount(group, contrib[:, k], n_groups)
                    for k in range(3)], axis=1)
    corner_tan = acc[group].reshape(T, 3, 3)
    have = np.linalg.norm(corner_tan, axis=-1) > 1e-20
    if not have.all():
        weld_pu = _weld(np.concatenate([verts.reshape(-1, 3),
                                        uvs.reshape(-1, 2)], axis=1))
        flat_have = have.reshape(-1)
        donor = np.full(int(weld_pu.max()) + 1, -1, np.int64)
        good = np.where(flat_have)[0]
        donor[weld_pu[good]] = good
        src = donor[weld_pu]
        flat_tan = corner_tan.reshape(-1, 3)
        can_copy = (~flat_have) & (src >= 0)
        flat_tan[can_copy] = flat_tan[np.clip(src[can_copy], 0, None)]
        corner_tan = flat_tan.reshape(T, 3, 3)
        have = have | can_copy.reshape(T, 3)
    fallback = np.cross(normals, np.where(
        np.abs(normals[..., 0:1]) < 0.9, [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]))
    corner_tan = np.where(have[..., None], corner_tan, fallback)
    t = corner_tan - normals * np.sum(corner_tan * normals, axis=-1,
                                      keepdims=True)
    t_n, t_len = _unit_rows(t)
    t = np.where((t_len > 1e-20)[..., None], t_n, _unit_rows(fallback)[0])
    return (np.ascontiguousarray(t, np.float32),
            np.where(orient, 1.0, -1.0).astype(np.float32))


def texture(spec: dict) -> np.ndarray:
    size = spec["size"]
    if spec["kind"] == "checker":
        img = np.zeros((size, size, 3), np.float32)
        yy, xx = np.mgrid[0:size, 0:size]
        cell = spec["cell"]
        img[..., 0] = ((xx // cell + yy // cell) % 2).astype(np.float32)
        img[..., 1] = spec["green"]
        img[..., 2] = spec["blue"]
        return img
    if spec["kind"] == "flat_normal":
        img = np.full((size, size, 3), 0.5, np.float32)
        img[..., 2] = 1.0
        return img
    raise ValueError(f"texture kind {spec['kind']!r}")


def sky(spec: dict) -> np.ndarray:
    img = np.zeros((spec["height"], spec["width"], 3), np.float32)
    half = spec["height"] // 2
    img[:half] = spec["upper"]
    img[half:] = spec["lower"]
    sun = spec["sun"]
    img[sun["y"], sun["x"]] = sun["rgb"]
    return img


def make(cfg: dict, seed: int) -> dict:
    """The raw scene of configuration ``cfg`` for ``seed``."""
    if cfg["scene"] != "heightfield":
        raise ValueError(f"scene {cfg['scene']!r}: this harness makes "
                         "heightfields")
    names = [t["name"] for t in cfg["textures"]]
    mat = dict(cfg["material"])
    mat["maps"] = {slot: names.index(tex)
                   for slot, tex in mat.get("maps", {}).items()}
    x_res, y_res = cfg["resolution"]
    return {
        "mesh": heightfield_mesh(cfg["heightfield"], seed),
        "materials": [mat],
        "texture_names": names,
        "textures": [(texture(t), FILTERS[t["filter"]])
                     for t in cfg["textures"]],
        "env": sky(cfg["sky"]),
        "camera": cfg["camera"],
        "lights": cfg["lights"],
        "x_res": x_res, "y_res": y_res,
        "bounces": cfg["bounces"],
        "clamp_radiance": cfg["clamp_radiance"],
    }
