"""Texture, environment and camera lookups of the plain reference.

Frozen copies, as of the benchmark's first version, of
``elevenrender_tpu_torch/ops/texture.py`` (the texel rows of every
texture in one table, C-style wrap, truncating nearest fetch, bilinear
from the floor corners), ``ops/hdri.py`` (the Walker/Vose alias table,
the alias pick, the jittered texel's pdf, the balance heuristic),
``scene/hdri.py`` (the radiance sum) and ``ops/camera.py`` (the sensor
model and XYZ Euler rotation).  The reference builds every table here
from the raw inputs; it takes none of the port's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .vec import PIF, lerp, limit_uv, normalize, uniform_circle_sampling, vec3

FILTER_NONE = 0
FILTER_BILINEAR = 1
_I32_MAX = 2**31 - 1
_F32_BELOW_2_31 = 2147483520.0


# --- textures ---------------------------------------------------------------

def texel_table(textures) -> dict:
    """[(data [H, W, C] float32, filter)] -> {"data": [P, 4] texel rows,
    "off"/"w"/"h"/"ch"/"filter": [K] int32}; one 1x1 dummy when empty."""
    datas, cols = [], {k: [] for k in ("off", "w", "h", "ch", "filter")}
    cursor = 0
    for data, filt in textures:
        h, w, c = data.shape
        rows = np.zeros((h * w, 4), np.float32)
        rows[:, :min(c, 4)] = data.reshape(-1, c)[:, :4]
        datas.append(rows)
        for k, v in (("off", cursor), ("w", w), ("h", h), ("ch", c),
                     ("filter", filt)):
            cols[k].append(v)
        cursor += rows.shape[0]
    if not datas:
        datas = [np.zeros((1, 4), np.float32)]
        cols = {"off": [0], "w": [1], "h": [1], "ch": [1],
                "filter": [FILTER_NONE]}
    out = {"data": np.concatenate(datas)}
    out.update({k: np.array(v, np.int32) for k, v in cols.items()})
    return out


def _to_i32(x):
    if not x.is_floating_point():
        return x.to(torch.int32)
    y = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    y = torch.clamp(y, min=-2147483648.0, max=_F32_BELOW_2_31).to(torch.int32)
    return torch.where(x >= 2147483648.0, torch.full_like(y, _I32_MAX), y)


def _trunc_i32(f):
    return _to_i32(torch.trunc(f))


def _trunc_mod_abs(x, m):
    a = x.to(torch.int64).abs()
    a = torch.where(a == 2**31, torch.full_like(a, -2**31), a)
    return torch.remainder(a, m.to(torch.int64)).to(torch.int32)


def fetch_texel(tab, tex_id, x, y):
    tid = tex_id.long()
    w, h, ch = tab["w"][tid], tab["h"][tid], tab["ch"][tid]
    x = _trunc_mod_abs(_to_i32(x), w)
    y = _trunc_mod_abs(_to_i32(y), h)
    base = tab["off"][tid] + y * w + x
    data = tab["data"]
    row = data[torch.clamp(base, 0, data.shape[0] - 1).long()]
    c0 = row[..., 0]
    g = torch.where(ch >= 2, row[..., 1], c0)
    b = torch.where(ch >= 3, row[..., 2],
                    torch.where(ch == 1, c0, torch.zeros_like(c0)))
    return vec3(c0, g, b)


def _size(tab, tex_id):
    tid = tex_id.long()
    return tab["w"][tid].to(torch.float32), tab["h"][tid].to(torch.float32)


def sample_nearest(tab, tex_id, u, v):
    w, h = _size(tab, tex_id)
    return fetch_texel(tab, tex_id, _trunc_i32(u * w), _trunc_i32(v * h))


def sample_bilinear(tab, tex_id, u, v):
    w, h = _size(tab, tex_id)
    x, y = u * w, v * h
    t1x, t1y = torch.floor(x), torch.floor(y)
    a = (x - t1x)[..., None]
    b = (y - t1y)[..., None]
    v1 = fetch_texel(tab, tex_id, _trunc_i32(t1x), _trunc_i32(t1y))
    v2 = fetch_texel(tab, tex_id, _trunc_i32(t1x + 1), _trunc_i32(t1y))
    v3 = fetch_texel(tab, tex_id, _trunc_i32(t1x), _trunc_i32(t1y + 1))
    v4 = fetch_texel(tab, tex_id, _trunc_i32(t1x + 1), _trunc_i32(t1y + 1))
    return lerp(lerp(v1, v2, a), lerp(v3, v4, a), b)


def sample_filtered(tab, tex_id, u, v, uniform_filter: int):
    """Each texture by its own filter; ``uniform_filter`` is the one
    filter every texture shares, or -1 for a mix."""
    if uniform_filter == FILTER_NONE:
        return sample_nearest(tab, tex_id, u, v)
    if uniform_filter == FILTER_BILINEAR:
        return sample_bilinear(tab, tex_id, u, v)
    w, h = _size(tab, tex_id)
    bil = tab["filter"][tex_id.long()] == FILTER_BILINEAR
    x, y = u * w, v * h
    t1x, t1y = torch.floor(x), torch.floor(y)
    zero = torch.zeros_like(x)
    a = torch.where(bil, x - t1x, zero)[..., None]
    b = torch.where(bil, y - t1y, zero)[..., None]
    nx = _trunc_i32(x).to(torch.float32)
    ny = _trunc_i32(y).to(torch.float32)
    x0, y0 = torch.where(bil, t1x, nx), torch.where(bil, t1y, ny)
    x1, y1 = torch.where(bil, t1x + 1, nx), torch.where(bil, t1y + 1, ny)
    v1 = fetch_texel(tab, tex_id, _trunc_i32(x0), _trunc_i32(y0))
    v2 = fetch_texel(tab, tex_id, _trunc_i32(x1), _trunc_i32(y0))
    v3 = fetch_texel(tab, tex_id, _trunc_i32(x0), _trunc_i32(y1))
    v4 = fetch_texel(tab, tex_id, _trunc_i32(x1), _trunc_i32(y1))
    return lerp(lerp(v1, v2, a), lerp(v3, v4, a), b)


def spherical_mapping(p):
    theta = torch.arccos(torch.clamp(-p[..., 1], -1.0, 1.0))
    phi = torch.atan2(-p[..., 2], p[..., 0]) + PIF
    return limit_uv(phi / (2.0 * PIF), theta / PIF)


def reverse_spherical_mapping(u, v):
    phi = u * 2.0 * PIF
    theta = v * PIF
    px = torch.cos(phi - PIF)
    py = -torch.cos(theta)
    pz = -torch.sin(phi - PIF)
    a = torch.sqrt(torch.clamp(1.0 - py * py, min=0.0))
    return vec3(a * px, py, a * pz)


# --- environment ------------------------------------------------------------

def alias_table(p: np.ndarray):
    p = np.asarray(p, np.float64)
    n = p.size
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    scaled = p * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


def env_tables(img: np.ndarray) -> dict:
    """The environment image [H, W, 3] -> {img, rsum, alias_prob,
    alias_idx} (numpy)."""
    img3 = np.ascontiguousarray(img[:, :, :3], np.float32)
    lum32 = img3[..., 0] + img3[..., 1] + img3[..., 2]
    rsum = float(lum32.astype(np.float64).reshape(-1).sum())
    lum = img3.sum(axis=2).reshape(-1).astype(np.float64)
    psum = lum.sum()
    n = lum.size
    p = lum / psum if psum > 0 else np.full(n, 1.0 / n)
    prob, alias = alias_table(p)
    return {"img": img3, "rsum": np.float32(max(rsum, 1e-30)),
            "alias_prob": prob, "alias_idx": alias.astype(np.int64)}


def sample_env_alias(env, r1, r2):
    H, W, _ = env["img"].shape
    n = H * W
    j = torch.clamp((torch.clamp(r1, 0.0, 1.0 - 1e-7) * n).to(torch.int64),
                    0, n - 1)
    count = torch.where(r2 >= env["alias_prob"][j], env["alias_idx"][j], j)
    return count % W, count // W


def env_fetch_pdf_uv(env, u, v):
    H, W, _ = env["img"].shape
    x = torch.clamp(torch.trunc(u * W).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.trunc(v * H).to(torch.int64), 0, H - 1)
    val = env["img"][y, x]
    lum = val[..., 0] + val[..., 1] + val[..., 2]
    sin_t = torch.clamp(torch.sin(v * math.pi), min=1e-8)
    return val, (lum / env["rsum"]) * W * H / (2.0 * math.pi * math.pi
                                                * sin_t)


def balance_heuristic(a, b):
    ratio = b / torch.clamp(a, min=1e-12)
    return torch.where(a > 0.0, 1.0 / (1.0 + ratio), torch.zeros_like(ratio))


# --- camera -----------------------------------------------------------------

def _rot_xyz(v, rot):
    rx, ry, rz = rot[..., 0], rot[..., 1], rot[..., 2]
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    y, z = (y * torch.cos(rx) - z * torch.sin(rx),
            y * torch.sin(rx) + z * torch.cos(rx))
    x, z = (x * torch.cos(ry) + z * torch.sin(ry),
            z * torch.cos(ry) - x * torch.sin(ry))
    x, y = (x * torch.cos(rz) - y * torch.sin(rz),
            x * torch.sin(rz) + y * torch.cos(rz))
    return torch.stack([x, y, z], dim=-1)


def camera_ray(cam, x_res, y_res, x, y, r1, r2, r3, r4, r5):
    pos = cam["position"]
    fx = x.to(torch.float32) / float(x_res)
    fy = y.to(torch.float32) / float(y_res)
    dx = pos[0] + fx * cam["sensor_width"]
    dy = pos[1] + fy * cam["sensor_height"]
    odx = (-cam["sensor_width"] / 2.0) + dx
    ody = (-cam["sensor_height"] / 2.0) + dy
    rx = (1.0 / x_res) * (r1 - 0.5) * cam["sensor_width"]
    ry = (1.0 / y_res) * (r2 - 0.5) * cam["sensor_height"]
    spz = pos[2] + cam["focal_length"]
    rot = cam["rotation"] * (PIF / 180.0)
    d = _rot_xyz(vec3(odx + rx, ody + ry, spz) - pos, rot)
    origin = torch.broadcast_to(pos, d.shape)
    direction = normalize(d)
    if not cam["bokeh"]:
        return origin, direction
    diameter = cam["focal_length"] / cam["aperture"]
    focus = origin + direction * (cam["focus_distance"] + cam["focal_length"])
    ipx, ipy = uniform_circle_sampling(r3, r4, r5)
    ip = _rot_xyz(vec3(ipx * diameter * 0.5, ipy * diameter * 0.5,
                       torch.zeros_like(ipx)), rot)
    new_origin = pos + ip
    return new_origin, normalize(focus - new_origin)
