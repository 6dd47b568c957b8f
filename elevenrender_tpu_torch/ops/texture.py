"""Texture sampling over a packed atlas, and the equirect spherical maps.

Port of ``elevenrender_tpu/ops/texture.py``.  All textures live in one
[P, 4] float32 table of texel rows with a per-texture table of offset,
width, height, channels and filter (``pack_atlas``), so a fetch is one
row gather by a computed index.

Wrap and rounding follow the reference renderer exactly: C-style
truncating ``%`` then absolute value, nearest fetch truncates ``u*w``
toward zero, bilinear lerps four fetches at the floor corners.  Float to
int32 conversion is written out (``_to_i32``) to give what the JAX
package gets from XLA on the CPU: toward zero, NaN -> 0, saturating at
the int32 range; a bare ``tensor.to(torch.int32)`` gives INT_MIN for NaN
and +-inf on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.vecmath import PIF, lerp, limit_uv, vec3

FILTER_NONE = 0
FILTER_BILINEAR = 1

_I32_MAX = 2**31 - 1
# The largest float32 below 2^31: the top of the range a float converts
# into without saturating.
_F32_BELOW_2_31 = 2147483520.0


def pack_atlas(textures) -> dict:
    """Host Textures -> numpy {"data": [P, 4] f32 texel rows (channels
    beyond 4 dropped, missing ones 0), "off"/"w"/"h"/"ch"/"filter": [K]
    i32} with ``off`` in texels.  Holds one dummy 1x1 texture when there
    are none, so gathers stay in range."""
    datas, off, w, h, ch, filt = [], [], [], [], [], []
    cursor = 0
    for t in textures:
        texels = t.data.reshape(-1, t.channels).astype(np.float32)
        rows = np.zeros((texels.shape[0], 4), np.float32)
        rows[:, :min(t.channels, 4)] = texels[:, :4]
        datas.append(rows)
        off.append(cursor)
        w.append(t.width)
        h.append(t.height)
        ch.append(t.channels)
        filt.append(t.filter)
        cursor += rows.shape[0]
    if not datas:
        datas = [np.zeros((1, 4), np.float32)]
        off, w, h, ch, filt = [0], [1], [1], [1], [FILTER_NONE]
    out = {"data": np.concatenate(datas)}
    for k, v in (("off", off), ("w", w), ("h", h), ("ch", ch),
                 ("filter", filt)):
        out[k] = np.array(v, np.int32)
    return out


def _to_i32(x):
    """int32 of ``x``: floats toward zero with NaN -> 0 and saturation
    at the int32 range (XLA's conversion); integers wrap."""
    if not x.is_floating_point():
        return x.to(torch.int32)
    y = torch.where(torch.isnan(x), torch.zeros_like(x), x)
    y = torch.clamp(y, min=-2147483648.0, max=_F32_BELOW_2_31)
    y = y.to(torch.int32)
    return torch.where(x >= 2147483648.0, torch.full_like(y, _I32_MAX), y)


def _trunc_i32(f):
    """C float -> int cast (toward zero)."""
    return _to_i32(torch.trunc(f))


def _trunc_mod_abs(x, m):
    """C++ ``x %= m; if (x < 0) x = -x`` for int32 x and m > 0, as the
    JAX package computes it: |x| in int32 (so |INT_MIN| stays INT_MIN),
    then the floor remainder.  Done in int64 to stay clear of int32
    overflow."""
    a = x.to(torch.int64).abs()
    a = torch.where(a == 2**31, torch.full_like(a, -2**31), a)
    return torch.remainder(a, m.to(torch.int64)).to(torch.int32)


def fetch_texel(atlas, tex_id, x, y):
    """Texel (x, y) of texture ``tex_id``, wrapped -> [..., 3]: one
    channel broadcasts to grey, two give (r, g, 0)."""
    tid = tex_id.long()
    off = atlas["off"][tid]
    w = atlas["w"][tid]
    h = atlas["h"][tid]
    ch = atlas["ch"][tid]
    x = _trunc_mod_abs(_to_i32(x), w)
    y = _trunc_mod_abs(_to_i32(y), h)
    base = off + y * w + x
    data = atlas["data"]
    row = data[torch.clamp(base, 0, data.shape[0] - 1).long()]
    c0 = row[..., 0]
    g = torch.where(ch >= 2, row[..., 1], c0)
    b = torch.where(ch >= 3, row[..., 2],
                    torch.where(ch == 1, c0, torch.zeros_like(c0)))
    return vec3(c0, g, b)


def _size(atlas, tex_id):
    tid = tex_id.long()
    return (atlas["w"][tid].to(torch.float32),
            atlas["h"][tid].to(torch.float32))


def sample_nearest(atlas, tex_id, u, v):
    w, h = _size(atlas, tex_id)
    return fetch_texel(atlas, tex_id, _trunc_i32(u * w), _trunc_i32(v * h))


def sample_bilinear(atlas, tex_id, u, v):
    w, h = _size(atlas, tex_id)
    x = u * w
    y = v * h
    t1x = torch.floor(x)
    t1y = torch.floor(y)
    a = (x - t1x)[..., None]
    b = (y - t1y)[..., None]
    v1 = fetch_texel(atlas, tex_id, _trunc_i32(t1x), _trunc_i32(t1y))
    v2 = fetch_texel(atlas, tex_id, _trunc_i32(t1x + 1), _trunc_i32(t1y))
    v3 = fetch_texel(atlas, tex_id, _trunc_i32(t1x), _trunc_i32(t1y + 1))
    v4 = fetch_texel(atlas, tex_id, _trunc_i32(t1x + 1),
                     _trunc_i32(t1y + 1))
    return lerp(lerp(v1, v2, a), lerp(v3, v4, a), b)


def sample_filtered(atlas, tex_id, u, v, uniform_filter: int = -1):
    """Each texture by its own filter.  ``uniform_filter`` (from the
    scene build) names the one filter every texture shares, or -1 for a
    mixed atlas: then four fetches serve both filters, the nearest lanes
    putting all four taps on their texel with zero lerp weights."""
    if uniform_filter == FILTER_NONE:
        return sample_nearest(atlas, tex_id, u, v)
    if uniform_filter == FILTER_BILINEAR:
        return sample_bilinear(atlas, tex_id, u, v)

    w, h = _size(atlas, tex_id)
    bil = atlas["filter"][tex_id.long()] == FILTER_BILINEAR
    x = u * w
    y = v * h
    t1x = torch.floor(x)
    t1y = torch.floor(y)
    zero = torch.zeros_like(x)
    a = torch.where(bil, x - t1x, zero)[..., None]
    b = torch.where(bil, y - t1y, zero)[..., None]
    nx = _trunc_i32(x).to(torch.float32)
    ny = _trunc_i32(y).to(torch.float32)
    x0 = torch.where(bil, t1x, nx)
    y0 = torch.where(bil, t1y, ny)
    x1 = torch.where(bil, t1x + 1, nx)
    y1 = torch.where(bil, t1y + 1, ny)
    v1 = fetch_texel(atlas, tex_id, _trunc_i32(x0), _trunc_i32(y0))
    v2 = fetch_texel(atlas, tex_id, _trunc_i32(x1), _trunc_i32(y0))
    v3 = fetch_texel(atlas, tex_id, _trunc_i32(x0), _trunc_i32(y1))
    v4 = fetch_texel(atlas, tex_id, _trunc_i32(x1), _trunc_i32(y1))
    return lerp(lerp(v1, v2, a), lerp(v3, v4, a), b)


def spherical_mapping(p):
    """Direction -> equirect (u, v); callers pass ``-ray_direction``."""
    theta = torch.arccos(torch.clamp(-p[..., 1], -1.0, 1.0))
    phi = torch.atan2(-p[..., 2], p[..., 0]) + PIF
    u = phi / (2.0 * PIF)
    v = theta / PIF
    return limit_uv(u, v)


def reverse_spherical_mapping(u, v):
    """Equirect (u, v) -> direction."""
    phi = u * 2.0 * PIF
    theta = v * PIF
    px = torch.cos(phi - PIF)
    py = -torch.cos(theta)
    pz = -torch.sin(phi - PIF)
    a = torch.sqrt(torch.clamp(1.0 - py * py, min=0.0))
    return vec3(a * px, py, a * pz)
