"""Vector math, direction samplers and the per-pixel RNG of the plain
reference.

Frozen copies of ``elevenrender_tpu_torch/core/vecmath.py``,
``ops/sampling.py`` and ``core/rng.py`` as of the benchmark's first
version, each formula in the same order of operations, so that the
reference's floats are the port's wherever both take the same path.
"""

from __future__ import annotations

import torch

PIF = 3.14159265358979323846
EPS_DENOM = 1e-12
MASK32 = 0xFFFFFFFF
UINT_MAX_F32 = 4294967296.0


def vec3(x, y, z):
    x, y, z = torch.broadcast_tensors(x, y, z)
    return torch.stack([x, y, z], dim=-1)


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(a):
    return a / torch.clamp(torch.sqrt(dot(a, a)), min=EPS_DENOM)[..., None]


def lerp(a, b, t):
    return a + t * (b - a)


def limit_uv(u, v):
    u = u - (u > 1.0).to(u.dtype) + (u < 0.0).to(u.dtype)
    v = v - (v > 1.0).to(v.dtype) + (v < 0.0).to(v.dtype)
    return u, v


def reflect(i, n):
    return i - 2.0 * dot(i, n)[..., None] * n


def where3(mask, a, b):
    return torch.where(mask[..., None], a, b)


# --- samplers ---------------------------------------------------------------

def cosine_sample_hemisphere(u1, u2):
    r = torch.sqrt(u1)
    phi = 2.0 * PIF * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return vec3(x, y, z)


def importance_sample_ggx(rgh, r1, r2):
    a = torch.clamp(rgh, min=0.001)
    phi = r1 * PIF * 2.0
    cos_theta = torch.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
    sin_theta = torch.clamp(torch.sqrt(torch.clamp(
        1.0 - cos_theta * cos_theta, min=0.0)), 0.0, 1.0)
    return vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                cos_theta)


def uniform_circle_sampling(u1, u2, u3):
    t = 2.0 * PIF * u1
    u = u2 + u3
    r = torch.where(u > 1.0, 2.0 - u, u)
    return r * torch.cos(t), r * torch.sin(t)


# --- per-pixel xorshift32 streams seeded by a Jenkins hash --------------------

def jenkins_hash(seed):
    seed = seed.to(torch.int64) & MASK32
    h = torch.zeros_like(seed)
    for i in range(4):
        h = (h + ((seed >> (i * 8)) & 0xFF)) & MASK32
        h = (h + (h << 10)) & MASK32
        h = h ^ (h >> 6)
    h = (h + (h << 3)) & MASK32
    h = h ^ (h >> 11)
    h = (h + (h << 15)) & MASK32
    return h


def init_rng(pixel_idx):
    return jenkins_hash((pixel_idx.to(torch.int64) + 1) & MASK32)


def _next_state(state):
    state = state ^ ((state << 13) & MASK32)
    state = state ^ (state >> 17)
    return state ^ ((state << 5) & MASK32)


def next_float(state):
    state = _next_state(state)
    return state, state.to(torch.float32) / UINT_MAX_F32


def next_float_masked(state, mask):
    new = _next_state(state)
    return torch.where(mask, new, state), new.to(torch.float32) / UINT_MAX_F32
