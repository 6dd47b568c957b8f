"""Vector math on stacked tensors whose trailing axis has size 3.

Port of ``elevenrender_tpu/core/vecmath.py``.  Sums are written out in
the order the JAX package reduces them, so float results agree.
"""

from __future__ import annotations

import torch

PIF = 3.14159265358979323846

EPS_DENOM = 1e-12


def vec3(x, y, z) -> torch.Tensor:
    """Stack three broadcastable components into a [..., 3] vector."""
    x, y, z = torch.broadcast_tensors(*(torch.as_tensor(c) for c in (x, y, z)))
    return torch.stack([x, y, z], dim=-1)


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a):
    """Divide by the norm, guarded so dead lanes never produce NaN."""
    return a / torch.clamp(length(a), min=EPS_DENOM)[..., None]


def lerp(a, b, t):
    """a + t*(b-a), the JAX package's FAST_LERP form."""
    return a + t * (b - a)


def clampf(a, lo, hi):
    return torch.clamp(torch.as_tensor(a), lo, hi)


def mapf(a, b, c, d, e):
    """Linear remap of a from [b, c] to [d, e] (Math.hpp:22-24)."""
    return d + ((a - b) / (c - b)) * (e - d)


def limit_uv(u, v):
    """Wrap u, v into [0, 1] by one step of +-1."""
    u = u - (u > 1.0).to(u.dtype) + (u < 0.0).to(u.dtype)
    v = v - (v > 1.0).to(v.dtype) + (v < 0.0).to(v.dtype)
    return u, v


def reflect(i, n):
    return i - 2.0 * dot(i, n)[..., None] * n


def where3(mask, a, b):
    """Select on a [...] mask between [..., 3] vectors."""
    return torch.where(mask[..., None], a, b)
