"""Direction samplers on tensors of uniforms.

Port of ``elevenrender_tpu/ops/sampling.py``; each formula keeps the
JAX package's evaluation order.
"""

from __future__ import annotations

import torch

from ..core.vecmath import PIF, vec3


def uniform_sample_sphere(u1, u2):
    """A uniform direction on the unit sphere (Sampling.h:9-18)."""
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PIF * u2
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_circle_sampling(u1, u2, u3):
    """Triangle-profile radius, as the reference samples the iris."""
    t = 2.0 * PIF * u1
    u = u2 + u3
    r = torch.where(u > 1.0, 2.0 - u, u)
    return r * torch.cos(t), r * torch.sin(t)


def cosine_sample_hemisphere(u1, u2):
    r = torch.sqrt(u1)
    phi = 2.0 * PIF * u2
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y * y, min=0.0))
    return vec3(x, y, z)


def importance_sample_ggx(rgh, r1, r2):
    """GGX half-vector in tangent space."""
    a = torch.clamp(rgh, min=0.001)
    phi = r1 * PIF * 2.0
    cos_theta = torch.sqrt((1.0 - r2) / (1.0 + (a * a - 1.0) * r2))
    sin_theta = torch.clamp(torch.sqrt(torch.clamp(
        1.0 - cos_theta * cos_theta, min=0.0)), 0.0, 1.0)
    return vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                cos_theta)
