"""Equirectangular spherical maps between directions and (u, v).

Port of ``spherical_mapping``/``reverse_spherical_mapping`` from
``elevenrender_tpu/ops/texture.py``.  Atlas sampling (textured scenes)
comes with a later slice.
"""

from __future__ import annotations

import torch

from ..core.vecmath import PIF, limit_uv, vec3


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
