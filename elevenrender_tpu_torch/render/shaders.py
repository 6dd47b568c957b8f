"""Programmable albedo shaders: a registry of PyTorch functions.

Port of ``elevenrender_tpu/render/shaders.py``.  A material whose
``albedo_shader_id`` is a slot number in [0, MAX_SHADERS) takes its albedo
from the function bound to that slot; every slot starts as the
reference's placeholder body (constant yellow).  A shader is a function
over batched tensors::

    def shader(position, view_dir, normal, gnormal, tu, tv) -> rgb [..., 3]

``NAMED_SHADERS`` is the library a client selects from by name.
``registry_version`` changes on every rebind; ``build_ir`` records it in
``RenderConfig.shader_version``.
"""

from __future__ import annotations

import torch

from ..core.device import constant

MAX_SHADERS = 4


def _placeholder(position, view_dir, normal, gnormal, tu, tv):
    """Constant yellow."""
    yellow = constant((1.0, 1.0, 0.0), position.device)
    return yellow.expand(position.shape[:-1] + (3,))


def _checker(position, view_dir, normal, gnormal, tu, tv):
    """8x8 UV checkerboard."""
    c = torch.remainder(torch.floor(tu * 8.0) + torch.floor(tv * 8.0),
                        2.0)[..., None]
    return c.expand(position.shape[:-1] + (3,)) * 0.8 + 0.1


def _normal_rgb(position, view_dir, normal, gnormal, tu, tv):
    """Shading normal as a colour (n * 0.5 + 0.5)."""
    return normal * 0.5 + 0.5


def _uv_gradient(position, view_dir, normal, gnormal, tu, tv):
    """(u, v, 0.5)."""
    return torch.stack([tu, tv, torch.full_like(tu, 0.5)], dim=-1)


NAMED_SHADERS = {
    "yellow": _placeholder,
    "checker": _checker,
    "normal_rgb": _normal_rgb,
    "uv_gradient": _uv_gradient,
}


def register_named_shader(name: str, fn) -> None:
    """Add ``fn`` to the library under ``name`` (the server's
    ``load_osl_material`` selects by name; no code crosses the wire)."""
    NAMED_SHADERS[name] = fn


_REGISTRY: list = [_placeholder] * MAX_SHADERS
_VERSION = 0


def registry_version() -> int:
    return _VERSION


def register_shader(slot: int, fn) -> None:
    global _VERSION
    if not 0 <= slot < MAX_SHADERS:
        raise ValueError(f"shader slot must be in [0, {MAX_SHADERS})")
    _REGISTRY[slot] = fn
    _VERSION += 1


def reset_shaders() -> None:
    global _VERSION
    for i in range(MAX_SHADERS):
        _REGISTRY[i] = _placeholder
    _VERSION += 1


def apply_shaders(shader_id, albedo, position, view_dir, normal, gnormal,
                  tu, tv):
    """``albedo`` with each lane whose shader_id is a slot replaced by
    that slot's shader; lanes with -1 keep theirs."""
    out = albedo
    for slot in range(MAX_SHADERS):
        val = _REGISTRY[slot](position, view_dir, normal, gnormal, tu, tv)
        out = torch.where((shader_id == slot)[..., None], val, out)
    return out
