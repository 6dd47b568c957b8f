"""Disney material description (host side).

The port's copy of ``elevenrender_tpu/scene/material.py``: the Disney
scalars, albedo/emission colours, the seven texture-map slots with their
resolved texture ids, and the programmable-shader hook.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# The seven texture-map slots, in the order Scene.pair_textures walks
# them and the IR's material "tex" columns hold them.
MAP_SLOTS = ("albedo", "emission", "roughness", "metallic", "normal",
             "opacity", "transmission")


@dataclasses.dataclass
class Material:
    name: str = "default"

    albedo_map: str = ""
    emission_map: str = ""
    roughness_map: str = ""
    metallic_map: str = ""
    normal_map: str = ""
    opacity_map: str = ""
    transmission_map: str = ""

    albedo_texture_id: int = -1
    emission_texture_id: int = -1
    roughness_texture_id: int = -1
    metallic_texture_id: int = -1
    normal_texture_id: int = -1
    opacity_texture_id: int = -1
    transmission_texture_id: int = -1

    albedo_shader_id: int = -1

    albedo: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5], np.float32))
    emission: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))

    opacity: float = 1.0
    roughness: float = 1.0
    metallic: float = 0.0
    clearcoat_gloss: float = 0.0
    clearcoat: float = 0.0
    anisotropic: float = 0.0
    eta: float = 0.0
    transmission: float = 0.0
    specular: float = 0.5
    specular_tint: float = 0.0
    sheen_tint: float = 0.5
    subsurface: float = 0.0
    sheen: float = 0.0
    ax: float = 0.0
    ay: float = 0.0

    def compute_aniso_alphas(self) -> None:
        aspect = math.sqrt(1.0 - self.anisotropic * 0.9)
        self.ax = max(0.001, self.roughness / aspect)
        self.ay = max(0.001, self.roughness * aspect)

    @staticmethod
    def default() -> "Material":
        m = Material()
        m.compute_aniso_alphas()
        return m
