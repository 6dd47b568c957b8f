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

    @staticmethod
    def from_json(obj: dict) -> "Material":
        """The wire JSON (the reference's parse_materialjson): colours as
        {"r", "g", "b"}, the scalars by name, where the wire name for
        metallic is ``metalness``, and the map names."""
        m = Material()
        if "name" in obj:
            m.name = str(obj["name"])
        if "albedo" in obj:
            c = obj["albedo"]
            m.albedo = np.array([c["r"], c["g"], c["b"]], np.float32)
        if "emission" in obj:
            c = obj["emission"]
            m.emission = np.array([c["r"], c["g"], c["b"]], np.float32)
        for wire, attr in (("roughness", "roughness"),
                           ("metalness", "metallic"),
                           ("specular", "specular"), ("opacity", "opacity"),
                           ("transmission", "transmission")):
            if wire in obj:
                setattr(m, attr, float(obj[wire]))
        for slot in MAP_SLOTS:
            key = f"{slot}_map"
            if key in obj:
                setattr(m, key, str(obj[key]))
        if "albedo_shader_id" in obj:
            m.albedo_shader_id = int(obj["albedo_shader_id"])
        m.compute_aniso_alphas()
        return m
