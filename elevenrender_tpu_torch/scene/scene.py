"""Host-side mutable scene container.

The port's copy of ``elevenrender_tpu/scene/scene.py``: camera,
materials, textures (deduplicated by name), meshes, point lights, the
HDRI (default 0.5 grey), material-to-texture pairing by map name, and
``build`` into the device IR.  ``dirty`` is set by every mutation, so a
caller can tell whether the built IR is stale.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera
from .hdri import HDRI
from .material import MAP_SLOTS, Material
from .mesh import MeshData


@dataclasses.dataclass
class PointLight:
    position: np.ndarray
    radiance: np.ndarray


class Scene:
    def __init__(self):
        self.camera = Camera()
        self.materials: list[Material] = []
        self.textures = []
        self.texture_ids: dict[str, int] = {}
        self.meshes: list[MeshData] = []
        self.point_lights: list[PointLight] = []
        self.hdri = HDRI()
        self.x_res = 1280
        self.y_res = 720
        self.dirty = True

    def add_texture(self, texture) -> None:
        """Adds ``texture`` unless one of the same name is there already
        (the first one added keeps its id)."""
        if texture.name not in self.texture_ids:
            self.texture_ids[texture.name] = len(self.textures)
            self.textures.append(texture)
            self.dirty = True

    def add_material(self, material: Material) -> None:
        self.materials.append(material)
        self.dirty = True

    def add_mesh(self, mesh: MeshData) -> None:
        self.meshes.append(mesh)
        self.dirty = True

    def add_point_light(self, light: PointLight) -> None:
        self.point_lights.append(light)
        self.dirty = True

    def add_hdri(self, hdri: HDRI) -> None:
        self.hdri = hdri
        self.dirty = True

    def set_camera(self, camera: Camera) -> None:
        self.camera = camera
        self.dirty = True

    def pair_textures(self) -> None:
        """Resolve each material's map names to texture ids, in all
        seven slots (the reference skips transmission)."""
        for mat in self.materials:
            for slot in MAP_SLOTS:
                name = getattr(mat, f"{slot}_map")
                if name and name in self.texture_ids:
                    setattr(mat, f"{slot}_texture_id", self.texture_ids[name])

    @property
    def tri_count(self) -> int:
        return sum(m.tri_count for m in self.meshes)

    def build(self, config=None, bvh_depth=None, device="cuda"):
        """Flatten to (RenderConfig, IR of tensors on ``device``)."""
        from .ir import build_ir
        return build_ir(self, config=config, bvh_depth=bvh_depth,
                        device=device)
