"""Host-side mutable scene container.

The port's copy of ``elevenrender_tpu/scene/scene.py``, cut to what the
untextured, unlit slice needs: camera, materials, meshes, the HDRI
(default 0.5 grey) and ``build`` into the device IR.  ``textures`` and
``point_lights`` are read by ``build_ir`` (a scene with either does not
render yet); texture loading and pairing come with the textured slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .camera import Camera
from .hdri import HDRI
from .material import Material
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
        self.meshes: list[MeshData] = []
        self.point_lights: list[PointLight] = []
        self.hdri = HDRI()
        self.x_res = 1280
        self.y_res = 720

    def add_material(self, material: Material) -> None:
        self.materials.append(material)

    def add_mesh(self, mesh: MeshData) -> None:
        self.meshes.append(mesh)

    def add_hdri(self, hdri: HDRI) -> None:
        self.hdri = hdri

    def build(self, config=None, bvh_depth=None, device="cuda"):
        """Flatten to (RenderConfig, IR of tensors on ``device``)."""
        from .ir import build_ir
        return build_ir(self, config=config, bvh_depth=bvh_depth,
                        device=device)
