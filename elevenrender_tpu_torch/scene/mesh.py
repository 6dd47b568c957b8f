"""One shape as flat triangle arrays (SoA), ready for the scene IR.

The port's copy of ``MeshData`` from ``elevenrender_tpu/scene/objloader.py``;
the OBJ parser that makes one is ``scene/objloader.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    name: str
    verts: np.ndarray          # [T, 3, 3] float32
    normals: np.ndarray        # [T, 3, 3] float32
    uvs: np.ndarray            # [T, 3, 2] float32
    tangents: np.ndarray       # [T, 3, 3] float32
    tangent_signs: np.ndarray  # [T] float32
    mat_names: list            # [T] str, "" when the face has no material

    @property
    def tri_count(self) -> int:
        return self.verts.shape[0]

    def translate(self, offset) -> None:
        self.verts = self.verts + np.asarray(offset, np.float32)

    def recompute_normals(self) -> None:
        """Face-area-weighted vertex normals over shared positions."""
        from .objloader import recompute_normals_face_weight
        self.normals = recompute_normals_face_weight(self.verts)
