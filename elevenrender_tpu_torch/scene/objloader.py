"""Wavefront OBJ/MTL ingestion -> flat numpy mesh arrays.

The port's copy of ``elevenrender_tpu/scene/objloader.py`` (the
reference's rapidobj-based ObjLoader):
- triangulated meshes with per-vertex position/normal/uv, polygons by a
  fan (rapidobj::Triangulate for convex faces);
- the reference's Z negation of positions and normals
  (ObjLoader.cpp:111-112);
- per-face material *names*, resolved against the loaded BRDF materials
  when the IR is built;
- optional face-area-weighted normal recomputation over shared positions
  (ObjLoader.cpp:53-66: n += cross(edge2, edge1), note the winding);
- tangents per mesh (``scene/tangents.py``).

The parser is a single-pass Python tokenizer with numpy batch
conversion, and it is the only one: the JAX package hands texts above
2 MB to its C++ tokenizer (``ops/native.py``), which gives the same
arrays and which the port does not have yet.
"""

from __future__ import annotations

import io

import numpy as np

from .material import Material
from .mesh import MeshData
from .tangents import compute_tangents

_FLIP_Z = np.array([1.0, 1.0, -1.0], np.float32)


def parse_mtl(text: str) -> list[Material]:
    """Parse a .mtl string into Materials: Kd -> albedo, Ks.x ->
    specular, Ke -> emission, Ni -> eta, d -> opacity, map_Kd -> albedo
    map (the reference's legacy parser, ObjLoader.cpp:10-51).  Over TCP
    only the ``newmtl`` names matter: materials arrive as BRDF JSON."""
    mats: list[Material] = []
    cur: Material | None = None
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith('#'):
            continue
        parts = line.split()
        key = parts[0]
        if key == "newmtl":
            cur = Material(name=parts[1] if len(parts) > 1 else "")
            cur.compute_aniso_alphas()
            mats.append(cur)
        elif cur is None:
            continue
        elif key == "Kd" and len(parts) >= 4:
            cur.albedo = np.array(parts[1:4], np.float32)
        elif key == "Ks" and len(parts) >= 2:
            cur.specular = float(parts[1])
        elif key == "Ke" and len(parts) >= 4:
            cur.emission = np.array(parts[1:4], np.float32)
        elif key == "Ni" and len(parts) >= 2:
            cur.eta = float(parts[1])
        elif key == "d" and len(parts) >= 2:
            cur.opacity = float(parts[1])
        elif key == "map_Kd" and len(parts) >= 2:
            cur.albedo_map = parts[-1]
    return mats


def _resolve(idx: int, n: int) -> int:
    """OBJ 1-based / negative-relative index -> 0-based."""
    return idx - 1 if idx > 0 else n + idx


def recompute_normals_face_weight(verts: np.ndarray) -> np.ndarray:
    """Face-area-weighted vertex normals over shared positions.  The
    reference accumulates cross(edge2, edge1); the cross product's
    magnitude is the area weight."""
    T = verts.shape[0]
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    face_n = np.cross(e2, e1)

    pos = verts.reshape(-1, 3)
    keys = pos.view([('', pos.dtype)] * 3)
    _, uniq_inv = np.unique(keys, return_inverse=True)
    uniq_inv = uniq_inv.reshape(-1)
    acc = np.zeros((uniq_inv.max() + 1, 3), np.float64)
    np.add.at(acc, uniq_inv, np.repeat(face_n, 3, axis=0))
    n = acc[uniq_inv].reshape(T, 3, 3)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return np.ascontiguousarray(
        np.where(ln > 1e-20, n / np.maximum(ln, 1e-20), 0.0), np.float32)


def _read_text(obj_source) -> str:
    """A path, an OBJ string (or bytes), or a file-like object -> text."""
    if isinstance(obj_source, (str, bytes)):
        try:
            with open(obj_source, 'r', errors='replace') as f:
                return f.read()
        except (OSError, ValueError):
            return (obj_source if isinstance(obj_source, str)
                    else obj_source.decode('utf-8', 'replace'))
    if isinstance(obj_source, io.IOBase) or hasattr(obj_source, 'read'):
        text = obj_source.read()
        return text.decode('utf-8', 'replace') if isinstance(text, bytes) \
            else text
    raise TypeError(type(obj_source))


def load_objs(obj_source, mtl_text: str | None = None,
              recompute_normals: bool = False
              ) -> tuple[list[MeshData], list[Material]]:
    """Parse OBJ text (path, str, or file-like) into MeshData per shape.

    Returns (meshes, materials from ``mtl_text``), as the reference's
    ObjLoader::loadObjsRapid (ObjLoader.cpp:69-164)."""
    text = _read_text(obj_source)

    positions: list[list[str]] = []
    normals: list[list[str]] = []
    texcoords: list[list[str]] = []
    # Per shape: (name, [(corner tokens x3, material name)]).
    shapes: list[tuple[str, list]] = []
    cur_faces: list = []
    cur_name = ""
    cur_mtl = ""

    def flush_shape():
        nonlocal cur_faces
        if cur_faces:
            shapes.append((cur_name, cur_faces))
            cur_faces = []

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line[0] == '#':
            continue
        sp = line.split()
        tag = sp[0]
        if tag == 'v':
            positions.append(sp[1:4])
        elif tag == 'vn':
            normals.append(sp[1:4])
        elif tag == 'vt':
            texcoords.append(sp[1:3])
        elif tag == 'f':
            corners = sp[1:]
            for k in range(1, len(corners) - 1):
                cur_faces.append((corners[0], corners[k], corners[k + 1],
                                  cur_mtl))
        elif tag in ('o', 'g'):
            flush_shape()
            cur_name = line[2:].strip()
        elif tag == 'usemtl':
            cur_mtl = line[7:].strip()
    flush_shape()

    P = (np.array(positions, np.float32) if positions
         else np.zeros((0, 3), np.float32))
    N = (np.array(normals, np.float32) if normals
         else np.zeros((0, 3), np.float32))
    UV = (np.array(texcoords, np.float32) if texcoords
          else np.zeros((0, 2), np.float32))

    materials = parse_mtl(mtl_text) if mtl_text else []

    meshes: list[MeshData] = []
    for shape_name, faces in shapes:
        T = len(faces)
        vi = np.zeros((T, 3), np.int64)
        ni = np.full((T, 3), -1, np.int64)
        ti = np.full((T, 3), -1, np.int64)
        mat_names = []
        for f, (c0, c1, c2, mtl) in enumerate(faces):
            mat_names.append(mtl)
            for j, c in enumerate((c0, c1, c2)):
                comps = c.split('/')
                vi[f, j] = _resolve(int(comps[0]), len(P))
                if len(comps) > 1 and comps[1]:
                    ti[f, j] = _resolve(int(comps[1]), len(UV))
                if len(comps) > 2 and comps[2]:
                    ni[f, j] = _resolve(int(comps[2]), len(N))

        verts = P[vi] * _FLIP_Z                          # [T, 3, 3]

        if (ni >= 0).all() and len(N):
            nrm = N[np.maximum(ni, 0)] * _FLIP_Z
            ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = np.where(ln > 1e-20, nrm / np.maximum(ln, 1e-20), nrm)
        else:
            # No normals in the file: geometric ones, reference winding.
            e1 = verts[:, 1] - verts[:, 0]
            e2 = verts[:, 2] - verts[:, 0]
            fn = np.cross(e2, e1)
            ln = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = np.where(ln > 1e-20, fn / np.maximum(ln, 1e-20), fn)
            nrm = np.repeat(fn[:, None, :], 3, axis=1)
        nrm = np.ascontiguousarray(nrm, np.float32)

        if (ti >= 0).any() and len(UV):
            uv = UV[np.maximum(ti, 0)]
            uv = np.where((ti >= 0)[..., None], uv, 0.0)
        else:
            uv = np.zeros((T, 3, 2), np.float32)
        uv = np.ascontiguousarray(uv, np.float32)

        if recompute_normals:
            nrm = recompute_normals_face_weight(verts)

        tan, signs = compute_tangents(verts, uv, nrm)
        meshes.append(MeshData(
            name=shape_name, verts=np.ascontiguousarray(verts, np.float32),
            normals=nrm, uvs=uv, tangents=tan, tangent_signs=signs,
            mat_names=mat_names))

    return meshes, materials
