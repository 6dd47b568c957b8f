"""Built-in demo scenes, so the chip smoke test needs nothing from tests/.

``heightfield_scene(grid=182, res=1024)`` is the main path's scene: a
noisy 182x182 heightfield (65,522 tris), an HDRI sky with a sun, one
glossy Disney material, no textures and no point lights.

``textured_heightfield_scene(grid=708, res=1024)`` is config 5: the same
terrain at 999,698 tris with a bilinear 64x64 checker albedo map, a
nearest 32x32 flat normal map, the sky and one point light.

Both are the JAX package's test scenes of those names
(``tests/scenes.py``): the same geometry, textures, light and camera.

``mesh_obj_text`` writes a mesh as the OBJ text a client streams to the
server (``load_object``); ``sky_image`` is the scenes' HDRI.
"""

from __future__ import annotations

import numpy as np

from .hdri import HDRI
from .material import Material
from .mesh import MeshData
from .scene import PointLight, Scene
from .tangents import compute_tangents
from .texture import Texture


def heightfield_mesh(grid: int = 128, seed: int = 0) -> MeshData:
    """A grid x grid noisy heightfield -> 2*(grid-1)^2 triangles."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-2, 2, grid, dtype=np.float32)
    zs = np.linspace(-2, 2, grid, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = (0.25 * np.sin(3 * xx) * np.cos(3 * zz)
          + 0.05 * rng.standard_normal((grid, grid))).astype(np.float32)
    P = np.stack([xx, yy, zz], axis=-1)

    i0 = P[:-1, :-1]
    i1 = P[1:, :-1]
    i2 = P[1:, 1:]
    i3 = P[:-1, 1:]
    t1 = np.stack([i0, i1, i2], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([i0, i2, i3], axis=2).reshape(-1, 3, 3)
    verts = np.concatenate([t1, t2]).astype(np.float32)
    T = verts.shape[0]

    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    fn = np.cross(e2, e1)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    uvs = np.zeros((T, 3, 2), np.float32)
    uvs[:, :, 0] = (verts[:, :, 0] + 2) / 4
    uvs[:, :, 1] = (verts[:, :, 2] + 2) / 4
    tangents, signs = compute_tangents(verts, uvs, normals)
    return MeshData(name="heightfield", verts=verts, normals=normals,
                    uvs=uvs, tangents=tangents, tangent_signs=signs,
                    mat_names=["terrain"] * T)


def mesh_obj_text(mesh: MeshData) -> str:
    """``mesh`` as OBJ text: one ``o`` shape, three ``v`` and ``vt`` lines
    per tri, no normals, and a ``usemtl`` wherever the material name
    changes.  z is negated, as the loader negates it back, and every
    float is written with %.9g, which gives a float32 back exactly; so
    ``load_objs`` returns the mesh's verts, uvs, tangents and names, and
    its geometric normals (those of ``heightfield_mesh``)."""
    verts = mesh.verts.reshape(-1, 3) * np.array([1.0, 1.0, -1.0],
                                                 np.float32)
    lines = [f"o {mesh.name}"]
    lines += [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts.tolist()]
    lines += [f"vt {u:.9g} {v:.9g}"
              for u, v in mesh.uvs.reshape(-1, 2).tolist()]
    current = None
    for t, name in enumerate(mesh.mat_names):
        if name != current:
            lines.append(f"usemtl {name}")
            current = name
        a, b, c = 3 * t + 1, 3 * t + 2, 3 * t + 3
        lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
    return "\n".join(lines) + "\n"


def sky_image() -> np.ndarray:
    """The scenes' 32x16 HDRI: a blue sky, a grey ground and a sun."""
    sky = np.zeros((16, 32, 3), np.float32)
    sky[:8] = [0.6, 0.7, 0.9]
    sky[8:] = [0.2, 0.2, 0.2]
    sky[3, 8] = [50.0, 45.0, 40.0]  # sun
    return sky


def _sky_camera_and_build(scene, res, spp, compat, bvh_depth, device):
    scene.add_hdri(HDRI(Texture("sky", sky_image())))
    scene.camera.position = np.array([0.0, 1.5, -4.0], np.float32)
    scene.camera.rotation = np.array([15.0, 0.0, 0.0], np.float32)
    scene.x_res = res
    scene.y_res = res
    config, ir = scene.build(bvh_depth=bvh_depth, device=device)
    config = config.replace(sample_target=spp, compat=compat)
    return scene, config, ir


def heightfield_scene(grid: int = 128, res: int = 256, spp: int = 16,
                      compat: bool = False, bvh_depth=None, device="cuda"):
    """~2*grid^2 tris + HDRI sky + glossy Disney terrain.
    Returns (scene, config, ir)."""
    scene = Scene()
    scene.add_mesh(heightfield_mesh(grid))
    mat = Material(name="terrain",
                   albedo=np.array([0.55, 0.45, 0.35], np.float32),
                   roughness=0.6, metallic=0.1)
    mat.compute_aniso_alphas()
    scene.add_material(mat)
    return _sky_camera_and_build(scene, res, spp, compat, bvh_depth, device)


def textured_heightfield_scene(grid: int = 708, res: int = 1024,
                               spp: int = 16, compat: bool = False,
                               bvh_depth=None, device="cuda"):
    """Config 5: ~2*(grid-1)^2 tris with a bilinear checker albedo map,
    a nearest flat normal map, the HDRI sky with a sun and one point
    light.  Returns (scene, config, ir)."""
    scene = Scene()
    scene.add_mesh(heightfield_mesh(grid))

    checker = np.zeros((64, 64, 3), np.float32)
    yy, xx = np.mgrid[0:64, 0:64]
    checker[..., 0] = ((xx // 8 + yy // 8) % 2).astype(np.float32)
    checker[..., 1] = 0.5
    checker[..., 2] = 0.3
    nmap = np.full((32, 32, 3), 0.5, np.float32)
    nmap[..., 2] = 1.0
    scene.add_texture(Texture("checker", checker, Texture.FILTER_BILINEAR))
    scene.add_texture(Texture("nmap", nmap, Texture.FILTER_NONE))

    mat = Material(name="terrain", roughness=0.6, metallic=0.1)
    mat.albedo_map = "checker"
    mat.normal_map = "nmap"
    mat.compute_aniso_alphas()
    scene.add_material(mat)
    scene.pair_textures()
    scene.add_point_light(PointLight(
        position=np.array([1.5, 3.0, -1.0], np.float32),
        radiance=np.array([6.0, 5.5, 5.0], np.float32)))
    return _sky_camera_and_build(scene, res, spp, compat, bvh_depth, device)
