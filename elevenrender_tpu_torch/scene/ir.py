"""Scene IR: the flat dict of device tensors a render reads.

The port's copy of ``elevenrender_tpu/scene/ir.py``.  ``RenderConfig``
has the JAX package's fields and defaults, so a config converts across
unchanged (``convert.ir_from_numpy``); fields that tune TPU-only
machinery are accepted and documented as not read.  ``build_ir``
flattens a host ``Scene`` into:

  tris      verts/normals/uvs/tangents/sign/mat in BVH leaf order, plus
            the packed [T, 40] attribute row the shading gather reads
  bvh       node_bmin/node_bmax [NN, 3], node_from/node_to [NN]
  kernel    the CUDA traversal's tables (ops/traverse.pack_tables)
  materials the material SoA table (texture ids per map slot, shader id)
  atlas     every texture as [P, 4] texel rows plus off/w/h/ch/filter
            (ops/texture.pack_atlas)
  env       img, cdf, rsum, alias_prob, alias_idx
  camera    position, rotation and the lens scalars
  lights    pos, rad

The JAX package's 128-lane ``bvh_packed`` tables are TPU layout and are
not part of this IR.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import spans
from ..core.device import resolve_device
from ..ops.bvh import build_bvh
from ..ops.hdri import pack_hdri
from ..ops.intersect import pack_tri_attributes
from ..ops.texture import FILTER_NONE, pack_atlas
from ..ops.traverse import pack_tables
from ..render.shaders import registry_version
from .material import MAP_SLOTS, Material

MAT_SCALARS = ("opacity", "roughness", "metallic", "clearcoat_gloss",
               "clearcoat", "anisotropic", "eta", "transmission", "specular",
               "specular_tint", "sheen_tint", "subsurface", "sheen")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration, field for field the JAX package's."""
    x_res: int = 1280
    y_res: int = 720
    sample_target: int = 100
    denoise: bool = False          # get_pass through the colour-only denoiser
    device: str = ""               # Renderer's device: "" = cuda:0, "cpu", ...
    block_size: int = 8
    passes_enabled: tuple = (True, True, True, True, True)

    bvh_depth: int = 1
    bvh_max_leaf: int = 1
    bokeh: bool = False
    n_lights: int = 0
    max_bounces: int = 5
    clamp_radiance: float = 10.0
    compat: bool = True            # replicate the reference's quirks
    use_bvh: bool = True
    # "brute" tests every tri; any other value, and "auto" above 64 tris,
    # goes through the CUDA traversal (its plain version on the CPU);
    # "pallas_wide" / "pallas_wide_stream" do so with a warning.
    trace_mode: str = "auto"
    # TPU tile widths of the Pallas kernel; not read by the port.
    packet_tile: int = 128
    pallas_sub: int = 32
    shadow_pallas_sub: int = 0
    # Variants of the traversal kernel (ops/traverse.py): child order
    # "near" | "sign", and the leaf group boxes 0 | 1 | 2.
    trace_order: str = "near"
    leaf_aabb: int = 0
    # Per-bounce Morton/octant sort of the rays before each traversal.
    sort_rays: bool = True
    sort_dir_major: bool = True
    sort_dir_bits: int = 3
    sort_impl: str = "argsort"     # | "counting": by the key's top 8 bits
    packed_sort_io: bool = True    # TPU gather layout; the port gathers
    # > 0 overrides recommended_samples_per_dispatch, the JAX package's
    # samples per jitted dispatch; no code path of the port depends on it.
    samples_per_dispatch: int = 0
    # Dedicated shadow-ray sort keyed on the NEE gate (native mode).
    shadow_sort: bool = True
    env_sampler: str = "alias"     # native env texel sampler: alias | cdf
    # Material fetch: "mm_bwd" gathers forward and multiplies by a
    # one-hot matrix backward, "onehot" multiplies both ways, "gather"
    # leaves the backward to autograd's scatter-add.
    material_fetch: str = "mm_bwd"
    # Checkpoint each bounce: the backward pass recomputes it.
    remat_bounces: bool = False
    tex_slots_used: tuple = (True, True, True, True, True, True, True)
    tex_uniform_filter: int = -1
    use_shaders: bool = True
    shader_version: int = 0
    count_rays: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def materials_to_numpy(materials) -> dict:
    """Material list -> SoA table; index 0 is the implicit default."""
    if not materials:
        materials = [Material.default()]
    M = len(materials)
    out = {
        "albedo": np.zeros((M, 3), np.float32),
        "emission": np.zeros((M, 3), np.float32),
        "tex": np.full((M, len(MAP_SLOTS)), -1, np.int32),
        "shader": np.full((M,), -1, np.int32),
    }
    for s in MAT_SCALARS:
        out[s] = np.zeros(M, np.float32)
    for i, m in enumerate(materials):
        out["albedo"][i] = m.albedo
        out["emission"][i] = m.emission
        for s in MAT_SCALARS:
            out[s][i] = getattr(m, s)
        for j, slot in enumerate(MAP_SLOTS):
            out["tex"][i, j] = getattr(m, f"{slot}_texture_id")
        out["shader"][i] = m.albedo_shader_id
    return out


def ir_to_torch(ir_np: dict, device) -> dict:
    """Numpy IR (the port's layout) -> tensors on ``device``.  Index
    tables that the render step uses to index keep int64."""
    dev = torch.device(device)

    def conv(key, a):
        t = torch.tensor(np.asarray(a), device=dev)
        if key == "alias_idx":
            t = t.to(torch.int64)
        return t

    return {grp: {k: conv(k, v) for k, v in leaves.items()}
            for grp, leaves in ir_np.items()}


def build_ir(scene, config: RenderConfig | None = None,
             bvh_depth: int | None = None,
             device="cuda") -> tuple[RenderConfig, dict]:
    """Flatten a host Scene into (RenderConfig, IR of tensors on
    ``device``)."""
    dev = resolve_device(device)
    if config is None:
        config = RenderConfig()

    verts, normals, uvs, tangents, signs, mats = [], [], [], [], [], []
    mat_index = {m.name: i for i, m in enumerate(scene.materials)}
    for mesh in scene.meshes:
        verts.append(mesh.verts)
        normals.append(mesh.normals)
        uvs.append(mesh.uvs)
        tangents.append(mesh.tangents)
        signs.append(mesh.tangent_signs)
        mats.append(np.array([mat_index.get(n, 0) for n in mesh.mat_names],
                             np.int32))
    if verts:
        verts = np.concatenate(verts)
        normals = np.concatenate(normals)
        uvs = np.concatenate(uvs)
        tangents = np.concatenate(tangents)
        signs = np.concatenate(signs)
        mats = np.concatenate(mats)
    else:
        verts = np.zeros((0, 3, 3), np.float32)
        normals = np.zeros((0, 3, 3), np.float32)
        uvs = np.zeros((0, 3, 2), np.float32)
        tangents = np.zeros((0, 3, 3), np.float32)
        signs = np.zeros(0, np.float32)
        mats = np.zeros(0, np.int32)

    with spans.span("scene.bvh"):
        bvh = build_bvh(verts, depth=bvh_depth)
    perm = bvh["perm"]
    cam = scene.camera
    materials = materials_to_numpy(scene.materials)
    ir_np = {
        "tris": {
            "verts": verts[perm], "normals": normals[perm],
            "uvs": uvs[perm], "tangents": tangents[perm],
            "sign": signs[perm], "mat": mats[perm],
            "packed": pack_tri_attributes(
                verts[perm], normals[perm], uvs[perm], tangents[perm],
                signs[perm], mats[perm]),
        },
        "bvh": {k: bvh[k] for k in ("node_bmin", "node_bmax", "node_from",
                                    "node_to")},
        "kernel": pack_tables(bvh["node_bmin"], bvh["node_bmax"],
                              bvh["node_from"], bvh["node_to"], verts[perm],
                              bvh["depth"]),
        "materials": materials,
        "atlas": pack_atlas(scene.textures),
        "env": pack_hdri(scene.hdri,
                         alias_table=(True if config.env_sampler == "alias"
                                      else None)),
        "camera": {
            "position": np.asarray(cam.position, np.float32),
            "rotation": np.asarray(cam.rotation, np.float32),
            "focal_length": np.float32(cam.focal_length),
            "sensor_width": np.float32(cam.sensor_width),
            "sensor_height": np.float32(cam.sensor_height),
            "aperture": np.float32(cam.aperture),
            "focus_distance": np.float32(cam.focus_distance),
        },
        "lights": {
            "pos": (np.stack([l.position for l in scene.point_lights])
                    if scene.point_lights else np.zeros((1, 3), np.float32)),
            "rad": (np.stack([l.radiance for l in scene.point_lights])
                    if scene.point_lights else np.zeros((1, 3), np.float32)),
        },
    }
    filters = sorted({t.filter for t in scene.textures})
    config = config.replace(
        x_res=scene.x_res, y_res=scene.y_res,
        bvh_depth=bvh["depth"], bvh_max_leaf=bvh["max_leaf"],
        bokeh=bool(scene.camera.bokeh),
        n_lights=len(scene.point_lights),
        tex_slots_used=tuple(bool(b) for b in
                             (materials["tex"] >= 0).any(axis=0)),
        tex_uniform_filter=(filters[0] if len(filters) == 1
                            else (FILTER_NONE if not filters else -1)),
        use_shaders=bool((materials["shader"] >= 0).any()),
        shader_version=registry_version(),
    )
    with spans.span("scene.upload"):
        return config, ir_to_torch(ir_np, dev)
