"""The system under test: the raw scene handed to the port.

The port builds its scene as a user's script builds one: a ``Scene``
with one ``MeshData``, its ``Material`` (maps paired by name), its
``Texture``s, the HDRI, the camera and the point lights, then
``Scene.build`` on the card, which makes the port's own tables (BVH,
traversal tables, texel atlas, alias table).  Native mode, with the
configuration's bounces.  This is the only module of the harness that
imports the port, and only inside its functions.
"""

from __future__ import annotations

import numpy as np

SLOT_NAMES = ("albedo", "emission", "roughness", "metallic", "normal",
              "opacity", "transmission")


def build(raw: dict, device):
    """(RenderConfig, IR on ``device``) of the raw scene."""
    from elevenrender_tpu_torch.scene.hdri import HDRI
    from elevenrender_tpu_torch.scene.material import Material
    from elevenrender_tpu_torch.scene.mesh import MeshData
    from elevenrender_tpu_torch.scene.scene import PointLight, Scene
    from elevenrender_tpu_torch.scene.texture import Texture

    scene = Scene()
    mesh = raw["mesh"]
    names = [m["name"] for m in raw["materials"]]
    scene.add_mesh(MeshData(
        name="mesh", verts=mesh["verts"], normals=mesh["normals"],
        uvs=mesh["uvs"], tangents=mesh["tangents"],
        tangent_signs=mesh["sign"],
        mat_names=[names[i] for i in mesh["mat"].tolist()]))
    for name, (data, filt) in zip(raw["texture_names"], raw["textures"]):
        scene.add_texture(Texture(name, data, filt))
    for m in raw["materials"]:
        mat = Material(name=m["name"])
        for key in ("albedo", "emission"):
            setattr(mat, key, np.asarray(m[key], np.float32))
        for key in ("opacity", "roughness", "metallic", "clearcoat_gloss",
                    "clearcoat", "anisotropic", "eta", "transmission",
                    "specular", "specular_tint", "sheen_tint", "subsurface",
                    "sheen"):
            setattr(mat, key, float(m[key]))
        for slot, tex in m["maps"].items():
            setattr(mat, f"{slot}_map", raw["texture_names"][tex])
        mat.compute_aniso_alphas()
        scene.add_material(mat)
    scene.pair_textures()
    for light in raw["lights"]:
        scene.add_point_light(PointLight(
            position=np.asarray(light["position"], np.float32),
            radiance=np.asarray(light["radiance"], np.float32)))
    scene.add_hdri(HDRI(Texture("sky", raw["env"])))
    cam = raw["camera"]
    scene.camera.position = np.asarray(cam["position"], np.float32)
    scene.camera.rotation = np.asarray(cam["rotation"], np.float32)
    for key in ("focal_length", "sensor_width", "sensor_height", "aperture",
                "focus_distance"):
        setattr(scene.camera, key, float(cam[key]))
    scene.camera.bokeh = bool(cam["bokeh"])
    scene.x_res, scene.y_res = raw["x_res"], raw["y_res"]
    config, ir = scene.build(device=device)
    config = config.replace(compat=False, max_bounces=raw["bounces"],
                            clamp_radiance=float(raw["clamp_radiance"]))
    return config, ir
