"""PyTorch port, the OBJ/MTL loader and the wire-JSON parsers: the port's
copies must give exactly what the JAX package gives for the same text.

The texts are ``tests/test_objloader.py``'s inline ones, the Cornell box
and a grid-12 heightfield written by ``scene/demo.mesh_obj_text``; all
stay below the JAX package's 2 MB threshold for its C++ tokenizer, so
both sides run the Python tokenizer.  Every array is compared exactly.
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import dataclasses

import numpy as np
import pytest

from elevenrender_tpu.scene.camera import Camera as JaxCamera
from elevenrender_tpu.scene.material import Material as JaxMaterial
from elevenrender_tpu.scene.objloader import load_objs as jax_load_objs
from elevenrender_tpu.scene.objloader import parse_mtl as jax_parse_mtl
from elevenrender_tpu_torch.scene import demo
from elevenrender_tpu_torch.scene.camera import Camera
from elevenrender_tpu_torch.scene.material import Material
from elevenrender_tpu_torch.scene.objloader import load_objs, parse_mtl

from scenes import CORNELL_OBJ
from test_objloader import QUAD_OBJ

MESH_FIELDS = ("verts", "normals", "uvs", "tangents", "tangent_signs")

TEXTS = {
    "quad": QUAD_OBJ,
    "negative_indices": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n",
    "no_normals": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "cornell": CORNELL_OBJ,
    "groups_and_pentagon": """
# two shapes, a fan over a pentagon, partial uvs, vt before v
g first
usemtl a
vt 0.25 0.5
v 0 0 0
v 1 0 0
v 1.5 1 0
v 0.5 1.7 0.25
v -0.5 1 0
f 1/1 2 3 4 5
o second
usemtl b
v 0 0 1
v 1 0 1
v 0 1 1
vn 0 0 -1
f 6//1 7//1 8//1
usemtl a
f 8 7 6
""",
    "heightfield": demo.mesh_obj_text(demo.heightfield_mesh(12)),
}

MTL = """
newmtl wood
Kd 0.6 0.4 0.2
Ks 0.3 0.3 0.3
Ke 0 0 0
Ni 1.45
d 0.9
map_Kd wood.png
# comment
newmtl metal
Kd 0.9 0.9 0.9
Ke 1 2 3
newmtl
"""


def _assert_same_material(got, ref):
    a, b = dataclasses.asdict(got), dataclasses.asdict(ref)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("recompute", [False, True])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_load_objs_equals_jax(name, recompute):
    got, got_m = load_objs(TEXTS[name], mtl_text=MTL,
                           recompute_normals=recompute)
    ref, ref_m = jax_load_objs(TEXTS[name], mtl_text=MTL,
                               recompute_normals=recompute)
    assert len(got) == len(ref) >= 1
    for g, r in zip(got, ref):
        assert g.name == r.name
        assert g.mat_names == r.mat_names
        assert g.tri_count == r.tri_count
        for k in MESH_FIELDS:
            a, b = getattr(g, k), getattr(r, k)
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert len(got_m) == len(ref_m) == 3
    for g, r in zip(got_m, ref_m):
        _assert_same_material(g, r)


def test_load_objs_reads_paths_and_files(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text(QUAD_OBJ)
    for src in (str(path), QUAD_OBJ.encode()):
        got, _ = load_objs(src)
        ref, _ = jax_load_objs(src)
        np.testing.assert_array_equal(got[0].verts, ref[0].verts)
    with open(path, "rb") as f:
        got, _ = load_objs(f)
    assert got[0].mat_names == ["m1", "m1"]
    with pytest.raises(TypeError):
        load_objs(12)


def test_heightfield_obj_round_trips_exactly():
    """What the server is streamed: the demo mesh, written as OBJ text,
    loads back bit for bit (geometric normals, as the mesh has)."""
    mesh = demo.heightfield_mesh(12)
    got, _ = load_objs(demo.mesh_obj_text(mesh))
    assert len(got) == 1 and got[0].name == "heightfield"
    assert got[0].mat_names == mesh.mat_names
    for k in MESH_FIELDS:
        np.testing.assert_array_equal(getattr(got[0], k), getattr(mesh, k),
                                      err_msg=k)


def test_parse_mtl_equals_jax():
    got, ref = parse_mtl(MTL), jax_parse_mtl(MTL)
    assert [m.name for m in got] == ["wood", "metal", ""]
    for g, r in zip(got, ref):
        _assert_same_material(g, r)


def test_mesh_translate_and_recompute_normals_equal_jax():
    got, _ = load_objs(CORNELL_OBJ)
    ref, _ = jax_load_objs(CORNELL_OBJ)
    for g, r in zip(got, ref):
        g.translate([0.5, -1.0, 2.0])
        r.translate([0.5, -1.0, 2.0])
        g.recompute_normals()
        r.recompute_normals()
        np.testing.assert_array_equal(g.verts, r.verts)
        np.testing.assert_array_equal(g.normals, r.normals)


CAMERA = {"position": {"x": 0.0, "y": 1.5, "z": -4.0},
          "rotation": {"x": 15.0, "y": 0.0, "z": 0.0},
          "focal_length": 0.05, "sensor_width": 0.036,
          "sensor_height": 0.024, "aperture": 1.8, "focus_distance": 3.5,
          "bokeh": True}


def test_camera_from_json_equals_jax():
    got, ref = Camera.from_json(CAMERA), JaxCamera.from_json(CAMERA)
    a, b = dataclasses.asdict(got), dataclasses.asdict(ref)
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
    with pytest.raises(KeyError):
        Camera.from_json({k: v for k, v in CAMERA.items() if k != "bokeh"})


@pytest.mark.parametrize("obj", [
    {"name": "terrain", "albedo": {"r": 0.55, "g": 0.45, "b": 0.35},
     "roughness": 0.6, "metalness": 0.1},
    {"name": "lamp", "albedo": {"r": 0, "g": 0, "b": 0},
     "emission": {"r": 10, "g": 9, "b": 8}, "specular": 0.2,
     "opacity": 0.5, "transmission": 0.25, "albedo_map": "wood.png",
     "normal_map": "n.png", "albedo_shader_id": 2},
    {},
])
def test_material_from_json_equals_jax(obj):
    got, ref = Material.from_json(obj), JaxMaterial.from_json(obj)
    _assert_same_material(got, ref)
    if "metalness" in obj:
        assert got.metallic == pytest.approx(obj["metalness"])
