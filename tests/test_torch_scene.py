"""PyTorch port, host scene layer: its own numpy copies of the BVH
build, the HDRI packing and build_ir must give exactly what the JAX
package gives for the same scene."""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import dataclasses

import numpy as np
import jax
import pytest

from elevenrender_tpu.ops.bvh import build_bvh as jax_build_bvh
from elevenrender_tpu.ops.hdri import pack_hdri as jax_pack_hdri
from elevenrender_tpu.scene.hdri import HDRI as JaxHDRI
from elevenrender_tpu.scene.texture import Texture as JaxTexture
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.ops.bvh import build_bvh
from elevenrender_tpu_torch.ops.hdri import pack_hdri
from elevenrender_tpu_torch.scene import demo
from elevenrender_tpu_torch.scene.hdri import HDRI
from elevenrender_tpu_torch.scene.texture import Texture

from scenes import heightfield_scene, textured_heightfield_scene
from test_pallas import random_scene


@pytest.mark.parametrize("n_tris,depth,seed", [(37, None, 0),
                                               (300, None, 1),
                                               (1000, None, 2),
                                               (500, 6, 3)])
def test_build_bvh_equals_jax_numpy_build(n_tris, depth, seed):
    tris, _, _ = random_scene(n_tris, 1, seed=seed)
    ref = jax_build_bvh(tris, depth=depth, use_native=False)
    got = build_bvh(tris, depth=depth)
    assert got["depth"] == ref["depth"]
    assert got["max_leaf"] == ref["max_leaf"]
    for k in ("perm", "node_from", "node_to", "node_bmin", "node_bmax"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_build_bvh_heightfield_equals_jax():
    verts = demo.heightfield_mesh(40).verts
    ref = jax_build_bvh(verts, use_native=False)
    got = build_bvh(verts)
    assert (got["depth"], got["max_leaf"]) == (ref["depth"], ref["max_leaf"])
    for k in ("perm", "node_from", "node_to", "node_bmin", "node_bmax"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("shape", [(16, 32, 3), (1, 1, 3), (9, 7, 1)])
def test_pack_hdri_equals_jax(shape):
    img = np.random.default_rng(4).uniform(0, 2, shape).astype(np.float32)
    img[0, 0] = 40.0
    got = pack_hdri(HDRI(Texture("sky", img)), alias_table=True)
    ref = jax_pack_hdri(JaxHDRI(JaxTexture("sky", img)), alias_table=True)
    for k in ("img", "cdf", "rsum", "alias_prob", "alias_idx"):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(ref[k]), err_msg=k)


def test_build_ir_equals_converted_jax_ir(monkeypatch):
    """The port's own scene build (scene/demo.py) against the JAX
    package's build of the same heightfield, carried across by
    ir_from_numpy; the JAX side uses its numpy BVH build."""
    monkeypatch.setenv("ELEVENRT_NATIVE", "0")
    _assert_same_build(heightfield_scene, demo.heightfield_scene)


def test_textured_build_ir_equals_converted_jax_ir(monkeypatch):
    """The same for config 5's scene in miniature: the atlas, the
    material's texture ids and the point light come across too."""
    monkeypatch.setenv("ELEVENRT_NATIVE", "0")
    ir_p = _assert_same_build(textured_heightfield_scene,
                              demo.textured_heightfield_scene)
    assert ir_p["atlas"]["data"].shape == (64 * 64 + 32 * 32, 4)
    assert ir_p["materials"]["tex"][0].tolist() == [0, -1, -1, -1, 1, -1, -1]


def _assert_same_build(jax_build, port_build):
    _, jcfg, jir = jax_build(grid=24, res=16, compat=False)
    cfg_c, ir_c = ir_from_numpy(dataclasses.asdict(jcfg),
                                jax.tree.map(np.asarray, jir), device="cpu")
    _, cfg_p, ir_p = port_build(grid=24, res=16, compat=False, device="cpu")
    for f in ("x_res", "y_res", "bvh_depth", "bvh_max_leaf", "bokeh",
              "n_lights", "tex_slots_used", "tex_uniform_filter",
              "use_shaders", "compat", "sample_target"):
        assert getattr(cfg_p, f) == getattr(cfg_c, f), f
    assert ir_p.keys() == ir_c.keys()
    for grp in ir_p:
        assert ir_p[grp].keys() == ir_c[grp].keys(), grp
        for k in ir_p[grp]:
            np.testing.assert_array_equal(ir_p[grp][k].numpy(),
                                          ir_c[grp][k].numpy(),
                                          err_msg=f"{grp}.{k}")
    return ir_p


def test_render_config_has_the_jax_fields_and_defaults():
    from elevenrender_tpu.scene.ir import RenderConfig as JaxConfig
    from elevenrender_tpu_torch.scene.ir import RenderConfig
    assert (dataclasses.asdict(RenderConfig())
            == dataclasses.asdict(JaxConfig()))
    assert ([f.name for f in dataclasses.fields(RenderConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])


@pytest.mark.parametrize("shape", [(16, 32, 3), (9, 7, 1)])
def test_hdri_pdf_and_sample_equal_jax(shape):
    img = np.random.default_rng(8).uniform(0, 2, shape).astype(np.float32)
    img[2, 3] = 40.0
    got = HDRI(Texture("sky", img))
    ref = JaxHDRI(JaxTexture("sky", img))
    h, w = shape[:2]
    for y in range(1, h):
        for x in range(0, w, 3):
            assert got.pdf(x, y) == ref.pdf(x, y), (x, y)
    for r1 in np.concatenate([np.random.default_rng(9).uniform(size=300),
                              got.cdf[[0, 1, 7]], [1.0]]):
        assert got.sample(float(r1)) == ref.sample(float(r1)), r1


def _welded_mesh(seed):
    """A 6 x 6 grid of quads whose corners weld, with -0.0 beside 0.0 in
    the welded keys, mirrored UVs on some faces, every face repeated
    once, and faces of zero area and of zero UV area."""
    rng = np.random.default_rng(seed)
    g = 7
    xs, ys = np.meshgrid(np.arange(g, dtype=np.float64),
                         np.arange(g, dtype=np.float64), indexing="ij")
    pos = np.stack([xs, ys, np.zeros_like(xs)], -1)
    pos[rng.uniform(size=(g, g)) < 0.5, 2] = -0.0
    uv = np.stack([xs, ys], -1) / (g - 1)
    tris, tuv = [], []
    for i in range(g - 1):
        for j in range(g - 1):
            c = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
            for a, b, d in ((0, 1, 2), (0, 2, 3)):
                tris.append([pos[c[k]] for k in (a, b, d)])
                tuv.append([uv[c[k]] for k in (a, b, d)])
    verts, uvs = np.array(tris), np.array(tuv)
    mirror = rng.uniform(size=len(uvs)) < 0.3
    uvs[mirror, :, 0] = 1.0 - uvs[mirror, :, 0]
    verts, uvs = np.concatenate([verts, verts]), np.concatenate([uvs, uvs])
    verts[3, 2] = verts[3, 1]          # zero area
    uvs[5, 1] = uvs[5, 0]
    uvs[5, 2] = uvs[5, 0]              # zero UV area
    normals = np.zeros_like(verts)
    normals[..., 2] = 1.0
    normals[rng.uniform(size=normals.shape[:2]) < 0.5, 0] = -0.0
    return verts, uvs, normals


def _heightfield_corners(grid):
    verts = demo.heightfield_tris(grid, 0).astype(np.float64)
    fn = np.cross(verts[:, 2] - verts[:, 0], verts[:, 1] - verts[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-12)
    normals = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    uvs = np.stack([(verts[..., 0] + 2) / 4, (verts[..., 2] + 2) / 4], -1)
    return verts, uvs.astype(np.float32), normals


@pytest.mark.parametrize("mesh", ["heightfield", "welds_mirrors_degenerates"])
def test_compute_tangents_equals_jax(mesh):
    """The port's weld groups by a hash sort, the JAX package's by a sort
    of records: the same tangents and signs bit for bit."""
    from elevenrender_tpu.scene.tangents import (
        compute_tangents as jax_compute_tangents)
    from elevenrender_tpu_torch.scene.tangents import compute_tangents
    args = (_heightfield_corners(40) if mesh == "heightfield"
            else _welded_mesh(3))
    got, want = compute_tangents(*args), jax_compute_tangents(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("case", ["signed_zeros", "nan_rows", "collision"])
def test_weld_groups_rows_as_the_record_sort_does(case, monkeypatch):
    """``_weld`` puts two rows in one group exactly when the sort of
    records does: -0.0 beside 0.0, NaN rows (never equal), and a hash
    that makes every row collide (the exact sort decides)."""
    from elevenrender_tpu_torch.scene import tangents
    rng = np.random.default_rng(5)
    key = rng.integers(0, 3, (400, 5)).astype(np.float64)
    key[rng.uniform(size=key.shape) < 0.3] *= -1.0  # -0.0 where 0
    if case == "nan_rows":
        key[[7, 8, 9], 2] = np.nan
        key[8] = key[7]
    if case == "collision":
        monkeypatch.setattr(tangents, "_HASH_MUL", np.uint64(0))
    keyv = np.ascontiguousarray(key).view([("", key.dtype)] * key.shape[1])
    want = np.unique(keyv, return_inverse=True)[1].reshape(-1)
    got = tangents._weld(key)
    pairs = np.unique(np.stack([got, want], 1), axis=0)
    assert len(pairs) == len(np.unique(got)) == len(np.unique(want))
