"""PyTorch port, textures: the host Texture, the scene's texture ids, the
atlas and its samplers against the JAX package on the same numpy inputs.

Texel indices must be equal; sampled values agree to rtol 1e-6 (NaN
where JAX gives NaN).  The float -> int32 casts are pinned where the two
frameworks differ on their own: XLA on the CPU converts toward zero,
NaN -> 0, saturating at the int32 range, while torch's bare cast gives
INT_MIN for NaN and +-inf; the port reproduces XLA's.
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevenrender_tpu.ops import texture as jtex
from elevenrender_tpu.scene.material import Material as JaxMaterial
from elevenrender_tpu.scene.scene import Scene as JaxScene
from elevenrender_tpu.scene.texture import Texture as JaxTexture
from elevenrender_tpu_torch.ops import texture as ttex
from elevenrender_tpu_torch.scene.material import Material
from elevenrender_tpu_torch.scene.scene import Scene
from elevenrender_tpu_torch.scene.texture import Texture

I32_MIN, I32_MAX = -2**31, 2**31 - 1
EDGE_FLOATS = [np.nan, np.inf, -np.inf, 3e9, -3e9, 2147483648.0,
               -2147483648.0, 2147483520.0, 1e30, -1e30, -2.7, 2.7, -0.5,
               0.0, -0.0]


def _textures():
    rng = np.random.default_rng(11)
    shapes = [(5, 7, 1), (4, 4, 2), (6, 3, 3), (3, 5, 4), (2, 2, 5)]
    filters = [0, 1, 1, 0, 1]
    return [(f"t{i}", rng.uniform(0, 1, s).astype(np.float32), f)
            for i, (s, f) in enumerate(zip(shapes, filters))]


def _atlases(textures):
    j = jtex.pack_atlas([JaxTexture(n, d, f) for n, d, f in textures])
    t = ttex.pack_atlas([Texture(n, d, f) for n, d, f in textures])
    return j, {k: torch.tensor(v) for k, v in t.items()}, t


@pytest.fixture(scope="module")
def atlas():
    return _atlases(_textures())


@pytest.fixture(scope="module")
def uv():
    """u, v in and outside [0, 1], negative, on texel edges, and the
    float edge cases; with a texture id per lane."""
    rng = np.random.default_rng(12)
    u = list(rng.uniform(-3, 4, 400)) + [0.0, 1.0, 0.5, 1 / 7, 2 / 7,
                                         -1 / 7, -1.0, 0.25] + EDGE_FLOATS
    v = list(rng.uniform(-3, 4, 400)) + [0.0, 1.0, 0.2, 0.25, -0.5, 1 / 3,
                                         -1.0, 0.75] + EDGE_FLOATS[::-1]
    u = np.array(u, np.float32)
    v = np.array(v, np.float32)
    tid = rng.integers(0, 5, u.size).astype(np.int32)
    return tid, u, v


def test_pack_atlas_equals_jax(atlas):
    j, _, t = atlas
    assert j.keys() == t.keys()
    for k in j:
        np.testing.assert_array_equal(t[k], np.asarray(j[k]), err_msg=k)
        assert t[k].dtype == np.asarray(j[k]).dtype, k
    empty_j = jtex.pack_atlas([])
    empty_t = ttex.pack_atlas([])
    for k in empty_j:
        np.testing.assert_array_equal(empty_t[k], np.asarray(empty_j[k]))


def test_float_to_int_casts_pin_xla_cpu():
    x = np.array(EDGE_FLOATS, np.float32)
    want = np.asarray(jtex._trunc_i32(jnp.asarray(x)))
    # What XLA's CPU backend returns, pinned.
    np.testing.assert_array_equal(
        want, [0, I32_MAX, I32_MIN, I32_MAX, I32_MIN, I32_MAX, I32_MIN,
               2147483520, I32_MAX, I32_MIN, -2, 2, 0, 0, 0])
    got = ttex._trunc_i32(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("m", [1, 3, 7, 8, 64])
def test_trunc_mod_abs_equals_jax(m):
    x = np.array([I32_MIN, I32_MIN + 1, I32_MAX, -65, -64, -5, -1, 0, 1, 5,
                  63, 64, 65], np.int32)
    want = np.asarray(jtex._trunc_mod_abs(jnp.asarray(x), m))
    got = ttex._trunc_mod_abs(torch.tensor(x), torch.tensor(m)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got < m).all()


def test_fetch_texel_equals_jax(atlas):
    j, t, _ = atlas
    rng = np.random.default_rng(13)
    xi = np.concatenate([rng.integers(-40, 40, 300),
                         [I32_MIN, I32_MAX, I32_MIN + 1, 0, -1]]).astype(
        np.int32)
    yi = np.concatenate([rng.integers(-40, 40, 300),
                         [I32_MAX, I32_MIN, 0, I32_MIN, -1]]).astype(np.int32)
    tid = rng.integers(0, 5, xi.size).astype(np.int32)
    want = np.asarray(jtex.fetch_texel(j, jnp.asarray(tid), jnp.asarray(xi),
                                       jnp.asarray(yi)))
    got = ttex.fetch_texel(t, torch.tensor(tid), torch.tensor(xi),
                           torch.tensor(yi)).numpy()
    np.testing.assert_array_equal(got, want)
    # Float coordinates go through the same conversion as JAX's astype.
    xf = np.array(EDGE_FLOATS, np.float32)
    tf = np.zeros(xf.size, np.int32)
    want = np.asarray(jtex.fetch_texel(j, jnp.asarray(tf), jnp.asarray(xf),
                                       jnp.asarray(xf[::-1].copy())))
    got = ttex.fetch_texel(t, torch.tensor(tf), torch.tensor(xf),
                           torch.tensor(xf[::-1].copy())).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampler", ["nearest", "bilinear", "filtered_none",
                                     "filtered_bilinear", "filtered_mixed"])
def test_samplers_equal_jax(atlas, uv, sampler):
    j, t, _ = atlas
    tid, u, v = uv
    fn = {"nearest": ("sample_nearest", {}),
          "bilinear": ("sample_bilinear", {}),
          "filtered_none": ("sample_filtered", {"uniform_filter": 0}),
          "filtered_bilinear": ("sample_filtered", {"uniform_filter": 1}),
          "filtered_mixed": ("sample_filtered", {"uniform_filter": -1})}
    name, kw = fn[sampler]
    want = np.asarray(getattr(jtex, name)(j, jnp.asarray(tid),
                                          jnp.asarray(u), jnp.asarray(v),
                                          **kw))
    got = getattr(ttex, name)(t, torch.tensor(tid), torch.tensor(u),
                              torch.tensor(v), **kw).numpy()
    assert got.shape == want.shape == (u.size, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, equal_nan=True)
    assert np.isfinite(want[:400]).all()


def test_mixed_filter_takes_each_textures_own_filter(atlas, uv):
    """The mixed 4-tap path gives the nearest sampler on nearest-filter
    textures and the bilinear one on the others."""
    _, t, _ = atlas
    tid, u, v = (torch.tensor(a[:400]) for a in uv)
    mixed = ttex.sample_filtered(t, tid, u, v)
    near = ttex.sample_nearest(t, tid, u, v)
    bil = ttex.sample_bilinear(t, tid, u, v)
    is_bil = (t["filter"][tid.long()] == 1)[:, None]
    torch.testing.assert_close(mixed, torch.where(is_bil, bil, near),
                               rtol=1e-6, atol=1e-7)


def test_host_texture_ops_equal_jax():
    rng = np.random.default_rng(14)
    raw = rng.uniform(0, 1, 6 * 5 * 4).astype(np.float32)
    for srgb in (False, True):
        j = JaxTexture.from_raw("r", 6, 5, 4, raw, 1, srgb=srgb)
        t = Texture.from_raw("r", 6, 5, 4, raw, 1, srgb=srgb)
        np.testing.assert_array_equal(t.data, j.data)
        assert (t.width, t.height, t.channels, t.filter) == \
            (j.width, j.height, j.channels, j.filter)
        for op, args in (("mirror_x", ()), ("mirror_y", ()),
                         ("pixel_shift", (0.5, 0.0)),
                         ("pixel_shift", (0.34, 0.61)),
                         ("apply_gamma", (2.2,)), ("clamp_channels", ())):
            getattr(j, op)(*args)
            getattr(t, op)(*args)
            np.testing.assert_array_equal(t.data, j.data, err_msg=op)
        for x, y in ((0, 0), (5, 4), (-3, 2), (13, -7), (-6, -5)):
            np.testing.assert_array_equal(t.value_at(x, y), j.value_at(x, y))
    grey = rng.uniform(0, 1, (3, 4, 1)).astype(np.float32)
    np.testing.assert_array_equal(Texture("g", grey).value_at(-5, 7),
                                  JaxTexture("g", grey).value_at(-5, 7))
    np.testing.assert_array_equal(Texture.from_color([0.1, 0.2, 0.3]).data,
                                  JaxTexture.from_color([0.1, 0.2, 0.3]).data)
    # from_file is ported (tests/test_torch_image_io.py reads real
    # files): a missing file raises as in the JAX package.
    for cls in (Texture, JaxTexture):
        with pytest.raises(FileNotFoundError):
            cls.from_file("no/such/albedo.png")


def test_scene_texture_ids_equal_jax():
    """Name-keyed dedupe and the pairing of all seven map slots."""
    img = np.ones((2, 2, 3), np.float32)
    ids = []
    for S, T, M in ((JaxScene, JaxTexture, JaxMaterial),
                    (Scene, Texture, Material)):
        scene = S()
        assert scene.dirty
        for name in ("a", "b", "a", "c", "b"):
            scene.add_texture(T(name, img * len(name)))
        m1 = M(name="m1")
        m1.albedo_map, m1.normal_map, m1.transmission_map = "c", "a", "b"
        m2 = M(name="m2")
        m2.roughness_map, m2.opacity_map = "b", "missing"
        m2.emission_map, m2.metallic_map = "a", "c"
        scene.add_material(m1)
        scene.add_material(m2)
        scene.pair_textures()
        slots = ("albedo", "emission", "roughness", "metallic", "normal",
                 "opacity", "transmission")
        ids.append((dict(scene.texture_ids), len(scene.textures),
                    [[getattr(m, f"{s}_texture_id") for s in slots]
                     for m in scene.materials], scene.tri_count))
    assert ids[0] == ids[1]
    assert ids[1][0] == {"a": 0, "b": 1, "c": 2}
