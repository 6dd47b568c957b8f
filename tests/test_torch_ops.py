"""PyTorch port, ops: camera, samplers, spherical maps, Disney BRDF, the
HDRI samplers, hit attributes and the ray sort against the JAX package
on the same numpy inputs.

Float results within rtol 1e-5 / atol 1e-6: both packages run the same
float32 ops in the same order, but the transcendentals (sin, cos, acos,
atan2, log, pow) come from different libraries and may differ in the
last ulps.  Integer results (texels, sort keys, permutations) are exact.
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevenrender_tpu.ops import camera as jcam
from elevenrender_tpu.ops import disney as jdis
from elevenrender_tpu.ops import hdri as jhdri
from elevenrender_tpu.ops import intersect as jint
from elevenrender_tpu.ops import sampling as jsam
from elevenrender_tpu.ops import sort as jsort
from elevenrender_tpu.ops import texture as jtex
from elevenrender_tpu.scene.hdri import HDRI as JaxHDRI
from elevenrender_tpu.scene.texture import Texture as JaxTexture
from elevenrender_tpu_torch.ops import camera as tcam
from elevenrender_tpu_torch.ops import disney as tdis
from elevenrender_tpu_torch.ops import hdri as thdri
from elevenrender_tpu_torch.ops import intersect as tint
from elevenrender_tpu_torch.ops import sampling as tsam
from elevenrender_tpu_torch.ops import sort as tsort
from elevenrender_tpu_torch.ops import texture as ttex

RTOL, ATOL = 1e-5, 1e-6
N = 1000


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _u(n=N, seed=0, k=1):
    r = np.random.default_rng(seed).uniform(size=(k, n)).astype(np.float32)
    return r[0] if k == 1 else r


def _unit(n=N, seed=0):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _T(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("bokeh", [False, True])
def test_camera_ray(bokeh):
    cam_np = {"position": np.array([0.3, 1.5, -4.0], np.float32),
              "rotation": np.array([15.0, -20.0, 5.0], np.float32),
              "focal_length": np.float32(0.035),
              "sensor_width": np.float32(0.036),
              "sensor_height": np.float32(0.024),
              "aperture": np.float32(0.15),
              "focus_distance": np.float32(3.5)}
    x = np.arange(N, dtype=np.int32) % 40
    y = np.arange(N, dtype=np.int32) // 40
    r = _u(seed=1, k=5)
    jc = {k: jnp.asarray(v) for k, v in cam_np.items()}
    tc = {k: _T(v) for k, v in cam_np.items()}
    jc["bokeh"] = tc["bokeh"] = bokeh
    jo, jd = jcam.camera_ray(jc, 40, 25, jnp.asarray(x), jnp.asarray(y),
                             *map(jnp.asarray, r))
    to, td = tcam.camera_ray(tc, 40, 25, _T(x), _T(y), *map(_T, r))
    _close(to, jo)
    _close(td, jd)


@pytest.mark.parametrize("name", ["uniform_circle_sampling",
                                  "uniform_sample_sphere",
                                  "cosine_sample_hemisphere",
                                  "importance_sample_ggx"])
def test_samplers(name):
    r = _u(seed=2, k=3)
    if name == "uniform_circle_sampling":
        args = r
    elif name == "importance_sample_ggx":
        args = (r[0] * 0.9, r[1], r[2])
    else:
        args = r[:2]
    want = getattr(jsam, name)(*map(jnp.asarray, args))
    got = getattr(tsam, name)(*map(_T, args))
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_spherical_maps():
    d = _unit(seed=3)
    ju, jv = jtex.spherical_mapping(jnp.asarray(d))
    tu, tv = ttex.spherical_mapping(_T(d))
    _close(tu, ju)
    _close(tv, jv)
    uv = _u(seed=4, k=2)
    _close(ttex.reverse_spherical_mapping(*map(_T, uv)),
           jtex.reverse_spherical_mapping(*map(jnp.asarray, uv)))


def _hitdata(seed=5):
    rng = np.random.default_rng(seed)
    n = _unit(seed=seed)
    t = np.cross(n, _unit(seed=seed + 1))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)

    def s(lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, N).astype(np.float32)

    hd = {"albedo": rng.uniform(0, 1, (N, 3)).astype(np.float32),
          "tangent": t.astype(np.float32), "bitangent": b.astype(np.float32),
          "roughness": s(0.01, 1.0), "metallic": s(), "anisotropic": s(),
          "clearcoat": s(), "clearcoatGloss": s(), "specular": s(),
          "specularTint": s(), "sheen": s(), "sheenTint": s(),
          "subsurface": s(), "transmission": s(0.0, 1.2)}
    wo = _unit(seed=seed + 2)
    wi = _unit(seed=seed + 3)
    # Put most directions in the upper hemisphere so the lobes are live.
    wo = np.where((wo * n).sum(-1, keepdims=True) < 0, -wo, wo)
    flip = rng.uniform(size=(N, 1)) < 0.8
    wi = np.where(flip & ((wi * n).sum(-1, keepdims=True) < 0), -wi, wi)
    return hd, n, wo.astype(np.float32), wi.astype(np.float32)


@pytest.mark.parametrize("fn", ["disney_eval", "disney_pdf", "disney_sample"])
def test_disney(fn):
    hd, n, wo, wi = _hitdata()
    jhd = {k: jnp.asarray(v) for k, v in hd.items()}
    thd = {k: _T(v) for k, v in hd.items()}
    if fn == "disney_sample":
        r = _u(seed=9, k=3)
        want = jdis.disney_sample(jhd, jnp.asarray(wo), jnp.asarray(n),
                                  *map(jnp.asarray, r))
        got = tdis.disney_sample(thd, _T(wo), _T(n), *map(_T, r))
    else:
        want = getattr(jdis, fn)(jhd, jnp.asarray(wo), jnp.asarray(n),
                                 jnp.asarray(wi))
        got = getattr(tdis, fn)(thd, _T(wo), _T(n), _T(wi))
    _close(got, want)


def _env():
    img = np.random.default_rng(6).uniform(0, 1, (16, 32, 3)).astype(
        np.float32)
    img[3, 8] = [50.0, 45.0, 40.0]
    jenv = jhdri.pack_hdri(JaxHDRI(JaxTexture("sky", img)), alias_table=True)
    tenv = {k: _T(v) for k, v in jenv.items() if k != "alias_packed"}
    tenv["alias_idx"] = tenv["alias_idx"].long()
    return jenv, tenv


@pytest.mark.parametrize("fn", ["sample_env_alias", "sample_env_exact",
                                "sample_env", "env_pdf", "env_pdf_uv",
                                "env_fetch_pdf_uv", "env_fetch_uv",
                                "env_radiance", "balance_heuristic"])
def test_hdri_samplers(fn):
    jenv, tenv = _env()
    r = _u(seed=7, k=2)
    r[0, :4] = [0.0, 1.0, 0.5, 1e-9]
    if fn in ("sample_env_alias",):
        args = r
    elif fn in ("sample_env_exact", "sample_env"):
        args = r[:1]
    elif fn == "env_pdf":
        x = (r[0] * 32).astype(np.int32)
        y = (r[1] * 16).astype(np.int32) + 1  # corner theta is 0 at y = 0
        args = (x, np.minimum(y, 15))
    elif fn == "env_radiance":
        args = (_unit(seed=8),)
    elif fn == "balance_heuristic":
        a = r[0] * 3.0
        a[:10] = 0.0
        b = r[1] * 2.0
        b[5:15] = np.inf
        args = (a, b)
    else:
        args = r
    if fn == "balance_heuristic":
        want = jhdri.balance_heuristic(*map(jnp.asarray, args))
        got = thdri.balance_heuristic(*map(_T, args))
    else:
        want = getattr(jhdri, fn)(jenv, *map(jnp.asarray, args))
        got = getattr(thdri, fn)(tenv, *map(_T, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        if np.issubdtype(np.asarray(w).dtype, np.integer):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w)


def _tris(seed=10):
    """Well-shaped tris (equilateral, random orientation) with mesh-like
    attributes: normals near the face normal, unit tangents in its
    plane.  Thin tris or nearly cancelling normals would turn last-ulp
    differences into 1e-5 ones (XLA's CPU backend fuses multiply-adds
    into FMA; the port rounds each op)."""
    rng = np.random.default_rng(seed)
    a = _unit(seed=seed)
    b = np.cross(a, _unit(seed=seed + 1))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    c = rng.uniform(-0.5, 0.5, (N, 3))
    verts = np.stack([c + 0.3 * a,
                      c + 0.3 * (-0.5 * a + 0.866 * b),
                      c + 0.3 * (-0.5 * a - 0.866 * b)], 1).astype(np.float32)
    fn = np.cross(a, b)
    normals = (fn[:, None, :]
               + rng.normal(0, 0.2, (N, 3, 3))).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    uvs = rng.uniform(size=(N, 3, 2)).astype(np.float32)
    tangents = (a[:, None, :]
                + rng.normal(0, 0.2, (N, 3, 3))).astype(np.float32)
    tangents /= np.linalg.norm(tangents, axis=-1, keepdims=True)
    sign = np.where(rng.uniform(size=N) < 0.5, -1.0, 1.0).astype(np.float32)
    mat = rng.integers(0, 3, N).astype(np.int32)
    return verts, normals, uvs, tangents, sign, mat


def test_full_hit_from_packed_rows():
    cols = _tris()
    verts = cols[0]
    bary = _u(seed=11, k=2) * 0.5
    target = (verts[:, 0] + (verts[:, 1] - verts[:, 0]) * bary[0][:, None]
              + (verts[:, 2] - verts[:, 0]) * bary[1][:, None])
    # Rays from well off each tri's plane: no hit is grazing.
    fn = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
    o = (target + fn * 1.0 + _unit(seed=12) * 0.25).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    idx = np.random.default_rng(13).permutation(N).astype(np.int32)
    o, d = o[idx], d[idx]  # ray i aims at tri idx[i]
    jtris = {k: jnp.asarray(v) for k, v in zip(
        ("verts", "normals", "uvs", "tangents", "sign", "mat"), cols)}
    jtris["packed"] = jnp.asarray(jint.pack_tri_attributes(*cols))
    want = jint.full_hit(jnp.asarray(o), jnp.asarray(d),
                         jint.gather_tri(jtris, jnp.asarray(idx)))
    ttris = {"verts": _T(verts),
             "packed": _T(tint.pack_tri_attributes(*cols))}
    got = tint.full_hit(_T(o), _T(d),
                        tint.gather_tri(ttris, _T(idx).long()))
    assert bool(got["valid"].all())
    for k in want:
        if k in ("valid", "mat"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("dir_major,dir_bits", [(False, 3), (True, 3),
                                                (True, 6)])
def test_sort_keys_and_order_exact(dir_major, dir_bits):
    rng = np.random.default_rng(14)
    o = rng.uniform(-2, 2, (4096, 3)).astype(np.float32)
    o[:50] = o[50:100]  # duplicate keys exercise the stable order
    d = _unit(4096, seed=15)
    d[100:110, 0] = 0.0
    mask = rng.uniform(size=4096) < 0.8
    bmin = np.array([-2.0, -1.0, -2.0], np.float32)
    bmax = np.array([2.0, 1.5, 2.0], np.float32)
    jk = jsort.morton_key(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bmin),
                          jnp.asarray(bmax), dir_major=dir_major,
                          dir_bits=dir_bits)
    tk = tsort.morton_key(_T(o), _T(d), _T(bmin), _T(bmax),
                          dir_major=dir_major, dir_bits=dir_bits)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    jo, ji = jsort.sort_for_packets(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(bmin), jnp.asarray(bmax),
                                    mask=jnp.asarray(mask),
                                    dir_major=dir_major, dir_bits=dir_bits)
    to, ti = tsort.sort_for_packets(_T(o), _T(d), _T(bmin), _T(bmax),
                                    mask=_T(mask), dir_major=dir_major,
                                    dir_bits=dir_bits)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_counting_sort_is_not_ported_yet():
    """The name dates from when ``impl="counting"`` raised; it is ported
    now: it sorts, and only an unknown ``impl`` raises."""
    z = torch.zeros((8, 3))
    order, inverse = tsort.sort_for_packets(z, z, z[0], z[0] + 1,
                                            impl="counting")
    np.testing.assert_array_equal(order.numpy(), np.arange(8))
    np.testing.assert_array_equal(inverse.numpy(), np.arange(8))
    with pytest.raises(ValueError, match="sort_impl"):
        tsort.sort_for_packets(z, z, z[0], z[0] + 1, impl="radix")


@pytest.mark.parametrize("n", [2048, 5000, 100_001])
@pytest.mark.parametrize("bits", [8, 5])
def test_counting_order_equals_jax(n, bits):
    """(order, inverse) equal the JAX function's integer for integer, at a
    size that is a multiple of its chunk and at two that are not; a stable
    sort by the top ``bits`` bits with ``inverse[order[i]] = i``."""
    key = np.random.default_rng(n).integers(0, 1 << 32, n, dtype=np.uint32)
    jo, ji = jsort.counting_order(jnp.asarray(key), bits=bits, chunk=2048)
    to, ti = tsort.counting_order(_T(key.astype(np.int64)), bits=bits)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[to.numpy()], np.arange(n))
    bucket = (key >> (32 - bits))[to.numpy()].astype(np.int64)
    assert (np.diff(bucket) >= 0).all()
    same = np.diff(bucket) == 0
    assert (np.diff(to.numpy())[same] > 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dir_major", [False, True])
def test_counting_sort_for_packets_equals_jax(masked, dir_major):
    n = 5000  # not a multiple of the reference's chunk of 2048
    rng = np.random.default_rng(16)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    o[:50] = o[50:100]
    d = _unit(n, seed=17)
    mask = rng.uniform(size=n) < 0.8 if masked else None
    bmin = np.array([-2.0, -1.0, -2.0], np.float32)
    bmax = np.array([2.0, 1.5, 2.0], np.float32)
    jo, ji = jsort.sort_for_packets(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(bmin), jnp.asarray(bmax),
        mask=None if mask is None else jnp.asarray(mask),
        dir_major=dir_major, impl="counting")
    to, ti = tsort.sort_for_packets(
        _T(o), _T(d), _T(bmin), _T(bmax),
        mask=None if mask is None else _T(mask), dir_major=dir_major,
        impl="counting")
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if masked:  # the dead lanes share the last bucket, in their own order
        dead = np.nonzero(~mask)[0]
        assert (np.diff(ti.numpy()[dead]) > 0).all()


@pytest.mark.parametrize("fn", ["gtr2", "dielectric_fresnel"])
def test_gtr2_and_dielectric_fresnel(fn):
    """The two Disney helpers no render path calls, on the same inputs;
    eta spans 0.4..2.5, so the Fresnel term meets total internal
    reflection."""
    r = _u(seed=11, k=2)
    x = r[0]
    y = (0.001 + r[1]) if fn == "gtr2" else (0.4 + 2.1 * r[1])
    want = np.asarray(getattr(jdis, fn)(jnp.asarray(x), jnp.asarray(y)))
    got = getattr(tdis, fn)(_T(x), _T(y)).numpy()
    _close(got, want)
    if fn == "dielectric_fresnel":
        tir = y * y * (1.0 - x * x) > 1.0
        assert tir.any() and (got[tir] == 1.0).all()


def test_binary_search_host_equals_jax_and_the_device_search():
    cdf = np.concatenate([[0.0], np.cumsum(
        np.random.default_rng(12).uniform(0, 1, 63))]).astype(np.float32)
    cdf /= cdf[-1]
    values = np.concatenate([_u(200, seed=13), cdf[[0, 5, 17, 63]],
                             [1.0, 0.0]]).astype(np.float32)
    got = [thdri.binary_search_host(cdf, float(v), 64) for v in values]
    want = [jhdri.binary_search_host(cdf, float(v), 64) for v in values]
    assert got == want
    dev = thdri.binary_search(torch.tensor(cdf), torch.tensor(values), 64)
    assert dev.tolist() == got
