"""PyTorch port, the render step end to end on the CPU.

(a) Cornell 16x16 (12 tris: the brute-force trace) through the port's
    Renderer on the JAX package's IR, against the goldens at
    test_golden.py's tolerance.
(b) A grid-12 heightfield (242 tris: the traversal-kernel path, here
    its plain version) against JAX ``render_sample`` with
    ``trace_mode="pallas"`` (the Pallas kernel in interpret mode):
    sample counts equal, RNG streams equal on >= 99% of lanes, beauty
    and normal passes within rtol 1e-4 / atol 1e-5 on >= 99% of pixels
    and their means within 1e-4 relative.  Not every pixel: a path that
    meets a tri edge may take another tri when the last ulp differs (XLA
    fuses multiply-adds, the port does not), and then the rest of that
    path differs.
(c) The port's own scene build renders what the converted JAX IR does.
(d) Config 5 in miniature, ``textured_heightfield_scene(grid=24, res=16)``
    (1,058 tris: a bilinear checker albedo map, a nearest normal map, the
    sky and a point light), against JAX with ``trace_mode="pallas_stream"``
    (the stream-residency kernel in interpret mode), native with the
    merged 2N-ray shadow launch and compat, at (b)'s checks.
(e) The featured goldens (textures, normal map, opacity, bokeh, and a
    point light in native mode; 4 tris, brute force) and a material with
    an albedo shader, at test_golden.py's rtol 1e-5 / atol 1e-6: on every
    pixel against the JAX package run op by op (``jax.disable_jit``), on
    >= 99% of pixels against the goldens and the jitted JAX program, all
    others within rtol 1e-4 / atol 1e-5.  The jitted program differs from
    its own op-by-op run: XLA contracts a*b+c into FMA, and on one of the
    256 pixels of the featured scene that moves the colour by up to 7e-5
    relative; the port rounds each op as the op-by-op run does.
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import dataclasses
import os

import numpy as np
import jax
import pytest
import torch

from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu.render import shaders as jax_shaders
from elevenrender_tpu.render.integrator import render_sample as jax_render
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.ops import traverse as tt
from elevenrender_tpu_torch.render import integrator as ti
from elevenrender_tpu_torch.render import shaders as t_shaders
from elevenrender_tpu_torch.render.renderer import Renderer
from elevenrender_tpu_torch.scene import demo

from scenes import (cornell_scene, heightfield_scene,
                    textured_heightfield_scene)
from test_golden import featured_scene

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _convert(config, ir):
    return ir_from_numpy(dataclasses.asdict(config),
                         jax.tree.map(np.asarray, ir), device="cpu")


@pytest.mark.parametrize("name,compat", [("cornell_16x16_compat", True),
                                         ("cornell_16x16_native", False)])
def test_cornell_matches_golden(name, compat):
    _, config, ir = cornell_scene(res=16, spp=3, compat=compat)
    cfg, tir = _convert(config, ir)
    assert ti.resolve_trace_mode(cfg, tir) == "brute"
    r = Renderer(cfg, tir, device="cpu")
    r.step(3)
    img = r.get_pass("beauty").reshape(16, 16, 4)
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    np.testing.assert_allclose(img, ref, rtol=1e-5, atol=1e-6)
    assert r.get_render_info() == {"samples": 3}


def _heightfield(compat):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELEVENRT_NATIVE", "0")  # the numpy BVH build the port copies
        _, config, ir = heightfield_scene(grid=12, res=16, compat=compat)
    return config.replace(trace_mode="pallas", max_bounces=5), ir


def _textured(compat):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELEVENRT_NATIVE", "0")
        _, config, ir = textured_heightfield_scene(grid=24, res=16,
                                                   compat=compat)
    return config.replace(trace_mode="pallas_stream", max_bounces=5), ir


def _run_pair(config, ir, n_samples):
    """n_samples progressive samples through JAX and through the port on
    the CPU; returns (JAX state, port state, port config) as numpy."""
    state = jax_init_state(config)
    step = jax.jit(jax_render, static_argnums=0)
    for _ in range(n_samples):
        state = step(config, ir, state)
    want = jax.tree.map(np.asarray, state)

    cfg, tir = _convert(config, ir)
    assert ti.resolve_trace_mode(cfg, tir) == "bvh"
    tt.reset_counts()
    st = ti.init_state(cfg, device="cpu")
    for _ in range(n_samples):
        st = ti.render_sample(cfg, tir, st, device="cpu")
    got = {k: v.numpy() for k, v in st.items()}
    return want, got, cfg


@pytest.fixture(scope="module", params=["native", "compat"])
def heightfield_pair(request):
    compat = request.param == "compat"
    return _run_pair(*_heightfield(compat), 1 if compat else 2)


@pytest.fixture(scope="module", params=["native", "compat"])
def textured_pair(request):
    compat = request.param == "compat"
    return _run_pair(*_textured(compat), 1 if compat else 2)


def _close_frac(a, b, rtol=1e-4, atol=1e-5):
    return np.isclose(a, b, rtol=rtol, atol=atol).all(axis=-1).mean()


def test_heightfield_matches_jax_pallas(heightfield_pair):
    _check_pair(heightfield_pair)


def test_textured_heightfield_matches_jax_pallas_stream(textured_pair):
    want, got, cfg = textured_pair
    assert cfg.n_lights == 1 and cfg.tex_uniform_filter == -1
    assert cfg.tex_slots_used == (True, False, False, False, True, False,
                                  False)
    _check_pair(textured_pair)


def test_merged_shadow_launch_is_order_free():
    """The occlusion flags of the 2N-ray launch do not depend on the
    order its rays go in: the bounce permutation doubled over the two
    halves (``shadow_sort=False``) and the gate-keyed sort of the 2N
    rays (the default) render the same image."""
    config, ir = _textured(False)
    cfg, tir = _convert(config, ir)
    images = []
    for kw in ({}, {"shadow_sort": False}):
        r = Renderer(cfg.replace(**kw), tir, device="cpu")
        r.step(1)
        images.append(r.get_pass("beauty"))
    np.testing.assert_array_equal(images[0], images[1])


def _check_pair(pair):
    want, got, _ = pair
    np.testing.assert_array_equal(got["samples"], want["samples"])
    assert (got["rng"] == want["rng"].astype(np.int64)).mean() >= 0.99
    for pid in (ti.BEAUTY, ti.NORMAL):
        a, b = got["passes"][pid, :, :3], want["passes"][pid, :, :3]
        assert np.isfinite(a).all()
        assert _close_frac(a, b) >= 0.99, pid
        np.testing.assert_allclose(a.mean(), b.mean(), rtol=1e-4)
    assert got["passes"][ti.BEAUTY, :, :3].mean() > 0.05
    # The CPU run went through the plain version: no kernel launched.
    assert tt.launches == 0


def test_port_scene_build_renders_the_same_image():
    config, ir = _heightfield(False)
    cfg_c, ir_c = _convert(config, ir)
    _, cfg_p, ir_p = demo.heightfield_scene(grid=12, res=16, compat=False,
                                            device="cpu")
    cfg_p = cfg_p.replace(trace_mode="pallas", max_bounces=5)
    images = []
    for cfg, tir in ((cfg_c, ir_c), (cfg_p, ir_p)):
        r = Renderer(cfg, tir, device="cpu")
        r.step(2)
        images.append(r.get_pass("beauty"))
    np.testing.assert_array_equal(images[0], images[1])


def test_renderer_passes_and_unported_features():
    _, cfg, ir = demo.heightfield_scene(grid=6, res=8, compat=False,
                                        device="cpu")
    r = Renderer(cfg, ir, device="cpu")
    r.step(1)
    assert r.get_render_info() == {"samples": 1}
    for name in ("beauty", "normal", "tangent", "bitangent", "BEAUTY"):
        p = r.get_pass(name)
        assert p.shape == (8 * 8 * 4,) and np.isfinite(p).all()
    np.testing.assert_array_equal(r.get_pass("nonsense"),
                                  r.get_pass("beauty"))
    # The denoiser is ported (tests/test_torch_renderer.py holds it to
    # the JAX package's): the "denoise" pass and config.denoise work.
    den = r.get_pass("denoise")
    assert den.shape == (8 * 8 * 4,) and np.isfinite(den).all()
    assert (den[3::4] == 1.0).all()
    rd = Renderer(cfg.replace(denoise=True), ir, device="cpu")
    rd.step(1)
    assert (rd.get_pass("normal")[3::4] == 1.0).all()
    # Textures, point lights and shaders render.  No material binds a
    # texture or a shader here, so enabling those paths changes no value
    # beyond an ulp (torch's CPU pow may round a strided view and a
    # contiguous copy of the same numbers differently); a light draws
    # one more number per bounce, so its image differs.
    for on in (dict(n_lights=1), dict(use_shaders=True),
               dict(tex_slots_used=(True,) * 7, tex_uniform_filter=-1)):
        r2 = Renderer(cfg.replace(**on), ir, device="cpu")
        r2.step(1)
        assert r2.get_render_info() == {"samples": 1}
        img = r2.get_pass("beauty")
        assert np.isfinite(img).all()
        if "n_lights" not in on:
            np.testing.assert_allclose(img, r.get_pass("beauty"), rtol=1e-6,
                                       atol=1e-7)
    # sort_impl="counting" is ported: on this scene of 50 tris, forced
    # through the traversal, it renders the argsort image (the sort is
    # undone after each trace); an unknown value raises.
    sorted_ = {}
    for impl in ("argsort", "counting"):
        r3 = Renderer(cfg.replace(sort_impl=impl, trace_mode="pallas"), ir,
                      device="cpu")
        r3.step(1)
        sorted_[impl] = r3.get_pass("beauty")
    np.testing.assert_array_equal(sorted_["counting"], sorted_["argsort"])
    with pytest.raises(ValueError, match="sort_impl"):
        Renderer(cfg.replace(sort_impl="radix", trace_mode="pallas"), ir,
                 device="cpu").step(1)
    # The gradient slice's options no longer raise: a recorded sample
    # equals the plain one, and every material_fetch renders with a
    # table that requires grad.
    state = ti.init_state(cfg, device="cpu")
    want = ti.render_sample(cfg, ir, state, device="cpu")
    got, trace = ti.render_sample(cfg, ir, state, record=True, device="cpu")
    assert torch.equal(got["passes"], want["passes"])
    assert trace["hit"].shape == (cfg.max_bounces, 64)
    assert trace["hit"].dtype == torch.int32
    assert trace["occ"].dtype == torch.bool and "locc" not in trace
    ir_g = dict(ir)
    ir_g["materials"] = dict(ir["materials"])
    ir_g["materials"]["albedo"] = ir["materials"]["albedo"].clone() \
        .requires_grad_(True)
    for fetch in ("mm_bwd", "onehot", "gather"):
        st = ti.render_sample(cfg.replace(material_fetch=fetch), ir_g, state,
                              device="cpu")
        assert st["passes"].requires_grad
        assert torch.equal(st["passes"].detach(), want["passes"])
    with pytest.raises(ValueError):
        ti.render_sample(cfg.replace(material_fetch="scatter"), ir, state,
                         device="cpu")


def test_counting_sort_renders_the_argsort_and_the_jax_image():
    """``sort_impl="counting"`` on the grid-12 heightfield, two samples:
    the port's render equals its ``argsort`` render within the pair
    tolerance of (b) (the permutation is undone after each trace, so only
    an equal-t tie can differ), the sort really ran as the counting sort,
    and the JAX package's render under the same setting agrees as (b)
    asks."""
    config, ir = _heightfield(False)
    want, got, cfg = _run_pair(config.replace(sort_impl="counting"), ir, 2)
    assert cfg.sort_impl == "counting"
    _check_pair((want, got, cfg))
    cfg_a, tir = _convert(config, ir)
    assert ti.uses_sort(cfg, tir)
    assert cfg_a.sort_impl == "argsort"
    seen = []
    real = ti.sort_for_packets

    def spy(*args, **kw):
        seen.append(kw["impl"])
        return real(*args, **kw)

    images = {}
    for c in (cfg_a, cfg):
        r = Renderer(c, tir, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ti, "sort_for_packets", spy)
            r.step(2)
        images[c.sort_impl] = r.get_pass("beauty").reshape(-1, 4)[:, :3]
    assert set(seen) == {"argsort", "counting"}
    assert seen.count("counting") == seen.count("argsort") > 0
    assert _close_frac(images["counting"], images["argsort"]) >= 0.99
    np.testing.assert_allclose(images["counting"].mean(),
                               images["argsort"].mean(), rtol=1e-4)


@pytest.mark.parametrize("mode", ["pallas_wide", "pallas_wide_stream"])
def test_wide_trace_modes_warn_and_render_with_the_binary_kernel(mode,
                                                                  caplog):
    """As in the JAX package, the 8-wide walk is no render mode: the port
    logs a warning that names where the walk lives, once, and renders
    exactly the binary kernel's image; no wide walk runs."""
    from elevenrender_tpu_torch.experiments import bvh_wide
    _, cfg, ir = demo.heightfield_scene(grid=12, res=16, compat=False,
                                        device="cpu")
    cfg = cfg.replace(max_bounces=2)
    ti._warn_wide_mode.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        def no_wide(*a, **kw):
            raise AssertionError("the wide walk is not a render mode")
        mp.setattr(bvh_wide, "traverse_wide", no_wide)
        mp.setattr(bvh_wide, "traverse_wide_plain", no_wide)
        with caplog.at_level("WARNING",
                             logger=ti.__name__):
            assert ti.resolve_trace_mode(cfg.replace(trace_mode=mode),
                                         ir) == "bvh"
            r = Renderer(cfg.replace(trace_mode=mode), ir, device="cpu")
            r.step(1)
    warned = [rec for rec in caplog.records
              if rec.levelname == "WARNING" and mode in rec.getMessage()]
    assert len(warned) == 1
    assert "experiments/bvh_wide.py" in warned[0].getMessage()
    assert "binary" in warned[0].getMessage()
    base = Renderer(cfg.replace(trace_mode="pallas"), ir, device="cpu")
    base.step(1)
    np.testing.assert_array_equal(r.get_pass("beauty"),
                                  base.get_pass("beauty"))
    # Even on a scene small enough for brute force under "auto".
    _, small, ir_small = demo.heightfield_scene(grid=4, res=8, device="cpu")
    assert ti.resolve_trace_mode(small, ir_small) == "brute"
    assert ti.resolve_trace_mode(small.replace(trace_mode=mode),
                                 ir_small) == "bvh"
    assert ti.resolve_trace_mode(
        small.replace(trace_mode=mode, use_bvh=False), ir_small) == "brute"


def test_trace_order_and_leaf_aabb_reach_the_traversal():
    """``trace_order="sign", leaf_aabb=1`` renders the default image
    (the variants change the walk, not the hits; an equal-t tie may pick
    another tri, within the pair tolerance of (b)), the traversal is
    asked for that variant, and an unknown value raises."""
    _, cfg, ir = demo.heightfield_scene(grid=12, res=16, compat=False,
                                        device="cpu")
    cfg = cfg.replace(trace_mode="pallas", max_bounces=3)
    images = {}
    seen = []
    plain = tt.traverse_plain

    def spy(*args, **kw):
        seen.append((args[6], args[7]))
        return plain(*args, **kw)

    for name, kw in (("default", {}),
                     ("sign", dict(trace_order="sign", leaf_aabb=1))):
        r = Renderer(cfg.replace(**kw), ir, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tt, "traverse_plain", spy)
            r.step(1)
        images[name] = r.get_pass("beauty").reshape(-1, 4)[:, :3]
    assert set(seen) == {("near", 0), ("sign", 1)}
    assert _close_frac(images["sign"], images["default"]) >= 0.99
    np.testing.assert_allclose(images["sign"].mean(),
                               images["default"].mean(), rtol=1e-4)
    for bad in (dict(trace_order="far"), dict(leaf_aabb=3)):
        with pytest.raises(ValueError):
            Renderer(cfg.replace(**bad), ir, device="cpu").step(1)


@pytest.mark.parametrize("name,compat", [("featured_16x16_compat", True),
                                         ("featured_16x16_native", False)])
def test_featured_matches_golden(name, compat):
    """Textures, normal map, opacity and bokeh (and the point light in
    native mode) on the JAX-built scene, against the golden and against
    the JAX package run op by op."""
    config, ir = featured_scene(res=16, compat=compat, spp=3)
    cfg, tir = _convert(config, ir)
    assert any(cfg.tex_slots_used) and cfg.n_lights == (0 if compat else 1)
    r = Renderer(cfg, tir, device="cpu")
    r.step(3)
    img = r.get_pass("beauty").reshape(16, 16, 4)
    ref = np.load(os.path.join(GOLDEN_DIR, f"{name}.npy"))
    _assert_close_but_fma(img, ref)
    state = jax_init_state(config)
    with jax.disable_jit():
        for _ in range(3):
            state = jax_render(config, ir, state)
    np.testing.assert_allclose(
        img, np.asarray(state["passes"][ti.BEAUTY]).reshape(16, 16, 4),
        rtol=1e-5, atol=1e-6)


def _assert_close_but_fma(got, want):
    """Within rtol 1e-5 / atol 1e-6 on >= 99% of pixels, and within
    rtol 1e-4 / atol 1e-5 on all (see (e) above)."""
    got, want = got[..., :3], want[..., :3]
    assert _close_frac(got, want, rtol=1e-5, atol=1e-6) >= 0.99
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_named_shaders_equal_jax():
    rng = np.random.default_rng(21)
    args = [rng.normal(size=(64, 3)).astype(np.float32) for _ in range(4)]
    args += [rng.uniform(-1, 2, 64).astype(np.float32) for _ in range(2)]
    assert t_shaders.NAMED_SHADERS.keys() == jax_shaders.NAMED_SHADERS.keys()
    for name, fn in t_shaders.NAMED_SHADERS.items():
        want = np.asarray(jax_shaders.NAMED_SHADERS[name](
            *map(jax.numpy.asarray, args)))
        got = fn(*map(torch.tensor, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


@pytest.fixture
def checker_in_slot_1():
    """The checker shader bound to slot 1 in both registries, and both
    reset afterwards."""
    v0 = t_shaders.registry_version()
    jax_shaders.register_shader(1, jax_shaders.NAMED_SHADERS["checker"])
    t_shaders.register_shader(1, t_shaders.NAMED_SHADERS["checker"])
    assert t_shaders.registry_version() > v0
    yield
    jax_shaders.reset_shaders()
    t_shaders.reset_shaders()


def test_albedo_shader_matches_jax(checker_in_slot_1):
    """The featured scene's ground takes its albedo from the checker
    shader (slot 1), its canopy from the placeholder (slot 0); native,
    2 samples, port against JAX."""
    config, ir = featured_scene(res=16, compat=False, spp=2)
    ir = dict(ir)
    ir["materials"] = dict(ir["materials"])
    ir["materials"]["shader"] = jax.numpy.asarray(np.array([1, 0], np.int32))
    config = config.replace(use_shaders=True)
    state = jax_init_state(config)
    step = jax.jit(jax_render, static_argnums=0)
    for _ in range(2):
        state = step(config, ir, state)
    want = np.asarray(state["passes"])
    cfg, tir = _convert(config, ir)
    st = ti.init_state(cfg, device="cpu")
    for _ in range(2):
        st = ti.render_sample(cfg, tir, st, device="cpu")
    got = st["passes"].numpy()
    for pid in (ti.BEAUTY, ti.NORMAL, ti.DENOISE):
        _assert_close_but_fma(got[pid], want[pid])
    # The shader changed the image.
    plain = Renderer(cfg.replace(use_shaders=False), tir, device="cpu")
    plain.step(2)
    assert not np.allclose(plain.get_pass("beauty"),
                           got[ti.BEAUTY].reshape(-1))
