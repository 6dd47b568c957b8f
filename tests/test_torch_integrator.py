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
"""

import dataclasses
import os

import numpy as np
import jax
import pytest

from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu.render.integrator import render_sample as jax_render
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.ops import traverse as tt
from elevenrender_tpu_torch.render import integrator as ti
from elevenrender_tpu_torch.render.renderer import Renderer
from elevenrender_tpu_torch.scene import demo

from scenes import cornell_scene, heightfield_scene

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


@pytest.fixture(scope="module", params=["native", "compat"])
def heightfield_pair(request):
    compat = request.param == "compat"
    n_samples = 1 if compat else 2
    config, ir = _heightfield(compat)
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


def _close_frac(a, b, rtol=1e-4, atol=1e-5):
    return np.isclose(a, b, rtol=rtol, atol=atol).all(axis=-1).mean()


def test_heightfield_matches_jax_pallas(heightfield_pair):
    want, got, _ = heightfield_pair
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
    with pytest.raises(NotImplementedError):
        r.get_pass("denoise")
    for bad in (dict(denoise=True), dict(n_lights=1), dict(use_shaders=True),
                dict(tex_slots_used=(True,) + (False,) * 6)):
        with pytest.raises(NotImplementedError):
            Renderer(cfg.replace(**bad), ir, device="cpu")
    # The gradient slice: trace recording and the custom material VJP.
    state = ti.init_state(cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        ti.render_sample(cfg, ir, state, record=True, device="cpu")
    ir_g = dict(ir)
    ir_g["materials"] = dict(ir["materials"])
    ir_g["materials"]["albedo"] = ir["materials"]["albedo"].clone() \
        .requires_grad_(True)
    with pytest.raises(NotImplementedError):
        ti.render_sample(cfg.replace(material_fetch="mm_bwd"), ir_g, state,
                         device="cpu")
    ti.render_sample(cfg.replace(material_fetch="gather"), ir_g, state,
                     device="cpu")
