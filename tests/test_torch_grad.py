"""PyTorch port, the gradient path on the CPU against the JAX package.

The same scene, made by the JAX package and carried across as numpy,
and the same target go through ``elevenrender_tpu.render.grad`` and the
port's ``render/grad.py``; gradients come back as numpy under the same
names (``convert.params_to_numpy``) and are compared leaf by leaf.

Scenes: the Cornell box at 16x16, native, 2 bounces, 2 samples (12 tris:
the brute-force trace, so both packages make every discrete decision
alike), for the direct and the accumulated gradient, the material-fetch
modes, ``remat_bounces``, the HDRI, light and camera gradients and the
finite-difference check; the grid-12 heightfield and config 5 in
miniature (the traversal kernel's plain version here, the Pallas kernel
in interpret mode there) for the recorded trace and the replay.

Tolerances.  Loss: rtol 1e-5.  Gradient leaves against JAX: rtol 1e-4 /
atol 1e-6 (the jitted JAX program contracts a*b+c into one FMA, the port
rounds every op; measured worst 1.8e-6 relative to a leaf's largest
entry, so atol is scaled by that entry).  Within the port, accumulated
against direct and remat against stored: rtol 1e-5 / atol 1e-7 (another
order of the same sums); replay against re-trace: exactly equal (the
same ops on the same values).
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from elevenrender_tpu.render import grad as jax_grad
from elevenrender_tpu.render.integrator import BEAUTY
from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu.render.integrator import render_sample as jax_render
from elevenrender_tpu_torch.convert import (ir_from_numpy, params_from_numpy,
                                            params_to_numpy)
from elevenrender_tpu_torch.ops import traverse as tt
from elevenrender_tpu_torch.render import grad as tg
from elevenrender_tpu_torch.render import integrator as ti
from elevenrender_tpu_torch.scene.ir import RenderConfig

from scenes import (cornell_scene, heightfield_scene,
                    textured_heightfield_scene)

N_SAMPLES = 2


def _convert(config, ir):
    return ir_from_numpy(dataclasses.asdict(config),
                         jax.tree.map(np.asarray, ir), device="cpu")


def _target(config, ir):
    state = jax.jit(jax_render, static_argnums=0)(config, ir,
                                                  jax_init_state(config))
    return np.asarray(state["passes"][BEAUTY, :, :3]) * 1.5 + 0.1


def _assert_leaves_close(got, want, rtol=1e-4, atol=1e-6, path=""):
    """Every leaf of ``got`` within rtol / (atol x the leaf's largest
    entry) of ``want``; both trees are numpy."""
    assert got.keys() == want.keys(), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_leaves_close(got[k], want[k], rtol, atol, f"{path}{k}.")
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert np.isfinite(a).all(), path + k
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                                   err_msg=path + k)


@pytest.fixture(scope="module")
def cornell():
    """The Cornell box with a point light, so that radiance depends on
    materials, HDRI, light radiance and the camera."""
    _, config, ir = cornell_scene(res=16, spp=2)
    config = config.replace(compat=False, max_bounces=2, n_lights=1)
    ir = dict(ir)
    ir["lights"] = {"pos": jnp.asarray([[0.0, 1.5, -1.0]], jnp.float32),
                    "rad": jnp.asarray([[6.0, 5.0, 4.0]], jnp.float32)}
    cfg, tir = _convert(config, ir)
    assert ti.resolve_trace_mode(cfg, tir) == "brute"
    params = {"materials": jax_grad.float_subtree(ir["materials"]),
              "env": {"img": ir["env"]["img"]},
              "lights": {"rad": ir["lights"]["rad"]},
              "camera": {"rotation": ir["camera"]["rotation"]}}
    target = _target(config, ir)
    return dict(config=config, ir=ir, cfg=cfg, tir=tir, params=params,
                tparams=params_from_numpy(jax.tree.map(np.asarray, params),
                                          "cpu"),
                target=target, ttarget=torch.tensor(target))


_JAX_GRAD = {"direct": jax_grad.render_loss_and_grad,
             "accum": jax_grad.render_loss_and_grad_accum}
_PORT_GRAD = {"direct": tg.render_loss_and_grad,
              "accum": tg.render_loss_and_grad_accum}


@pytest.fixture(scope="module")
def port_direct(cornell):
    c = cornell
    loss, grads = tg.render_loss_and_grad(c["cfg"], c["tir"], c["tparams"],
                                          c["ttarget"], N_SAMPLES,
                                          device="cpu")
    return float(loss), params_to_numpy(grads)


@pytest.mark.parametrize("how", ["direct", "accum"])
def test_loss_and_gradients_match_jax(cornell, how):
    """Loss and every leaf: the material table, the HDRI texels, the
    light's radiance and the camera's rotation."""
    c = cornell
    want_loss, want = _JAX_GRAD[how](c["config"], c["ir"], c["params"],
                                     jnp.asarray(c["target"]), N_SAMPLES)
    loss, grads = _PORT_GRAD[how](c["cfg"], c["tir"], c["tparams"],
                                  c["ttarget"], N_SAMPLES, device="cpu")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    want = jax.tree.map(np.asarray, want)
    got = params_to_numpy(grads)
    _assert_leaves_close(got, want)
    for leaf in ("albedo", "roughness", "emission"):
        assert np.abs(got["materials"][leaf]).sum() > 0
    assert np.abs(got["env"]["img"]).sum() > 0
    assert np.abs(got["lights"]["rad"]).sum() > 0
    assert np.abs(got["camera"]["rotation"]).sum() > 0
    # The caller's tensors are untouched: no grad, no graph.
    assert not any(p.requires_grad for p in tg._leaves(c["tparams"]))


def test_accumulated_equals_direct(cornell, port_direct):
    c = cornell
    loss, grads = tg.render_loss_and_grad_accum(
        c["cfg"], c["tir"], c["tparams"], c["ttarget"], N_SAMPLES,
        device="cpu")
    np.testing.assert_allclose(float(loss), port_direct[0], rtol=1e-6)
    _assert_leaves_close(params_to_numpy(grads), port_direct[1], rtol=1e-5,
                         atol=1e-7)


@pytest.mark.parametrize("fetch", ["mm_bwd", "onehot", "gather"])
def test_material_fetch_modes_agree(cornell, port_direct, fetch):
    """The default config is "mm_bwd" (``port_direct``); each mode gives
    its loss and gradients up to the order of the float32 sums."""
    c = cornell
    assert c["cfg"].material_fetch == "mm_bwd"
    loss, grads = tg.render_loss_and_grad(
        c["cfg"].replace(material_fetch=fetch), c["tir"], c["tparams"],
        c["ttarget"], N_SAMPLES, device="cpu")
    np.testing.assert_allclose(float(loss), port_direct[0], rtol=1e-6)
    _assert_leaves_close(params_to_numpy(grads), port_direct[1], rtol=1e-4,
                         atol=1e-7)


def test_mm_bwd_backward_is_the_index_add_reduction():
    """Forward: the gather, bit for bit.  Backward: onehot(m).T @ ct in
    float32, pinned against ``index_add_`` (float64 as the yardstick:
    both float32 sums lie within 1e-6 relative of it)."""
    gen = np.random.default_rng(4)
    table = torch.tensor(gen.normal(size=(7, 19)).astype(np.float32),
                         requires_grad=True)
    m = torch.tensor(gen.integers(0, 7, 5000))
    ct = torch.tensor(gen.normal(size=(5000, 19)).astype(np.float32))
    row = ti._GatherRowsMmBwd.apply(table, m)
    assert torch.equal(row, table.detach()[m])
    (got,) = torch.autograd.grad(row, table, ct)
    want32 = torch.zeros(7, 19).index_add_(0, m, ct)
    want64 = torch.zeros(7, 19, dtype=torch.float64).index_add_(
        0, m, ct.double())
    np.testing.assert_allclose(got.numpy(), want64.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want32.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert got.dtype == torch.float32
    # A table of more than 64 rows falls back to the plain gather.
    big = torch.zeros(65, 19, requires_grad=True)
    out = ti._material_rows(RenderConfig(), big, m)
    assert "Index" in type(out.grad_fn).__name__


def test_remat_bounces_agrees(cornell):
    c = cornell
    kw = dict(device="cpu")
    loss0, g0 = tg.render_loss_and_grad_accum(
        c["cfg"], c["tir"], c["tparams"], c["ttarget"], N_SAMPLES, **kw)
    loss1, g1 = tg.render_loss_and_grad_accum(
        c["cfg"].replace(remat_bounces=True), c["tir"], c["tparams"],
        c["ttarget"], N_SAMPLES, **kw)
    assert float(loss0) == float(loss1)
    _assert_leaves_close(params_to_numpy(g1), params_to_numpy(g0),
                         rtol=1e-5, atol=1e-7)


def test_albedo_gradient_matches_finite_differences(cornell, port_direct):
    """With the RNG stream fixed the estimator is a smooth function of
    albedo (every discrete decision is unchanged by a small bump), so a
    central difference pins the gradient.  atol is the float32 loss's
    quantization over 2 eps, as in the JAX package's own test."""
    c = cornell
    g = port_direct[1]["materials"]["albedo"]
    base = c["tparams"]["materials"]["albedo"]

    def loss_at(albedo):
        p = {"materials": {**c["tparams"]["materials"], "albedo": albedo}}
        with torch.no_grad():
            return float(tg.loss_fn(c["cfg"], c["tir"], p, c["ttarget"],
                                    N_SAMPLES, device="cpu"))

    eps = 1e-3
    m, ch = divmod(int(np.abs(g).argmax()), g.shape[1])
    bump = torch.zeros_like(base)
    bump[m, ch] = eps
    fd = (loss_at(base + bump) - loss_at(base - bump)) / (2 * eps)
    np.testing.assert_allclose(g[m, ch], fd, rtol=1e-2, atol=3e-4)


def _bvh_scene(kind):
    if kind == "textured_lit":
        _, config, ir = textured_heightfield_scene(grid=24, res=16,
                                                   compat=False)
        return config.replace(trace_mode="pallas_stream", max_bounces=2), ir
    _, config, ir = heightfield_scene(grid=12, res=16, compat=False)
    return config.replace(trace_mode="pallas", max_bounces=2), ir


@functools.lru_cache(maxsize=None)
def _bvh_case(kind):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELEVENRT_NATIVE", "0")  # the numpy BVH build the port copies
        config, ir = _bvh_scene(kind)
    cfg, tir = _convert(config, ir)
    assert ti.resolve_trace_mode(cfg, tir) == "bvh"
    return dict(kind=kind, config=config, ir=ir, cfg=cfg, tir=tir)


@pytest.fixture(scope="module", params=["heightfield", "textured_lit"])
def bvh_scene(request):
    return _bvh_case(request.param)


def test_recorded_trace_equals_jax(bvh_scene):
    """``record=True``: the hit ids and occlusion bits of every bounce
    (and the light's with a point light) equal the JAX package's
    ``out["trace"]``; the recorded sample's state is the plain one's."""
    b = bvh_scene
    _, want = jax.jit(jax_render, static_argnums=(0, 4))(
        b["config"], b["ir"], jax_init_state(b["config"]), 0, True)
    want = jax.tree.map(np.asarray, want)
    state = ti.init_state(b["cfg"], device="cpu")
    plain = ti.render_sample(b["cfg"], b["tir"], state, device="cpu")
    got_state, got = ti.render_sample(b["cfg"], b["tir"], state, record=True,
                                      device="cpu")
    assert torch.equal(got_state["passes"], plain["passes"])
    assert got.keys() == want.keys()
    assert ("locc" in got) == (b["kind"] == "textured_lit")
    assert got["hit"].dtype == torch.int32
    for k in want:
        assert got[k].shape == want[k].shape == (2, 256), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert (want["hit"] >= 0).sum() > 80 and want["occ"].any()


def test_replay_equals_retrace_and_runs_no_traversal(bvh_scene):
    """``cache_traces=True`` against ``False``: the same loss and exactly
    the same gradients.  The traversal runs twice per bounce and sample
    in pass 1 and in a re-traced pass 2, and never in a replayed one; a
    replayed sample sorts no rays either."""
    b = bvh_scene
    params = {"materials": tg.float_subtree(b["tir"]["materials"]),
              "env": {"img": b["tir"]["env"]["img"]}}
    with torch.no_grad():
        st = ti.render_sample(b["cfg"], b["tir"],
                              ti.init_state(b["cfg"], device="cpu"),
                              device="cpu")
    target = st["passes"][ti.BEAUTY, :, :3] * 1.5 + 0.1
    calls = {"traverse": 0, "sort": 0}
    results = {}
    with pytest.MonkeyPatch.context() as mp:
        traverse, sort = tt.traverse, ti.sort_for_packets

        def count(name, fn):
            def wrapped(*a, **kw):
                calls[name] += 1
                return fn(*a, **kw)
            return wrapped

        mp.setattr(tt, "traverse", count("traverse", traverse))
        mp.setattr(ti, "sort_for_packets", count("sort", sort))
        for cache in (True, False):
            calls.update(traverse=0, sort=0)
            results[cache] = tg.render_loss_and_grad_accum(
                b["cfg"], b["tir"], params, target, N_SAMPLES,
                cache_traces=cache, device="cpu")
            per_pass = 2 * b["cfg"].max_bounces * N_SAMPLES
            assert calls["traverse"] == per_pass * (1 if cache else 2)
            results[cache] += (calls["sort"],)
    assert results[False][2] == 2 * results[True][2] > 0
    assert float(results[True][0]) == float(results[False][0])
    replayed = params_to_numpy(results[True][1])
    retraced = params_to_numpy(results[False][1])
    for grp in retraced:
        for k in retraced[grp]:
            np.testing.assert_array_equal(replayed[grp][k], retraced[grp][k],
                                          err_msg=f"{grp}.{k}")
    # (The textured scene takes its albedo from a map: that leaf is 0.)
    assert np.abs(replayed["materials"]["roughness"]).sum() > 0
    assert np.abs(replayed["env"]["img"]).sum() > 0


def test_textured_lit_gradients_match_jax():
    """Config 5 in miniature through the accumulator of both packages:
    textures, the normal map and the point light's recorded ``locc`` lie
    on this path."""
    b = _bvh_case("textured_lit")
    params = {"materials": jax_grad.float_subtree(b["ir"]["materials"])}
    target = _target(b["config"], b["ir"])
    want_loss, want = jax_grad.render_loss_and_grad_accum(
        b["config"], b["ir"], params, jnp.asarray(target), N_SAMPLES)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    loss, grads = tg.render_loss_and_grad_accum(
        b["cfg"], b["tir"], tparams, torch.tensor(target), N_SAMPLES,
        device="cpu")
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_leaves_close(params_to_numpy(grads),
                         jax.tree.map(np.asarray, want))


def test_fwd_bwd_steps_take_the_material_table(cornell, port_direct):
    """``fwd_bwd_step`` and ``fwd_bwd_step_accum`` are the two gradients
    above with respect to ``float_subtree(ir["materials"])``."""
    c = cornell
    assert "tex" not in tg.float_subtree(c["tir"]["materials"])
    assert "shader" not in tg.float_subtree(c["tir"]["materials"])
    for step in (tg.fwd_bwd_step, tg.fwd_bwd_step_accum):
        loss, grads = step(c["cfg"], c["tir"], c["ttarget"], N_SAMPLES,
                           device="cpu")
        assert list(grads) == ["materials"]
        np.testing.assert_allclose(float(loss), port_direct[0], rtol=1e-6)
        _assert_leaves_close(params_to_numpy(grads)["materials"],
                             port_direct[1]["materials"], rtol=1e-5,
                             atol=1e-7)
    with pytest.raises(ValueError, match="native"):
        tg.fwd_bwd_step_accum(c["cfg"].replace(compat=True), c["tir"],
                              c["ttarget"], 1, device="cpu")
    # ``chunk`` is taken for the JAX package's call and changes nothing.
    chunked = tg.fwd_bwd_step_accum(c["cfg"], c["tir"], c["ttarget"],
                                    N_SAMPLES, chunk=1, device="cpu")
    assert float(chunked[0]) == float(loss)
    for k, g in grads["materials"].items():
        assert torch.equal(chunked[1]["materials"][k], g), k


def test_recommended_samples_per_dispatch(cornell, monkeypatch):
    c = cornell
    monkeypatch.delenv("ELEVENRT_SAMPLES_PER_DISPATCH", raising=False)
    assert ti.recommended_samples_per_dispatch(c["cfg"], c["tir"]) == 8
    assert ti.recommended_samples_per_dispatch(c["cfg"], c["tir"], 3) == 3
    cfg = c["cfg"].replace(samples_per_dispatch=5)
    assert ti.recommended_samples_per_dispatch(cfg, c["tir"]) == 5
    monkeypatch.setenv("ELEVENRT_SAMPLES_PER_DISPATCH", "2")
    assert ti.recommended_samples_per_dispatch(cfg, c["tir"]) == 2
    monkeypatch.setenv("ELEVENRT_SAMPLES_PER_DISPATCH", "many")
    assert ti.recommended_samples_per_dispatch(cfg, c["tir"]) == 5
