"""PyTorch port, inverse rendering (BASELINE config 4) on the CPU against
the JAX package and ``scripts/inverse_demo.py``'s loop.

The scenes are made by the JAX package and carried across as numpy
(``convert.ir_from_numpy``); the JAX side runs its jitted
``render_loss_and_grad`` with ``optax.adam`` as the demo does, and
``jax.jacfwd`` for the camera Jacobian.  The port runs
``elevenrender_tpu_torch/inverse_demo.py`` on the same IR.

Tolerances.  The forward-mode rules of ``_ClipBalanced`` and
``_GatherRowsMmBwd``: exactly JAX's tangents (the factors are 0, 1/2 and
1, a gather copies).  The Jacobian of the first-hit albedo AOV (16x16, 1
bounce): within 1e-5 of each column's largest entry (measured worst
2.4e-7 of 2.2).  The first 10 Adam steps of stages 1 and 3: the loss at
every step to rtol 1e-5 and the parameters after every step to atol
1e-5 (measured worst 2.2e-7 and 2.4e-7: the jitted JAX program contracts
a*b+c into one FMA, the port rounds every op).  ``Adam`` against
``optax.adam`` on the same gradients: atol 1e-7.  Within the port, the
forward-mode Jacobian at 2 bounces against reverse mode: within 1e-5 of
the largest entry.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from elevenrender_tpu.render import grad as jax_grad
from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu.render.integrator import (
    sample_radiance as jax_sample_radiance)
from elevenrender_tpu.scene.hdri import HDRI
from elevenrender_tpu.scene.material import Material
from elevenrender_tpu.scene.scene import Scene
from elevenrender_tpu.scene.texture import Texture
from elevenrender_tpu_torch import inverse_demo as inv
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.render.integrator import (_ClipBalanced,
                                                      _GatherRowsMmBwd)

from scenes import cornell_scene, heightfield_mesh

RES = 16
STEPS = 10


def _convert(config, ir):
    cfg, tir = ir_from_numpy(dataclasses.asdict(config),
                             jax.tree.map(np.asarray, ir), device="cpu")
    return cfg.replace(device="cpu"), tir


@pytest.fixture(scope="module")
def cornell():
    """The demo's stage-1 and stage-3 scene at 16x16: native, 2 bounces."""
    _, config, ir = cornell_scene(res=RES, spp=2)
    config = config.replace(compat=False, max_bounces=2)
    return config, ir, *_convert(config, ir)


def _jax_camera_scene(res):
    """``scripts/inverse_demo.py``'s stage-2 scene, built by the JAX
    package."""
    scene = Scene()
    scene.add_mesh(heightfield_mesh(24))
    yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64.0
    blob = np.exp(-(((xx - 0.62) / 0.22) ** 2 + ((yy - 0.37) / 0.14) ** 2))
    smooth = np.stack([0.15 + 0.8 * blob,
                       0.15 + 0.7 * xx * yy,
                       0.2 + 0.6 * (1.0 - xx) * yy], -1).astype(np.float32)
    scene.add_texture(Texture("grad", smooth, Texture.FILTER_BILINEAR))
    terrain = Material(name="terrain",
                       albedo=np.array([0.6, 0.6, 0.6], np.float32),
                       roughness=0.8)
    terrain.albedo_map = "grad"
    terrain.compute_aniso_alphas()
    scene.add_material(terrain)
    scene.pair_materials()
    scene.pair_textures()
    sky = np.full((8, 16, 3), 0.5, np.float32)
    sky[:4] = [0.7, 0.8, 1.0]
    scene.add_hdri(HDRI(Texture("sky2", sky)))
    scene.camera.position = np.array([0.0, 1.5, -4.0], np.float32)
    scene.camera.rotation = np.array([15.0, 0.0, 0.0], np.float32)
    scene.x_res = scene.y_res = res
    config, ir = scene.build()
    return config.replace(compat=False, max_bounces=1), ir


def _tangent(fn, x, t):
    with fwAD.dual_level():
        y = fn(fwAD.make_dual(torch.tensor(x), torch.tensor(t)))
        return fwAD.unpack_dual(y).tangent.numpy()


def test_clip_jvp_equals_jax_at_both_bounds():
    """``_ClipBalanced``'s tangent is ``jnp.clip``'s, ties at both bounds
    (1/2 there) included."""
    x = np.array([-1.0, 0.0, 0.25, 1.0, 2.0, 0.0, 1.0, 0.5], np.float32)
    t = np.arange(1, 9, dtype=np.float32) * 0.75
    factors = {}
    for lo, hi in ((0.0, 1.0), (0.25, 0.25)):
        _, want = jax.jvp(lambda v: jnp.clip(v, lo, hi), (x,), (t,))
        got = _tangent(lambda v: _ClipBalanced.apply(v, lo, hi), x, t)
        np.testing.assert_array_equal(got, np.asarray(want))
        factors[lo, hi] = set(np.unique(got / t).tolist())
    assert factors == {(0.0, 1.0): {0.0, 0.5, 1.0}, (0.25, 0.25): {0.0, 0.25}}


def test_gather_rows_jvp_equals_jax():
    """``_GatherRowsMmBwd``'s tangent is the gather's, ``t_table[m]``."""
    rng = np.random.default_rng(0)
    table = rng.random((4, 19), dtype=np.float32)
    t = rng.standard_normal((4, 19)).astype(np.float32)
    m = rng.integers(0, 4, (5, 7))
    _, want = jax.jvp(lambda a: a[m], (table,), (t,))
    got = _tangent(lambda a: _GatherRowsMmBwd.apply(a, torch.tensor(m)),
                   table, t)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_camera_scene_is_the_jax_scripts():
    """``inverse_demo.camera_scene`` builds the JAX script's stage-2 IR."""
    config, ir = _jax_camera_scene(RES)
    want_cfg, want = _convert(config, ir)
    cfg, got = inv.camera_scene(RES, "cpu")
    assert cfg.replace(device="cpu") == want_cfg
    for grp in ("tris", "bvh", "materials", "atlas", "env", "camera"):
        for k, v in want[grp].items():
            assert torch.equal(got[grp][k], v), (grp, k)


def test_camera_jacobian_matches_jacfwd():
    """Three forward-mode JVPs of the full-resolution residuals at the
    demo's start rotation equal ``jax.jacfwd`` of the same residuals
    within 1e-5 of each column's largest entry; the traversal's hits are
    constants on both sides."""
    config, ir = _jax_camera_scene(RES)
    rng = jax_init_state(config)["rng"]

    def render_at(rot):
        cam_ir = dict(ir)
        cam_ir["camera"] = {**ir["camera"], "rotation": rot}
        out, _ = jax_sample_radiance(config, cam_ir, rng, RES * RES)
        return out["albedo"].reshape(RES, RES, 3)

    true_rot = ir["camera"]["rotation"]
    target = render_at(true_rot)
    start = true_rot + jnp.asarray(inv.ROTATION_START_OFFSET, jnp.float32)
    want = np.asarray(jax.jit(jax.jacfwd(
        lambda r: (render_at(r) - target).reshape(-1)))(start))

    cfg, tir = _convert(config, ir)
    _, _, res_fine = inv.camera_residuals(cfg, tir)
    got = inv.jacobian(res_fine, torch.tensor(np.asarray(start))).numpy()
    assert got.shape == want.shape == (RES * RES * 3, 3)
    scale = np.abs(want).max(axis=0)
    assert (scale > 0).all()
    np.testing.assert_array_less(np.abs(got - want).max(axis=0),
                                 1e-5 * scale)


def test_adam_equals_optax():
    """``inverse_demo.Adam`` on a tree takes optax.adam's steps."""
    rng = np.random.default_rng(1)
    p0 = {"a": {"x": rng.standard_normal((4, 3)).astype(np.float32)},
          "b": rng.standard_normal(3).astype(np.float32)}
    opt = optax.adam(0.05)
    jp = jax.tree.map(jnp.asarray, p0)
    st = opt.init(jp)
    tp = jax.tree.map(torch.tensor, p0)
    adam = inv.Adam(0.05, tp)
    for _ in range(20):
        g = jax.tree.map(
            lambda v: rng.standard_normal(v.shape).astype(np.float32), p0)
        up, st = opt.update(jax.tree.map(jnp.asarray, g), st)
        jp = optax.apply_updates(jp, up)
        tp = adam.step(tp, jax.tree.map(torch.tensor, g))
    for want, got in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-7)


def _jax_loss_and_grad(config, ir, albedo, env_img, target):
    """The JAX script's ``render_loss_and_grad(config, ir, params, target,
    2)`` with both stages' leaves in ``params``, so that the two stages'
    loops share one compiled program; each stage reads its own leaf's
    gradient.  Returns (loss, d albedo, d env image)."""
    loss, grads = jax_grad.render_loss_and_grad(
        config, ir, {"materials": {"albedo": albedo}, "env": {"img": env_img}},
        target, 2)
    return loss, grads["materials"]["albedo"], grads["env"]["img"]


def test_albedo_steps_match_the_jax_loop(cornell):
    """Stage 1's first 10 steps (2 samples a step): the loss at each step
    and the white wall's albedo after it, against the JAX script's loop
    (``render_loss_and_grad``, the row mask, ``optax.adam(0.05)``, the
    clip)."""
    config, ir, cfg, tir = cornell
    target_ir = dict(ir)
    target_ir["materials"] = {**ir["materials"],
                              "albedo": ir["materials"]["albedo"].at[0].set(
                                  jnp.asarray(inv.ALBEDO_TARGET))}
    target, _ = jax_grad.render_beauty(config, target_ir, 2)
    params = {"materials": {"albedo": ir["materials"]["albedo"]}}
    mask = jnp.zeros_like(params["materials"]["albedo"]).at[0].set(1.0)
    opt = optax.adam(0.05)
    st = opt.init(params)
    losses, albedos = [], []
    for _ in range(STEPS):
        loss, g_albedo, _ = _jax_loss_and_grad(
            config, ir, params["materials"]["albedo"], ir["env"]["img"],
            target)
        up, st = opt.update({"materials": {"albedo": g_albedo * mask}}, st)
        params = optax.apply_updates(params, up)
        params["materials"]["albedo"] = jnp.clip(
            params["materials"]["albedo"], 0.0, 1.0)
        losses.append(float(loss))
        albedos.append(np.asarray(params["materials"]["albedo"][0]))

    got = inv.albedo_stage(cfg, tir, inv.ALBEDO_TARGET, STEPS, 2, "cpu",
                           log=None)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(np.stack(got["albedos"]), np.stack(albedos),
                               rtol=0, atol=1e-5)
    assert losses[-1] < losses[0]


def test_tint_steps_match_the_jax_loop(cornell):
    """Stage 3's first 10 steps: the loss at each step and the tint after
    it, against the JAX script's loop (the env image the gradient leaf,
    the tint's gradient ``sum(g_img * base)``, ``optax.adam(0.05)``, the
    clip to [0, 4])."""
    config, ir, cfg, tir = cornell
    base = ir["env"]["img"]
    tinted = dict(ir)
    tinted["env"] = {**ir["env"],
                     "img": base * jnp.asarray(inv.TINT_TARGET, jnp.float32)}
    target, _ = jax_grad.render_beauty(config, tinted, 2)
    tint = jnp.ones((3,), jnp.float32)
    opt = optax.adam(0.05)
    st = opt.init(tint)
    losses, tints = [], []
    for _ in range(STEPS):
        loss, _, g_img = _jax_loss_and_grad(
            config, ir, ir["materials"]["albedo"], base * tint, target)
        g = jnp.sum(g_img * base, axis=(0, 1))
        up, st = opt.update(g, st)
        tint = jnp.clip(optax.apply_updates(tint, up), 0.0, 4.0)
        losses.append(float(loss))
        tints.append(np.asarray(tint))

    got = inv.tint_stage(cfg, tir, inv.TINT_TARGET, STEPS, 2, "cpu",
                         log=None)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(np.stack(got["tints"]), np.stack(tints),
                               rtol=0, atol=1e-5)
    assert losses[-1] < losses[0]


def test_albedo_stage_recovers_the_albedo(cornell):
    """The whole of stage 1 as ``tests/test_grad_and_sharding.py``
    recovers albedo (16x16, 1 sample a step, 80 steps, target [0.2, 0.6,
    0.3]): the last loss below half the first, the mean albedo error
    below the start's."""
    _, _, cfg, tir = cornell
    got = inv.albedo_stage(cfg, tir, (0.2, 0.6, 0.3), 80, 1, "cpu",
                           log=None)
    assert got["losses"][-1] < 0.5 * got["losses"][0]
    assert inv.recovered(got)


def test_forward_mode_agrees_with_reverse_mode_at_two_bounces():
    """At 2 bounces the sampled bounce direction feeds the next bounce:
    the forward-mode Jacobian of the radiance with respect to the camera
    rotation, contracted with fixed weights, equals reverse mode's
    gradient of the same contraction (within 1e-5 of the largest
    entry), so both modes treat the sampled direction as a constant."""
    res = 8
    cfg, ir = inv.camera_scene(res, "cpu")
    cfg = cfg.replace(max_bounces=2)
    rng = inv.init_state(cfg, "cpu")["rng"]
    w = torch.tensor(np.random.default_rng(2).standard_normal(
        (res * res, 3)).astype(np.float32))
    rot0 = ir["camera"]["rotation"] + torch.tensor(
        inv.ROTATION_START_OFFSET)

    def light(rot):
        cam_ir = {**ir, "camera": {**ir["camera"], "rotation": rot}}
        out, _ = inv.sample_radiance(cfg, cam_ir, rng, res * res)
        return out["light"] * out["ok"][:, None]

    with torch.no_grad():
        fwd = inv.jacobian(light, rot0).T @ w.reshape(-1)
    rot = rot0.clone().requires_grad_()
    (rev,) = torch.autograd.grad((light(rot) * w).sum(), [rot])
    assert float(rev.abs().max()) > 0
    np.testing.assert_allclose(fwd.numpy(), rev.numpy(), rtol=0,
                               atol=1e-5 * float(rev.abs().max()))
