"""Inverse rendering (BASELINE config 4): scene parameters recovered from
a target image by descent through the renderer.

    python3 -m elevenrender_tpu_torch.inverse_demo [outdir] [--device cpu]

Port of ``scripts/inverse_demo.py``'s three stages.  Each target is
rendered with the same estimator (the same sample count, from the same
RNG state, ``init_state``) as every step, so the true parameters are the
exact minimiser:

1. albedo: the Cornell box at 32x32, 2 samples, native, 2 bounces; the
   white wall's albedo (material row 0, the other rows' gradients
   masked) by Adam at lr 0.05 for 100 steps through
   ``render_loss_and_grad``, clipped to [0, 1]; the recovered and the
   target image written as PNG;
2. camera rotation: a 24x24 heightfield under a smooth bilinear albedo
   texture, 1 bounce; the observable is the first-hit albedo AOV of
   ``sample_radiance`` from a fixed RNG state; Levenberg-Marquardt with a
   trust-region clamp on the 4x-pooled residuals (25 steps), then on the
   full ones (25 steps); the Jacobian as ``jax.jacfwd`` takes it, one
   forward-mode JVP (``torch.autograd.forward_ad``) per rotation
   coordinate.  The traversal takes primal rays and its hits are
   constants, as in the JAX package;
3. environment tint: the Cornell box's environment image times a
   per-channel tint, the image a gradient leaf and the tint's gradient
   ``sum(g_img * base, axis=(0, 1))``; Adam at lr 0.05 for 120 steps,
   clipped to [0, 4].

``albedo_stage(..., accum=True)`` is stage 1 through
``render_loss_and_grad_accum`` (the two-pass accumulator, chunk 8), the
form that fits at full width: ``chip_smoke.py`` runs it on the main
path's scene at 1024x1024.  ``Adam`` is optax's ``adam`` in its order of
operations, so that the tests hold each stage's steps to the JAX
script's.  On the card the stages run ``render/grad.py``'s graphs (one
capture, then a replay a step: the parameters are the captures' static
buffers); the Jacobians of stage 2 run eagerly.  The process keeps
TF32 off: the material gathers' backward is a full-float32 product.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .core import spans
from .core.device import resolve_device
from .render import grad as grad_mod
from .render.integrator import init_state, sample_radiance
from .scene.demo import cornell_scene, heightfield_mesh
from .scene.hdri import HDRI
from .scene.material import Material
from .scene.scene import Scene
from .scene.texture import Texture

# The JAX script's sizes, step size, targets and starts.  Stage 1
# recovers material row 0 (the Cornell box's white wall; the
# heightfield's one material).
DEMO_RES = 32
LR = 0.05
ROW = 0
ALBEDO_TARGET = (0.15, 0.55, 0.75)
TINT_TARGET = (1.6, 0.9, 0.5)
ROTATION_START_OFFSET = (1.5, -1.2, 1.0)  # degrees, about a pixel


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8) on a tree (dicts of
    tensors) or one tensor, in optax's order of operations: ``mu = (1 -
    b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, ``mu_hat = mu / (1 -
    b1^t)``, ``nu_hat = nu / (1 - b2^t)`` (the corrections in float32),
    and the step ``-lr * mu_hat / (sqrt(nu_hat) + eps)``."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, params):
        self.lr = lr
        self.mu = _tree_map(torch.zeros_like, params)
        self.nu = _tree_map(torch.zeros_like, params)
        self.count = 0

    def step(self, params, grads):
        """The parameters after one step on ``grads`` (span ``adam``)."""
        leaf = grads
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        with spans.span("adam", leaf.device):
            return self._step(params, grads)

    def _step(self, params, grads):
        self.count += 1
        b1, b2 = self.B1, self.B2
        self.mu = _tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads,
                            self.mu)
        self.nu = _tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                            self.nu)
        # Float32 values, as the host scalars the divisions take.
        one = np.float32(1)
        bc1 = float(one - np.float32(b1) ** self.count)
        bc2 = float(one - np.float32(b2) ** self.count)

        def update(p, m, v):
            return p + (-self.lr) * ((m / bc1)
                                     / (torch.sqrt(v / bc2) + self.EPS))
        return _tree_map(update, params, self.mu, self.nu)


def _log(log, msg):
    if log is not None:
        log(msg)


# --- stage 1: albedo -------------------------------------------------------

def _with_albedo(ir, table):
    return {**ir, "materials": {**ir["materials"], "albedo": table}}


def _row_set(table, value):
    out = table.clone()
    out[ROW] = torch.as_tensor(value, dtype=table.dtype, device=table.device)
    return out


def albedo_problem(config, ir, target_albedo, n_samples: int, device):
    """(the target [npix, 3]: ``n_samples`` of the scene with material row
    ``ROW``'s albedo set to ``target_albedo``; the start, {"materials":
    {"albedo": the scene's table}}; the row mask)."""
    albedo = ir["materials"]["albedo"]
    with torch.no_grad():
        target, _ = grad_mod.render_beauty(
            config, _with_albedo(ir, _row_set(albedo, target_albedo)),
            n_samples, device=resolve_device(device))
    mask = _row_set(torch.zeros_like(albedo), 1.0)
    return target.clone(), {"materials": {"albedo": albedo.clone()}}, mask


def albedo_stage(config, ir, target_albedo, iters: int, n_samples: int,
                 device="cuda", accum: bool = False,
                 chunk: int | None = None, log=print,
                 on_step=None) -> dict:
    """Stage 1: material row ``ROW``'s albedo by Adam from the scene's own,
    toward a target rendered at ``target_albedo``.  Each step is
    ``render_loss_and_grad`` (or, with ``accum``,
    ``render_loss_and_grad_accum`` at ``chunk``), the gradient masked to
    the row, an Adam step and a clip to [0, 1].  ``on_step(it, loss,
    grads, s)`` is called after each whole step with its unmasked
    gradient (``s``: the step's host-clock seconds, from its start to the
    readback of the updated row, which waits for its device work).  Returns {"losses",
    "albedos" (row ``ROW`` after each step), "start", "target",
    "params"}."""
    dev = resolve_device(device)
    target, params, mask = albedo_problem(config, ir, target_albedo,
                                          n_samples, dev)
    opt = Adam(LR, params)
    losses, albedos = [], []
    start = params["materials"]["albedo"][ROW].cpu().numpy()
    _log(log, f"target albedo: {np.asarray(target_albedo)}")
    for it in range(iters):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if accum:
            loss, grads = grad_mod.render_loss_and_grad_accum(
                config, ir, params, target, n_samples, chunk=chunk,
                device=dev)
        else:
            loss, grads = grad_mod.render_loss_and_grad(
                config, ir, params, target, n_samples, device=dev)
        masked = {"materials": {"albedo": grads["materials"]["albedo"]
                                * mask}}
        params = opt.step(params, masked)
        params["materials"]["albedo"] = torch.clamp(
            params["materials"]["albedo"], 0.0, 1.0)
        losses.append(float(loss))
        albedos.append(params["materials"]["albedo"][ROW].cpu().numpy())
        if on_step is not None:
            on_step(it, loss, grads, time.perf_counter() - t0)
        if it % 10 == 0:
            _log(log, f"iter {it:3d}  loss {losses[-1]:.6f}  "
                 f"albedo {albedos[-1]}")
    _log(log, f"recovered: {albedos[-1]}  (target "
         f"{np.asarray(target_albedo)})")
    return {"losses": losses, "albedos": albedos, "start": start,
            "target": np.asarray(target_albedo, np.float32),
            "params": params}


def recovered(result: dict) -> bool:
    """The JAX test's criteria (``tests/test_grad_and_sharding.py``): the
    last loss below half the first, and the mean albedo error below the
    start's."""
    tgt = result["target"]
    return bool(result["losses"][-1] < 0.5 * result["losses"][0]
                and np.abs(result["albedos"][-1] - tgt).mean()
                < np.abs(result["start"] - tgt).mean())


def write_albedo_images(config, ir, params, target_albedo, outdir: str,
                        device) -> None:
    """The recovered and the target scene, 8 samples each, as
    ``inverse_recovered.png`` and ``inverse_target.png`` (gamma 1/2.2)."""
    from .utils.image import write_png
    want = _row_set(ir["materials"]["albedo"], target_albedo)
    for name, table in (("inverse_recovered",
                         params["materials"]["albedo"]),
                        ("inverse_target", want)):
        with torch.no_grad():
            img, _ = grad_mod.render_beauty(
                config, _with_albedo(ir, table), 8, device=device)
        arr = img.cpu().numpy().reshape(config.y_res, config.x_res, 3)
        write_png(os.path.join(outdir, f"{name}.png"),
                  np.clip(np.abs(arr), 0, 1) ** (1 / 2.2))


# --- stage 2: camera rotation ----------------------------------------------

def camera_scene(res: int, device="cuda"):
    """The JAX script's stage-2 scene: a 24x24 heightfield whose albedo
    is a smooth, non-periodic bilinear texture (one anisotropic blob and
    corner ramps), a two-tone sky, the main path's camera; native, 1
    bounce.  Returns (config, ir)."""
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
    config, ir = scene.build(device=device)
    return config.replace(compat=False, max_bounces=1), ir


def albedo_aov(config, ir, rot, rng):
    """The first-hit albedo AOV [res, res, 3] with the camera rotated to
    ``rot`` (degrees), one sample from the RNG state ``rng``."""
    cam_ir = {**ir, "camera": {**ir["camera"], "rotation": rot}}
    out, _ = sample_radiance(config, cam_ir, rng,
                             config.x_res * config.y_res)
    return out["albedo"].reshape(config.y_res, config.x_res, 3)


def jacobian(fn, x):
    """d fn / d x [m, n] for a vector ``x`` of n, as ``jax.jacfwd``: one
    forward-mode JVP per coordinate, ``fn``'s output flattened."""
    cols = []
    eye = torch.eye(x.numel(), dtype=x.dtype, device=x.device)
    with fwAD.dual_level():
        for k in range(x.numel()):
            y = fn(fwAD.make_dual(x, eye[k]))
            t = fwAD.unpack_dual(y).tangent
            cols.append(torch.zeros_like(y) if t is None else t)
    return torch.stack([c.reshape(-1) for c in cols], dim=1)


def _pool4(x):
    h, w, c = x.shape
    return x.reshape(h // 4, 4, w // 4, 4, c).mean(dim=(1, 3))


def camera_residuals(config, ir):
    """(the true rotation, res_coarse, res_fine): the residual functions
    of a rotation against the target rendered at the true one, the
    4x-pooled and the full, from the same RNG state."""
    rng = init_state(config, ir["camera"]["rotation"].device)["rng"]
    true_rot = ir["camera"]["rotation"].clone()
    with torch.no_grad():
        target = albedo_aov(config, ir, true_rot, rng)

    def res_coarse(rot):
        return (_pool4(albedo_aov(config, ir, rot, rng))
                - _pool4(target)).reshape(-1)

    def res_fine(rot):
        return (albedo_aov(config, ir, rot, rng) - target).reshape(-1)
    return true_rot, res_coarse, res_fine


def levenberg_marquardt(rot, res_fn, iters: int, trust: float, true_rot,
                        label: str, log=print):
    """The JAX script's Levenberg-Marquardt with a trust-region clamp:
    per step the Jacobian, up to 10 damped solves of the 3x3 normal
    equations (the step clamped to ``trust``), the first that lowers the
    loss taken (damping / 3, at least 1e-6), else damping x 4; ends on a
    step that found none."""
    with torch.no_grad():
        lam = 1e-2
        r = res_fn(rot)
        loss = float(torch.mean(r * r))
        eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
        for it in range(iters):
            J = jacobian(res_fn, rot)
            JTJ = J.T @ J
            JTr = J.T @ r
            improved = False
            for _ in range(10):
                delta = torch.linalg.solve(JTJ + lam * eye, -JTr)
                nrm = float(torch.linalg.norm(delta))
                if nrm > trust:
                    delta = delta * (trust / nrm)
                cand = rot + delta
                r2 = res_fn(cand)
                l2 = float(torch.mean(r2 * r2))
                if l2 < loss:
                    rot, r, loss = cand, r2, l2
                    lam = max(lam / 3.0, 1e-6)
                    improved = True
                    break
                lam *= 4.0
            if it % 5 == 0:
                err = float((rot - true_rot).abs().max())
                _log(log, f"[{label}] iter {it:3d}  loss {loss:.7f}  "
                     f"rot-err {err:.3f} deg  lam {lam:.1e}")
            if not improved:
                break
    return rot


def camera_stage(config, ir, log=print) -> dict:
    """Stage 2: the rotation from the true one plus
    ``ROTATION_START_OFFSET``, coarse then fine.  Returns {"rotation",
    "true", "err" (the largest coordinate's error, degrees)}."""
    true_rot, res_coarse, res_fine = camera_residuals(config, ir)
    rot = true_rot + torch.tensor(ROTATION_START_OFFSET, dtype=torch.float32,
                                  device=true_rot.device)
    rot = levenberg_marquardt(rot, res_coarse, 25, 0.8, true_rot, "coarse",
                              log)
    rot = levenberg_marquardt(rot, res_fine, 25, 0.25, true_rot, "fine", log)
    err = float((rot - true_rot).abs().max())
    _log(log, f"recovered rotation {rot.cpu().numpy()} (true "
         f"{true_rot.cpu().numpy()}), max err {err:.4f} deg (start err 1.5)")
    return {"rotation": rot.cpu().numpy(), "true": true_rot.cpu().numpy(),
            "err": err}


# --- stage 3: environment tint ---------------------------------------------

def tint_stage(config, ir, true_tint, iters: int, n_samples: int,
               device="cuda", log=print) -> dict:
    """Stage 3: a per-channel tint of the environment image by Adam from
    ones, toward a target rendered with the image times ``true_tint``;
    the image is the gradient leaf, clipped to [0, 4] after each step.
    Returns {"losses", "tints" (after each step), "err"}."""
    dev = resolve_device(device)
    base = ir["env"]["img"]
    want = torch.as_tensor(true_tint, dtype=torch.float32, device=base.device)
    tinted = {**ir, "env": {**ir["env"], "img": base * want}}
    with torch.no_grad():
        target, _ = grad_mod.render_beauty(config, tinted, n_samples,
                                           device=dev)
    target = target.clone()
    tint = torch.ones(3, dtype=torch.float32, device=base.device)
    opt = Adam(LR, tint)
    losses, tints = [], []
    for it in range(iters):
        params = {"env": {"img": base * tint}}
        loss, grads = grad_mod.render_loss_and_grad(config, ir, params,
                                                    target, n_samples,
                                                    device=dev)
        g_tint = torch.sum(grads["env"]["img"] * base, dim=(0, 1))
        tint = torch.clamp(opt.step(tint, g_tint), 0.0, 4.0)
        losses.append(float(loss))
        tints.append(tint.cpu().numpy())
        if it % 20 == 0:
            _log(log, f"iter {it:3d}  loss {losses[-1]:.6f}  tint "
                 f"{tints[-1]}")
    err = float(np.abs(tints[-1] - np.asarray(true_tint, np.float32)).max())
    _log(log, f"recovered tint {tints[-1]} (true {np.asarray(true_tint)}), "
         f"max err {err:.4f}")
    return {"losses": losses, "tints": tints, "err": err}


# --- the demo ----------------------------------------------------------------

def run(outdir: str, device="cuda", log=print) -> dict:
    """The three stages at the JAX script's sizes, with its assertions
    (as exceptions).  Returns each stage's result."""
    dev = resolve_device(device)
    os.makedirs(outdir, exist_ok=True)
    _, config, ir = cornell_scene(res=DEMO_RES, spp=2, device=dev)
    config = config.replace(compat=False, max_bounces=2)
    albedo = albedo_stage(config, ir, ALBEDO_TARGET, 100, 2, dev, log=log)
    write_albedo_images(config, ir, albedo["params"], ALBEDO_TARGET, outdir,
                        dev)
    _log(log, f"images written to {outdir}")
    if not recovered(albedo):
        raise RuntimeError("albedo was not recovered")

    _log(log, "\n[stage 2] camera rotation recovery")
    cfg_cam, ir_cam = camera_scene(DEMO_RES, dev)
    camera = camera_stage(cfg_cam, ir_cam, log)
    if not camera["err"] < 0.2:
        raise RuntimeError("camera rotation did not converge")

    _log(log, "\n[stage 3] environment tint recovery")
    tint = tint_stage(config, ir, TINT_TARGET, 120, 2, dev, log=log)
    if not tint["err"] < 0.05:
        raise RuntimeError("env tint did not converge")
    _log(log, "\nALL STAGES OK: albedo + camera rotation + env tint "
         "recovered")
    return {"albedo": albedo, "camera": camera, "tint": tint}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("outdir", nargs="?", default="out")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    run(args.outdir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
