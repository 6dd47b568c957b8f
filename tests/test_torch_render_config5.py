"""PyTorch port, BASELINE config 5's production render
(``elevenrender_tpu_torch/render_config5.py``) on the CPU against the JAX
package and ``scripts/render_config5.py``'s loop.

The JAX script is never run here: it imports jax without forcing the
CPU.  Its loop is rebuilt from the JAX package's functions:
``render_samples_jit(config, ir, state, 1)`` a sample from
``init_state``, a snapshot (``np.asarray`` of each leaf) at each
checkpoint, ``np.savez_compressed`` of it, and on resume the three keys
back through ``jnp.asarray``.  Its scene is ``tests/scenes.py
textured_heightfield_scene(grid=8, res=16, compat=False)`` with the numpy
BVH build, which the port's own build equals (``test_torch_scene.py``).

(i) GRID=8 RES=16 SPP=6 CKPT=2: the port's loop against JAX one sample
    at a time: sample counts and RNG state exact, every pass within rtol
    1e-4 / atol 1e-5 on >= 99% of pixels (the render parity of the
    integrator tests: XLA contracts a*b+c into FMA, the port rounds each
    op).
(ii) The checkpoint has the JAX script's keys and dtypes; a JAX snapshot
    at 4 samples resumes in the port to 6 within (i)'s tolerance of
    JAX's 6; the port's checkpoint at 4 resumes in the JAX loop to 6, the
    same; the port's checkpoint at 4, resumed to 6, equals the port's
    straight run bit for bit.
(iii) The module as a process: SIGTERM after a checkpoint's progress
    line; the process exits 0 and its ``.npz`` holds the checkpoint it
    names; a second run resumes, ends at ``SPP`` and equals a straight
    run bit for bit; the PNG decodes to the JAX script's image of the
    same snapshot (its formula, through the JAX package's ``write_png``).
    In process: a signal that lands while the sample completing a
    checkpoint renders stops the run at the checkpoint before it.
"""

from torch_threads import child_env  # first: torch's threads a worker

import os
import re
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu.render.integrator import (render_samples_jit as
                                                jax_render_samples)
from elevenrender_tpu.utils.image import write_png as jax_write_png
from elevenrender_tpu_torch import render_config5 as rc5
from elevenrender_tpu_torch.scene import demo
from elevenrender_tpu_torch.utils.image import read_png

from scenes import textured_heightfield_scene
from test_torch_integrator import _close_frac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID, RES, SPP, CKPT = 8, 16, 6, 2
KEYS = {"passes": np.float32, "samples": np.uint32, "rng": np.uint32}


@pytest.fixture(scope="module")
def jax_loop():
    """(config, IR, {n: the JAX loop's snapshot after n samples})."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ELEVENRT_NATIVE", "0")
        _, config, ir = textured_heightfield_scene(grid=GRID, res=RES,
                                                   compat=False)
    state = jax_init_state(config)
    snaps = {0: {k: np.array(v) for k, v in state.items()}}
    for n in range(1, SPP + 1):
        state = jax_render_samples(config, ir, state, 1)
        snaps[n] = {k: np.array(v) for k, v in state.items()}
    return config, ir, snaps


def jax_resume(config, ir, path, n):
    """The JAX script's resume from ``path``, then n samples."""
    data = np.load(path)
    state = {k: jnp.asarray(data[k]) for k in KEYS}
    for _ in range(n):
        state = jax_render_samples(config, ir, state, 1)
    return {k: np.array(v) for k, v in state.items()}


@pytest.fixture(scope="module")
def port_scene():
    _, cfg, ir = demo.textured_heightfield_scene(grid=GRID, res=RES,
                                                 compat=False, device="cpu")
    return cfg, ir


def _assert_render_parity(got, want, label):
    np.testing.assert_array_equal(got["samples"], want["samples"],
                                  err_msg=label)
    np.testing.assert_array_equal(np.asarray(got["rng"], np.uint32),
                                  want["rng"], err_msg=label)
    for pid in range(want["passes"].shape[0]):
        frac = _close_frac(got["passes"][pid], want["passes"][pid])
        assert frac >= 0.99, (label, pid, frac)


def _assert_bit_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k].view(np.uint32),
                                      b[k].view(np.uint32), err_msg=k)


def _npz(path):
    data = np.load(path)
    return {k: data[k] for k in data.files}


def test_the_loop_matches_the_jax_script_sample_by_sample(
        jax_loop, port_scene, tmp_path, monkeypatch):
    config, _, snaps = jax_loop
    cfg, ir = port_scene
    assert cfg.x_res == config.x_res and cfg.n_lights == config.n_lights == 1
    got = {}
    real = rc5.render_samples_jit

    def one_sample(*args, **kw):
        state = real(*args, **kw)
        got[int(state["samples"].max())] = rc5.snapshot(state)
        return state

    monkeypatch.setattr(rc5, "render_samples_jit", one_sample)
    out = rc5.render(cfg, ir, SPP, CKPT, str(tmp_path / "c5"),
                     resume=False, device="cpu")
    assert (out["done"], out["stopped"], out["checkpoints"]) == (SPP, False,
                                                                 SPP // CKPT)
    assert out["launches"] == [0, 0]  # the plain walker: no kernel here
    assert sorted(got) == list(range(1, SPP + 1))
    for n in got:
        _assert_render_parity(got[n], snaps[n], f"sample {n}")
    _assert_bit_equal(_npz(tmp_path / "c5.npz"), got[SPP])
    assert got[SPP]["passes"][0, :, :3].mean() > 0.05


def test_checkpoints_resume_across_packages(jax_loop, port_scene, tmp_path):
    config, jir, snaps = jax_loop
    cfg, ir = port_scene
    port = str(tmp_path / "port")
    rc5.render(cfg, ir, 4, CKPT, port, resume=False, device="cpu")
    at4 = _npz(f"{port}.npz")
    assert set(at4) == set(KEYS)
    for k, dtype in KEYS.items():
        assert at4[k].dtype == dtype and at4[k].shape == snaps[4][k].shape, k
    assert (at4["samples"] == 4).all()

    # The port's checkpoint in the JAX loop, to 6.
    _assert_render_parity(jax_resume(config, jir, f"{port}.npz", 2),
                          snaps[6], "port checkpoint resumed by JAX")

    # The port's checkpoint resumed by the port equals its straight run.
    rc5.render(cfg, ir, SPP, CKPT, port, resume=True, device="cpu")
    straight = str(tmp_path / "straight")
    rc5.render(cfg, ir, SPP, CKPT, straight, resume=False, device="cpu")
    _assert_bit_equal(_npz(f"{port}.npz"), _npz(f"{straight}.npz"))

    # The JAX script's checkpoint at 4 resumed by the port, to 6.
    jax_out = str(tmp_path / "jax")
    np.savez_compressed(f"{jax_out}.npz", **snaps[4])
    out = rc5.render(cfg, ir, SPP, CKPT, jax_out, resume=True, device="cpu")
    assert out["samples_rendered"] == 2
    _assert_render_parity(_npz(f"{jax_out}.npz"), snaps[6],
                          "JAX checkpoint resumed by the port")


def test_a_checkpoint_due_after_sigterm_is_not_taken(port_scene, tmp_path,
                                                     monkeypatch):
    # The signal lands while the sample that completes the second
    # checkpoint renders: the run stops there and flushes the first.
    cfg, ir = port_scene
    real = rc5.render_samples_jit

    def one_sample(*args, **kw):
        state = real(*args, **kw)
        if int(state["samples"].max()) == 2 * CKPT:
            os.kill(os.getpid(), signal.SIGTERM)
        return state

    monkeypatch.setattr(rc5, "render_samples_jit", one_sample)
    out = str(tmp_path / "c5")
    got = rc5.render(cfg, ir, SPP, CKPT, out, resume=False, device="cpu")
    assert (got["done"], got["stopped"], got["checkpoints"]) == (CKPT, True,
                                                                 1)
    assert got["samples_rendered"] == 2 * CKPT
    assert (_npz(f"{out}.npz")["samples"] == CKPT).all()


def _jax_png(snap, path):
    """The JAX script's ``write_out`` image of ``snap``, decoded."""
    img = snap["passes"][0, :, :3].reshape(RES, RES, 3)
    png = np.clip(np.abs(np.concatenate(
        [img, np.ones((RES, RES, 1), np.float32)], -1)), 0.0, None) \
        ** (1.0 / 2.2)
    jax_write_png(str(path), np.clip(png, 0.0, 1.0))
    return read_png(str(path))


def test_sigterm_flushes_the_checkpoint_and_a_second_run_resumes(
        port_scene, tmp_path):
    out = tmp_path / "c5"
    # A target far off, so that the signal lands mid-run.
    env = child_env(GRID=str(GRID), RES=str(RES), SPP="200", CKPT=str(CKPT),
                    OUT=str(out), RESUME="1")
    cmd = [sys.executable, "-m", "elevenrender_tpu_torch.render_config5",
           "--device", "cpu"]
    with open(tmp_path / "stderr", "w") as err:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if f"] {CKPT}/200 samples" in line:
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    log = "".join(lines)
    assert rc == 0, open(tmp_path / "stderr").read()[-2000:]
    flushed = re.search(r"SIGTERM at (\d+) samples; flushing snapshot from "
                        r"(\d+)", log)
    assert flushed, log
    at = int(flushed.group(2))
    assert at % CKPT == 0 and at >= CKPT and "DONE" not in log
    killed = _npz(f"{out}.npz")
    assert (killed["samples"] == at).all()
    np.testing.assert_array_equal(read_png(f"{out}_beauty.png"),
                                  _jax_png(killed, tmp_path / "jax.png"))

    spp = at + 4
    res = subprocess.run(cmd, cwd=REPO, env={**env, "SPP": str(spp)},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"resumed from {out}.npz at {at} samples" in res.stdout
    assert f"DONE: {spp} spp" in res.stdout
    cfg, ir = port_scene
    straight = str(tmp_path / "straight")
    rc5.render(cfg, ir, spp, CKPT, straight, resume=False, device="cpu")
    final = _npz(f"{out}.npz")
    assert (final["samples"] == spp).all()
    _assert_bit_equal(final, _npz(f"{straight}.npz"))
    np.testing.assert_array_equal(read_png(f"{out}_beauty.png"),
                                  _jax_png(final, tmp_path / "jax.png"))
