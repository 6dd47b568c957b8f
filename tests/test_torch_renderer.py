"""PyTorch port, the render lifecycle on the CPU: the background thread
in chunks (start / stop / join, readback while it runs), checkpoints
(resume exactly, the resolution guard, files interchangeable with the
JAX package's), the denoised passes against the JAX denoiser on the same
passes, ``save_pass``, ``profile`` and ``find_device``.

The scene is the JAX package's Cornell box at 16x16 (brute-force trace),
carried across by ``ir_from_numpy``; ``tests/test_checkpoint.py``'s three
cases run on the port.  No JAX render: the JAX side only saves, loads
and denoises."""

import dataclasses
import json
import threading
import time

import numpy as np
import jax
import pytest
import torch

from elevenrender_tpu.render import denoise as jax_denoise
from elevenrender_tpu.render.renderer import Renderer as JaxRenderer
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.render import dispatch as dmod
from elevenrender_tpu_torch.render import integrator as ti
from elevenrender_tpu_torch.render import renderer as rmod
from elevenrender_tpu_torch.render.renderer import Renderer, find_device
from elevenrender_tpu_torch.utils.image import read_png

from scenes import cornell_scene

RES = 16


def _scene(compat=False, res=RES, **replace):
    _, config, ir = cornell_scene(res=res, spp=4, compat=compat)
    config = config.replace(max_bounces=2, **replace)
    cfg, tir = ir_from_numpy(dataclasses.asdict(config),
                             jax.tree.map(np.asarray, ir), device="cpu")
    return config, ir, cfg.replace(device="cpu"), tir


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _state(r):
    return {k: v.numpy().copy() for k, v in r.state.items()}


def test_checkpoint_resume_exact(scene, tmp_path):
    _, _, cfg, ir = scene
    ref = Renderer(cfg, ir)
    ref.step(4)
    r1 = Renderer(cfg, ir)
    r1.step(2)
    r1.save_checkpoint(str(tmp_path / "state.npz"))
    r2 = Renderer(cfg, ir)
    r2.load_checkpoint(str(tmp_path / "state.npz"))
    r2.step(2)
    np.testing.assert_array_equal(r2.get_pass("beauty"),
                                  ref.get_pass("beauty"))
    for k, v in _state(r2).items():
        np.testing.assert_array_equal(v, _state(ref)[k], err_msg=k)


def test_checkpoint_resolution_guard(scene, tmp_path):
    _, _, cfg, ir = scene
    Renderer(cfg, ir).save_checkpoint(str(tmp_path / "s.npz"))
    _, _, cfg24, ir24 = _scene(res=24)
    with pytest.raises(ValueError, match="resolution"):
        Renderer(cfg24, ir24).load_checkpoint(str(tmp_path / "s.npz"))


def test_checkpoints_are_interchangeable_with_jax(scene, tmp_path):
    """The port writes the JAX package's keys and dtypes, and each
    package loads the other's file: a JAX checkpoint of the port's state
    after 2 samples resumes in the port to the uninterrupted 4."""
    config, ir, cfg, tir = scene
    r = Renderer(cfg, tir)
    r.step(2)
    ours = str(tmp_path / "port.npz")
    r.save_checkpoint(ours)
    data = np.load(ours)
    assert sorted(data.files) == ["passes", "rng", "samples", "x_res",
                                  "y_res"]
    assert (data["samples"].dtype, data["rng"].dtype) == (np.uint32,
                                                          np.uint32)

    jr = JaxRenderer(config, ir)
    jr.load_checkpoint(ours)
    theirs = str(tmp_path / "jax.npz")
    jr.save_checkpoint(theirs)
    jdata = np.load(theirs)
    for k in data.files:
        assert data[k].dtype == jdata[k].dtype, k
        np.testing.assert_array_equal(data[k], jdata[k], err_msg=k)

    r2 = Renderer(cfg, tir)
    r2.load_checkpoint(theirs)
    r2.step(2)
    ref = Renderer(cfg, tir)
    ref.step(4)
    for k, v in _state(r2).items():
        np.testing.assert_array_equal(v, _state(ref)[k], err_msg=k)


def test_start_renders_in_chunks_and_reads_back_while_running(scene):
    """start in chunks of 3 to 10 samples: readback while the thread
    runs sees whole chunks only (0, 3, 6, 9), and the result equals a
    synchronous step(10) exactly."""
    _, _, cfg, ir = scene
    r = Renderer(cfg, ir)
    seen = set()
    r.start(10, samples_per_dispatch=3)
    while r._thread.is_alive():
        info = r.get_render_info()["samples"]
        img = r.get_pass("beauty")
        assert img.shape == (RES * RES * 4,) and np.isfinite(img).all()
        seen.add(info)
        time.sleep(0.005)
    r.join()
    assert r.error is None
    assert seen <= {0, 3, 6, 9, 10}
    assert r.get_render_info() == {"samples": 10}
    ref = Renderer(cfg, ir)
    ref.step(10)
    np.testing.assert_array_equal(r.get_pass("beauty"),
                                  ref.get_pass("beauty"))
    np.testing.assert_array_equal(r.get_pass("normal"),
                                  ref.get_pass("normal"))


def test_default_chunk_is_block_size_bounded_by_the_recommendation(scene,
                                                                   monkeypatch):
    _, _, cfg, ir = scene
    published = []
    r = Renderer(cfg.replace(block_size=4), ir)
    real = r._publish
    monkeypatch.setattr(r, "_publish", lambda s, e: (
        published.append(int(s["samples"][0])), real(s, e)))
    r.start(9)
    r.join()
    assert published == [4, 8, 9]
    monkeypatch.setenv("ELEVENRT_SAMPLES_PER_DISPATCH", "2")
    published.clear()
    r.start(3)
    r.join()
    assert published == [11, 12]


def test_stop_pauses_and_start_resumes(scene):
    """test_checkpoint.py's pause case: stop() keeps the accumulated
    samples; start(3) then adds exactly 3."""
    _, _, cfg, ir = scene
    r = Renderer(cfg, ir)
    r.start(sample_target=1_000_000, samples_per_dispatch=1)
    deadline = time.time() + 60
    while r.get_render_info()["samples"] < 2 and time.time() < deadline:
        time.sleep(0.01)
    r.stop()
    r.join()
    mid = r.get_render_info()["samples"]
    assert 2 <= mid < 1_000_000
    time.sleep(0.05)
    assert r.get_render_info()["samples"] == mid
    r.start(sample_target=3)
    r.join()
    assert r.get_render_info()["samples"] == mid + 3


def test_a_failed_chunk_ends_the_thread_and_keeps_the_progress(
        scene, monkeypatch):
    _, _, cfg, ir = scene
    r = Renderer(cfg, ir)
    calls = []
    real = ti.render_sample

    def flaky(*args, **kw):
        calls.append(1)
        if len(calls) == 4:
            raise RuntimeError("launch failed")
        return real(*args, **kw)

    monkeypatch.setattr(dmod, "render_sample", flaky)
    r.start(8, samples_per_dispatch=2)
    r.join()
    assert isinstance(r.error, RuntimeError)
    assert r.get_render_info() == {"samples": 2}
    assert len(calls) == 4


def test_denoise_pass_equals_jax_denoise_on_the_same_passes(scene):
    """The "denoise" pass: the beauty guided by the normal pass and the
    first-hit albedo (the DENOISE slot), as the JAX package computes
    it from the same three passes."""
    _, _, cfg, ir = scene
    r = Renderer(cfg, ir)
    r.step(2)
    raw = {p: r.get_pass(p, apply_denoise=False)
           for p in ("beauty", "normal")}
    albedo = r.state["passes"][ti.DENOISE].numpy().reshape(-1)
    ref = np.asarray(jax_denoise.denoise(RES, RES, raw["beauty"],
                                         raw["normal"], albedo))
    got = r.get_pass("denoise")
    assert got.dtype == np.float32 and got.shape == (RES * RES * 4,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(got - raw["beauty"]).max() > 0


@pytest.mark.parametrize("name", ["beauty", "normal"])
def test_config_denoise_is_the_colour_only_filter_with_alpha_one(scene,
                                                                 name):
    _, _, cfg, ir = scene
    r = Renderer(cfg.replace(denoise=True), ir)
    r.step(2)
    raw = r.get_pass(name, apply_denoise=False)
    ref = np.array(jax_denoise.denoise(RES, RES, raw), np.float32)
    ref[3::4] = 1.0
    got = r.get_pass(name)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert (got[3::4] == 1.0).all()


def test_save_pass_is_read_back_by_read_png(scene, tmp_path):
    _, _, cfg, ir = scene
    r = Renderer(cfg, ir)
    r.step(1)
    path = str(tmp_path / "beauty.png")
    r.save_pass("beauty", path)
    back = read_png(path)
    assert back.shape == (RES, RES, 4)
    want = np.clip(np.clip(np.abs(r.get_pass("beauty")), 0, None)
                   ** (1 / 2.2), 0, 1).reshape(RES, RES, 4)
    np.testing.assert_allclose(back, want, atol=0.5 / 255 + 1e-6)


def test_profile_writes_a_trace(scene, tmp_path):
    _, _, cfg, ir = scene
    r = Renderer(cfg, ir)
    r.profile(str(tmp_path / "prof"), n_samples=1)
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert trace["traceEvents"]
    assert r.get_render_info() == {"samples": 1}


def test_profile_traces_every_sample(tmp_path):
    """``profile(path, n)`` traces each sample in a profiling session of
    its own (a session over several graph replays loses device records
    on a card) and writes the sessions' events into the one trace.json:
    3 samples hold 3 times the per-bounce ray sorts of 1, and the
    naming records are not repeated."""
    from elevenrender_tpu_torch.scene.demo import heightfield_scene
    _, cfg, ir = heightfield_scene(grid=8, res=RES, device="cpu")
    r = Renderer(cfg.replace(max_bounces=2), ir, device="cpu")
    r.step(1)
    sorts = {}
    for n in (1, 3):
        path = tmp_path / str(n)
        r.profile(str(path), n_samples=n)
        assert sorted(p.name for p in path.iterdir()) == ["trace.json"]
        events = json.load(open(path / "trace.json"))["traceEvents"]
        sorts[n] = sum(e.get("name") == "aten::sort" for e in events)
        named = [json.dumps([e.get(k) for k in ("name", "pid", "tid",
                                                 "args")])
                 for e in events if e.get("ph") == "M"]
        assert len(named) == len(set(named))
    assert sorts[1] > 0 and sorts[3] == 3 * sorts[1]
    assert r.get_render_info() == {"samples": 5}


def test_profile_traces_a_short_session_again(monkeypatch, tmp_path):
    """A session that saw fewer device events than the most seen lost
    records (the card's profiler does that now and then): its sample is
    taken back and traced again, so the file holds n full samples and
    the renderer n more samples.  Device events are faked here, one
    short session among full ones."""
    from elevenrender_tpu_torch.scene.demo import heightfield_scene
    _, cfg, ir = heightfield_scene(grid=8, res=RES, device="cpu")
    r = Renderer(cfg.replace(max_bounces=2), ir, device="cpu")
    r.step(1)
    real = Renderer._profiled_sample
    sessions = []
    sorts = []

    def faked(self, activities, part):
        got = real(self, activities, part)
        sorts.append(sum(e.get("name") == "aten::sort"
                         for e in got["traceEvents"]))
        kernels = 1 if len(sessions) == 1 else 2  # the first after the probe
        sessions.append(kernels)
        got["traceEvents"] += [{"ph": "X", "cat": "kernel", "name": "fake",
                                "ts": 0, "dur": 1}] * kernels
        return got

    monkeypatch.setattr(Renderer, "_profiled_sample", faked)
    r.profile(str(tmp_path), n_samples=2)
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert sessions == [2, 1, 2, 2]
    assert sum(e.get("name") == "fake" for e in events) == 4
    assert sorts[0] > 0 and sum(
        e.get("name") == "aten::sort" for e in events) == 2 * sorts[0]
    assert r.get_render_info() == {"samples": 3}


def test_find_device_names(monkeypatch):
    """"" is cuda:0, "cpu" / "cuda" / "cuda:N" what they say; an
    unknown name warns and means cuda:0, never the CPU."""
    warned = []
    monkeypatch.setattr(rmod.log, "warning",
                        lambda *a: warned.append(a[1]))
    assert find_device("") == torch.device("cuda", 0)
    assert find_device("cpu") == torch.device("cpu")
    assert find_device("cuda") == torch.device("cuda")
    assert not warned
    bogus = ("TPU v5 lite:0|tpu", "cuda:64", "mps")
    for name in bogus:
        assert find_device(name) == torch.device("cuda", 0), name
    assert warned == list(bogus)


def test_the_config_device_picks_the_renderer_device(scene):
    _, _, cfg, ir = scene
    assert Renderer(cfg, ir).device == torch.device("cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(cfg.replace(device=""), ir)
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(cfg.replace(device="nonsense"), ir)


def test_readback_holds_no_lock_across_a_chunk(scene, monkeypatch):
    """A reader gets its answer while a chunk is held in flight: only the
    snapshot swap is under the lock."""
    _, _, cfg, ir = scene
    r = Renderer(cfg, ir)
    gate = threading.Event()
    real = ti.render_sample

    def held(*args, **kw):
        gate.wait(10)
        return real(*args, **kw)

    monkeypatch.setattr(dmod, "render_sample", held)
    r.start(2, samples_per_dispatch=1)
    try:
        assert r.get_render_info() == {"samples": 0}
        assert r.get_pass("beauty").shape == (RES * RES * 4,)
        assert not gate.is_set() and r._thread.is_alive()
    finally:
        gate.set()
        r.join()
    assert r.get_render_info() == {"samples": 2}
