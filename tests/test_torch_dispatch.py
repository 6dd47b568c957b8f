"""PyTorch port, the compiled dispatch (``render/dispatch.py``) on the CPU.

On a card a sample is captured once as a CUDA graph and replayed; on the
CPU the same ``SampleGraph`` runs the eager sample into the same state
buffers, and that is what these tests drive (``chip_smoke.py`` phase 20
holds the graph to the eager sample on the card).

(a) n samples through ``render_samples_jit`` / ``_safe`` against the JAX
    package's ``render_samples_jit`` on the same scene (a grid-12
    heightfield, and config 5 in miniature with textures and a point
    light; 16x16, 5 bounces, the Pallas kernel in interpret mode): sample
    counts and RNG state equal, beauty and normal within the integrator
    tests' rtol 1e-4 / atol 1e-5 on >= 99% of pixels; and against the
    port's eager loop of ``render_sample``, bit for bit.
(b) One sample after a warm-up builds no tensor from host data
    (``torch.tensor`` / ``as_tensor``) and reads nothing back (``item``,
    ``__bool__``, ``__int__``, ``__float__``, ``tolist``, ``nonzero``)
    outside the plain walkers of ``ops/traverse.py``, which the card does
    not run: on a card each would be a stream sync, which a graph cannot
    capture.  Nor do the gradient path's units (``render/grad.py``): a
    recording sample of pass 1 and a sample's vector-Jacobian product of
    pass 2, replaying the record or tracing again.
(c) The cache: a new config or IR gets a new capture; a dropped IR frees
    its entries.
(d) The ``_safe`` form's result is never written by a later call; the
    donated form's is the captured sample's own buffers.
(e) ``Renderer.load_checkpoint`` then ``step`` equals a fresh renderer
    resumed from the same file.
(f) The launch accounting a replay uses: ``deferred_counts`` takes a
    capture's counts out, ``add_counts`` adds them per replay.
"""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import gc
import sys

import numpy as np
import jax
import pytest
import torch

from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu.render.integrator import (render_samples_jit as
                                                jax_render_samples)
from elevenrender_tpu_torch.ops import traverse as tt
from elevenrender_tpu_torch.render import dispatch
from elevenrender_tpu_torch.render import grad as tg
from elevenrender_tpu_torch.render import integrator as ti
from elevenrender_tpu_torch.render.renderer import Renderer
from elevenrender_tpu_torch.scene import demo

from test_torch_integrator import _close_frac, _convert, _heightfield, _textured

N = 2


def _captures(ir):
    """The captured samples cached for this IR."""
    return list(dispatch._graphs.get(ir["tris"]["verts"], {}).values())


@pytest.fixture(scope="module", params=["heightfield", "textured"])
def jax_pair(request):
    """(JAX state after N samples, port config, port IR) as numpy / CPU."""
    config, ir = (_heightfield if request.param == "heightfield"
                  else _textured)(False)
    want = jax.tree.map(np.asarray, jax_render_samples(
        config, ir, jax_init_state(config), N))
    cfg, tir = _convert(config, ir)
    return want, cfg, tir


@pytest.mark.parametrize("safe", [False, True])
def test_samples_match_jax_and_the_eager_loop(jax_pair, safe):
    want, cfg, ir = jax_pair
    run = (dispatch.render_samples_jit_safe if safe
           else dispatch.render_samples_jit)
    tt.reset_counts()
    got = run(cfg, ir, ti.init_state(cfg, device="cpu"), N, device="cpu")
    assert tt.launches == 0  # the plain walker: no kernel on the CPU
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["samples"], want["samples"])
    np.testing.assert_array_equal(got["rng"], want["rng"].astype(np.int64))
    for pid in (ti.BEAUTY, ti.NORMAL):
        a, b = got["passes"][pid, :, :3], want["passes"][pid, :, :3]
        assert _close_frac(a, b) >= 0.99, pid
    assert got["passes"][ti.BEAUTY, :, :3].mean() > 0.05

    eager = ti.init_state(cfg, device="cpu")
    for _ in range(N):
        eager = ti.render_sample(cfg, ir, eager, device="cpu")
    for k, v in eager.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


def _scene(kind):
    """Port scenes at 16x16: (config, IR) on the CPU."""
    if kind == "compat":
        _, cfg, ir = demo.heightfield_scene(grid=12, res=16, compat=True,
                                            device="cpu")
    elif kind == "textured":
        _, cfg, ir = demo.textured_heightfield_scene(grid=24, res=16,
                                                     compat=False,
                                                     device="cpu")
    else:
        _, cfg, ir = demo.heightfield_scene(grid=12, res=16, compat=False,
                                            device="cpu")
    cfg = cfg.replace(max_bounces=5)
    if kind == "shader":
        # Every material takes slot 0's shader, the placeholder.
        mats = ir["materials"]
        ir = {**ir, "materials": {**mats, "shader": torch.zeros_like(
            mats["shader"])}}
        cfg = cfg.replace(use_shaders=True)
    return cfg, ir


class _HostSyncs:
    """Counts the calls of ``torch.tensor`` / ``as_tensor`` and of the
    tensor methods that read back, made outside ``ops/traverse.py``'s
    plain walkers, by call site in the port."""

    PLAIN = {"traverse_plain", "traverse_frontier_plain"}

    def __init__(self, monkeypatch):
        self.sites = {}
        for owner, name in ((torch, "tensor"), (torch, "as_tensor"),
                            *((torch.Tensor, n) for n in (
                                "item", "__bool__", "__int__", "__float__",
                                "tolist", "nonzero"))):
            monkeypatch.setattr(owner, name, self._wrap(name,
                                                        getattr(owner, name)))

    def _site(self):
        f = sys._getframe(2)
        site = None
        while f is not None:
            path = f.f_code.co_filename.replace("\\", "/")
            if (path.endswith("ops/traverse.py")
                    and f.f_code.co_name in self.PLAIN):
                return None
            if "/elevenrender_tpu_torch/" in path and site is None:
                site = (f"{path.split('/elevenrender_tpu_torch/')[1]}:"
                        f"{f.f_lineno}")
            f = f.f_back
        return site

    def _wrap(self, name, fn):
        def counted(*args, **kw):
            site = self._site()
            if site is not None:
                key = f"{name} at {site}"
                self.sites[key] = self.sites.get(key, 0) + 1
            return fn(*args, **kw)
        return counted


@pytest.mark.parametrize("kind", ["native", "textured", "compat", "shader"])
def test_a_sample_builds_and_reads_back_nothing(kind, monkeypatch):
    cfg, ir = _scene(kind)
    state = ti.render_sample(cfg, ir, ti.init_state(cfg, device="cpu"),
                             device="cpu")  # warm-up
    syncs = _HostSyncs(monkeypatch)
    ti.render_sample(cfg, ir, state, device="cpu")
    assert syncs.sites == {}


@pytest.mark.parametrize("replayed", [True, False],
                         ids=["replayed", "retraced"])
@pytest.mark.parametrize("kind", ["native", "textured"])
def test_a_recording_and_a_vjp_sample_build_and_read_back_nothing(
        kind, replayed, monkeypatch):
    cfg, ir = _scene(kind)
    params = {"materials": tg.float_subtree(ir["materials"])}
    tree, flat = tg._as_parameters(params)
    merged = tg._merge(ir, tree)
    state = ti.init_state(cfg, device="cpu")
    seed = torch.full((state["rng"].shape[0], 3), 1e-3)

    def units():
        with torch.no_grad():
            _, trace = ti.render_sample(cfg, merged, state, record=True,
                                        device="cpu")
        got, _ = tg._vjp_sample(cfg, merged, flat, state["rng"], seed,
                                trace if replayed else None)
        return got

    units()  # warm-up
    syncs = _HostSyncs(monkeypatch)
    got = units()
    assert syncs.sites == {}
    assert float(got[tg._paths(params).index(("materials", "roughness"))]
                 .abs().sum()) > 0


def test_a_new_config_or_ir_gets_a_new_capture_and_a_dropped_ir_frees_it():
    cfg, ir = _scene("native")
    state = ti.init_state(cfg, device="cpu")
    assert _captures(ir) == []
    dispatch.render_sample_jit_safe(cfg, ir, state, device="cpu")
    first = _captures(ir)
    assert len(first) == 1 and first[0].state is not None
    dispatch.render_sample_jit_safe(cfg, ir, state, device="cpu")
    assert _captures(ir) == first
    dispatch.render_sample_jit_safe(cfg.replace(max_bounces=2), ir, state,
                                    device="cpu")
    assert len(_captures(ir)) == 2
    # The same tensors under a new dict are the same IR; a replaced
    # tensor is another.
    same = {grp: dict(leaves) for grp, leaves in ir.items()}
    dispatch.render_sample_jit_safe(cfg, same, state, device="cpu")
    assert len(_captures(ir)) == 2
    other = {**ir, "env": {**ir["env"], "img": ir["env"]["img"].clone()}}
    dispatch.render_sample_jit_safe(cfg, other, state, device="cpu")
    assert len(_captures(ir)) == 3
    # Another scene has entries of its own.
    cfg2, ir2 = _scene("native")
    dispatch.render_sample_jit_safe(cfg2, ir2, state, device="cpu")
    assert len(_captures(ir2)) == 1
    n = len(dispatch._graphs)
    del ir, same, other, first
    gc.collect()
    assert len(dispatch._graphs) == n - 1
    assert len(_captures(ir2)) == 1


def test_the_safe_form_is_never_written_and_the_donated_form_is_the_buffers():
    cfg, ir = _scene("native")
    snap = dispatch.render_samples_jit_safe(cfg, ir, ti.init_state(
        cfg, device="cpu"), 2, device="cpu")
    kept = {k: v.clone() for k, v in snap.items()}
    (graph,) = _captures(ir)
    assert all(snap[k].data_ptr() != graph.state[k].data_ptr() for k in snap)
    nxt = dispatch.render_samples_jit_safe(cfg, ir, snap, 2, device="cpu")
    for k, v in kept.items():
        assert torch.equal(snap[k], v), k
    assert int(nxt["samples"][0]) == 4 and int(snap["samples"][0]) == 2

    donated = dispatch.render_samples_jit(cfg, ir, snap, 1, device="cpu")
    assert all(donated[k] is graph.state[k] for k in donated)
    before = donated["passes"].clone()
    again = dispatch.render_sample_jit(cfg, ir, donated, device="cpu")
    assert again["passes"] is donated["passes"]
    assert not torch.equal(donated["passes"], before)
    assert int(again["samples"][0]) == 4


def test_load_checkpoint_then_step_equals_a_fresh_resume(tmp_path):
    cfg, ir = _scene("textured")
    path = str(tmp_path / "ckpt.npz")
    r = Renderer(cfg, ir, device="cpu")
    r.step(2)
    r.save_checkpoint(path)
    r.step(2)  # the captured sample's buffers move on past the file
    r.load_checkpoint(path)
    r.step(2)
    fresh = Renderer(cfg, ir, device="cpu")
    fresh.load_checkpoint(path)
    fresh.step(2)
    for k in ("passes", "samples", "rng"):
        assert torch.equal(r.state[k], fresh.state[k]), k
    assert r.get_render_info() == {"samples": 4}


def test_replays_add_what_the_capture_counted():
    tt.reset_counts()
    tt.launches, tt.any_hit_launches = 3, 1
    tt.count_variant(("near", 0, "full", False))
    with tt.deferred_counts() as counts:
        for any_hit in (False, True, True):
            tt.launches += 1
            tt.any_hit_launches += int(any_hit)
            tt.count_variant(("near", 0, "full", False))
        tt.frontier_launches += 1
        tt.count_variant(("frontier=4", 0, "full", False))
    assert (tt.launches, tt.any_hit_launches, tt.frontier_launches) == (3, 1, 0)
    assert tt.variant_launches == {("near", 0, "full", False): 1}
    assert counts["launches"] == 3 and counts["any_hit_launches"] == 2
    assert counts["variant_launches"] == {("near", 0, "full", False): 3,
                                          ("frontier=4", 0, "full", False): 1}
    for _ in range(2):
        tt.add_counts(counts)
    assert (tt.launches, tt.any_hit_launches, tt.frontier_launches) == (9, 5, 2)
    assert tt.variant_launches == {("near", 0, "full", False): 7,
                                   ("frontier=4", 0, "full", False): 2}
    tt.reset_counts()
