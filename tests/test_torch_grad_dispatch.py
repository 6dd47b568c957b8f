"""PyTorch port, the gradient path's compiled programs on the CPU.

On a card each program of ``render/grad.py`` is a CUDA graph: pass 1
replays the captured sample and copies each sample's trace record out,
pass 2 replays one sample's forward, its ``torch.autograd.grad`` and the
add into static gradient buffers, and ``render_loss_and_grad`` replays
the whole n-sample forward and backward.  On the CPU the same code runs
each unit eagerly, and that is what these tests drive
(``chip_smoke.py`` phases 13-14 hold the graphs to the eager loops on
the card).

(a) ``_accum_fwd_chunk``, ``_accum_fwd_chunk_record`` and
    ``_accum_bwd_chunk`` against the JAX package's functions of the same
    names on the same inputs: the grid-12 heightfield at 16x16, 5
    bounces, 2 samples (the Pallas kernel in interpret mode), a seed
    made with numpy from a fixed seed, and JAX's own record given to
    both backward programs.  Sample counts, RNG states and the recorded
    traces exactly equal; the beauty and normal passes within rtol 1e-4
    / atol 1e-5 on >= 99% of pixels (test_torch_integrator.py's rule: XLA
    contracts a*b+c into FMA, the port rounds every op); every gradient
    leaf within test_torch_grad.py's rtol 1e-4 / atol 1e-6 x the leaf's
    largest entry.
(b) ``render_loss_and_grad_accum`` for ``chunk`` = 1, 2 and n against
    the eager loops (``_accum_fwd``, ``_accum_bwd``) on the port's own
    heightfield, 4 samples: pass 1's state, records and loss exactly
    equal for every chunk.  The chunks' gradients are summed on the
    host, so chunk = 1 and chunk = n add the samples in the eager
    loop's order (exactly equal) and chunk = 2 in another (rtol 1e-5 /
    atol 1e-7 x the leaf's largest entry, test_torch_grad.py's tolerance
    for another order of the same sums).
(c) New parameter tensors on a second call (the albedo halved) take the
    same cache entries, and give the new values' result, equal to the
    eager computation on them: for the accumulator and for
    ``render_loss_and_grad``.
(d) The parameter buffers and programs of an IR are freed with it.
(e) The Disney lobes in a lane their gate discards keep the backward
    finite (``ops.disney.off_lanes_at_normal``) and the values as they
    were.
(f) There the port departs from the JAX package, whose gradient is NaN
    in that lane for seven leaves: the departure is pinned, and the kept
    lane agrees.
"""

import gc

import numpy as np
import jax
import pytest
import torch

from elevenrender_tpu.render import grad as jax_grad
from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu_torch.convert import params_from_numpy, params_to_numpy
from elevenrender_tpu_torch.render import dispatch
from elevenrender_tpu_torch.render import grad as tg
from elevenrender_tpu_torch.render import integrator as ti
from elevenrender_tpu_torch.scene import demo

from test_torch_integrator import _close_frac, _convert, _heightfield

N = 2


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def chunks():
    """Both packages' chunk programs on the same scene and inputs, as
    numpy: (JAX's results, the port's results)."""
    config, ir = _heightfield(False)
    params = {"materials": jax_grad.float_subtree(ir["materials"])}
    merged = jax_grad._merge(ir, params)
    npix = config.x_res * config.y_res
    seed = (np.random.default_rng(0).normal(size=(npix, 3)) * 1e-3).astype(
        np.float32)
    rng0 = np.asarray(jax_init_state(config)["rng"])
    want = {}
    want["record"] = _np(jax_grad._accum_fwd_chunk_record(
        config, merged, jax_init_state(config), N))
    want["fwd"] = _np(jax_grad._accum_fwd_chunk(
        config, merged, jax_init_state(config), N))
    want["bwd"] = _np(jax_grad._accum_bwd_chunk(
        config, ir, params, seed, rng0, N, want["record"][1]))

    cfg, tir = _convert(config, ir)
    tparams = params_from_numpy(_np(params), "cpu")
    tmerged = tg._merge(tir, tparams)
    got = {}
    state, rec = tg._accum_fwd_chunk_record(
        cfg, tmerged, ti.init_state(cfg, device="cpu"), N, device="cpu")
    got["record"] = ({k: v.numpy().copy() for k, v in state.items()},
                     {k: v.numpy() for k, v in rec.items()})
    state = tg._accum_fwd_chunk(cfg, tmerged, ti.init_state(cfg, device="cpu"),
                                N, device="cpu")
    got["fwd"] = {k: v.numpy().copy() for k, v in state.items()}
    caches = {k: torch.tensor(v) for k, v in want["record"][1].items()}
    grads, rng = tg._accum_bwd_chunk(
        cfg, tir, tparams, torch.tensor(seed),
        torch.tensor(rng0.astype(np.int64)), N, caches, device="cpu")
    got["bwd"] = (params_to_numpy(grads), rng.numpy().copy())
    return want, got


def _assert_state_close(got, want):
    np.testing.assert_array_equal(got["samples"], want["samples"])
    np.testing.assert_array_equal(got["rng"], want["rng"].astype(np.int64))
    for pid in (ti.BEAUTY, ti.NORMAL):
        a, b = got["passes"][pid, :, :3], want["passes"][pid, :, :3]
        assert _close_frac(a, b) >= 0.99, pid
    assert got["passes"][ti.BEAUTY, :, :3].mean() > 0.05


def test_accum_fwd_chunk_matches_jax(chunks):
    want, got = chunks
    _assert_state_close(got["fwd"], want["fwd"])
    assert int(got["fwd"]["samples"].min()) == N


def test_accum_fwd_chunk_record_matches_jax(chunks):
    want, got = chunks
    (state, rec), (want_state, want_rec) = got["record"], want["record"]
    _assert_state_close(state, want_state)
    for k, v in state.items():
        np.testing.assert_array_equal(v, got["fwd"][k], err_msg=k)
    assert rec.keys() == want_rec.keys() == {"hit", "occ"}
    for k in want_rec:
        assert rec[k].shape == want_rec[k].shape == (N, 5, 256), k
        np.testing.assert_array_equal(rec[k], want_rec[k], err_msg=k)
    assert (rec["hit"] >= 0).any() and rec["occ"].any()


def test_accum_bwd_chunk_matches_jax(chunks):
    want, got = chunks
    (grads, rng), (want_grads, want_rng) = got["bwd"], want["bwd"]
    np.testing.assert_array_equal(rng, want_rng.astype(np.int64))
    assert grads.keys() == want_grads.keys() == {"materials"}
    assert grads["materials"].keys() == want_grads["materials"].keys()
    for k, b in want_grads["materials"].items():
        a = grads["materials"][k]
        assert np.isfinite(a).all(), k
        np.testing.assert_allclose(a, b, rtol=1e-4,
                                   atol=1e-6 * max(np.abs(b).max(), 1e-30),
                                   err_msg=k)
    assert np.abs(grads["materials"]["albedo"]).sum() > 0


def _scene():
    """The port's own grid-12 heightfield at 16x16, 5 bounces, its target
    and material parameters."""
    _, cfg, ir = demo.heightfield_scene(grid=12, res=16, compat=False,
                                        device="cpu")
    cfg = cfg.replace(max_bounces=5)
    with torch.no_grad():
        st = ti.render_sample(cfg, ir, ti.init_state(cfg, device="cpu"),
                              device="cpu")
    target = st["passes"][ti.BEAUTY, :, :3] * 1.5 + 0.1
    return cfg, ir, target, {"materials": tg.float_subtree(ir["materials"])}


def _eager(cfg, ir, params, target, n):
    cpu = torch.device("cpu")
    loss, seed, caches, state = tg._accum_fwd(cfg, ir, params, target, n,
                                              True, cpu)
    grads, _ = tg._accum_bwd(cfg, ir, params, seed, caches, n, cpu)
    return loss, caches, state, grads


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tg._leaves(a),
                                                 tg._leaves(b)))


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_chunk_changes_nothing_but_the_order_of_the_sums(chunk):
    n = 4
    cfg, ir, target, params = _scene()
    loss, caches, state, grads = _eager(cfg, ir, params, target, n)
    buffers = tg.static_params(ir, params, "cpu")
    got_loss, _, got_caches, got_state = tg._accum_fwd_chunked(
        cfg, tg._merge(ir, buffers), target, n, chunk, True,
        torch.device("cpu"))
    assert len(got_caches) == -(-n // chunk)
    for k in ("hit", "occ"):
        assert torch.equal(torch.cat([c[k] for c in got_caches]),
                           torch.stack([c[k] for c in caches])), k
    for k, v in state.items():
        assert torch.equal(got_state[k], v), k
    got_loss, got = tg.render_loss_and_grad_accum(cfg, ir, params, target, n,
                                                  chunk=chunk, device="cpu")
    assert float(got_loss) == float(loss)
    if chunk in (1, n):
        assert _leaves_equal(got, grads)
    for a, b in zip(tg._leaves(got), tg._leaves(grads)):
        scale = max(float(b.abs().max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7 * scale)
    assert float(got["materials"]["albedo"].abs().sum()) > 0


def _entries(ir):
    return list(dispatch._graphs.get(ir["tris"]["verts"], {}).values())


def _halved(params):
    mats = params["materials"]
    return {"materials": {k: (v * 0.5 if k == "albedo" else v.clone())
                          for k, v in mats.items()}}


def test_new_parameter_tensors_take_the_same_entries():
    n = 2
    cfg, ir, target, params = _scene()
    first = tg.render_loss_and_grad_accum(cfg, ir, params, target, n,
                                          device="cpu")
    entries = _entries(ir)
    # The parameter buffers, the recording sample and the VJP program.
    assert len(entries) == 3
    again = _halved(params)
    loss, grads = tg.render_loss_and_grad_accum(cfg, ir, again, target, n,
                                                device="cpu")
    assert _entries(ir) == entries
    want_loss, _, _, want = _eager(cfg, ir, again, target, n)
    assert float(loss) == float(want_loss) != float(first[0])
    assert _leaves_equal(grads, want)
    assert not torch.equal(grads["materials"]["albedo"],
                           first[1]["materials"]["albedo"])
    assert not any(p.requires_grad for p in tg._leaves(again))


def test_render_loss_and_grad_takes_new_parameter_values():
    cfg, ir, target, params = _scene()
    tg.render_loss_and_grad(cfg, ir, params, target, 2, device="cpu")
    entries = _entries(ir)
    assert len(entries) == 2  # the parameter buffers and the program
    again = _halved(params)
    loss, grads = tg.render_loss_and_grad(cfg, ir, again, target, 2,
                                          device="cpu")
    assert _entries(ir) == entries
    tree, flat = tg._as_parameters(again)
    with torch.enable_grad():
        want_loss = tg.loss_fn(cfg, ir, tree, target, 2, device="cpu")
        want = torch.autograd.grad(want_loss, flat, allow_unused=True)
    assert float(loss) == float(want_loss.detach())
    for a, b, p in zip(tg._leaves(grads), want, flat):
        assert torch.equal(a, torch.zeros_like(p) if b is None else b)


def test_the_programs_are_freed_with_their_ir():
    cfg, ir, target, params = _scene()
    n_before = len(dispatch._graphs)
    tg.render_loss_and_grad_accum(cfg, ir, params, target, 2, device="cpu")
    tg.render_loss_and_grad_accum(cfg, ir, params, target, 2,
                                  cache_traces=False, device="cpu")
    tg.render_loss_and_grad(cfg, ir, params, target, 1, device="cpu")
    # Buffers; recording and plain samples; replaying and re-tracing
    # VJP programs; the loss-and-gradient program.
    assert len(_entries(ir)) == 6
    assert len(dispatch._graphs) == n_before + 1
    del ir, params
    gc.collect()
    assert len(dispatch._graphs) == n_before


def test_a_discarded_lane_keeps_the_lobes_backward_finite():
    """``disney_eval`` and ``disney_pdf`` in a lane their gate discards,
    at l = -v (h vanishes, a lobe is infinite), beside a kept lane: the
    values as without autograd (0 and 1 in the discarded lane) and
    finite gradients, where the discarded lane's 0 cotangent times the
    infinite lobe made them NaN (a 64-sample gradient at 1024x1024 met
    such lanes)."""
    from elevenrender_tpu_torch.ops import disney
    n = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    v = torch.tensor([[0.0, 0.6, 0.8]] * 2)
    l = torch.stack([-v[0], torch.tensor([0.0, -0.6, 0.8])])
    params = {k: torch.full((2,), x, requires_grad=True) for k, x in (
        ("roughness", 0.4), ("metallic", 0.2), ("specular", 0.5),
        ("specularTint", 0.1), ("sheenTint", 0.3), ("subsurface", 0.2),
        ("anisotropic", 0.3), ("sheen", 0.1), ("clearcoatGloss", 0.5),
        ("clearcoat", 0.2))}
    params["albedo"] = torch.tensor([[0.5, 0.4, 0.3]] * 2, requires_grad=True)
    hd = {**params, "transmission": torch.zeros(2),
          "tangent": torch.tensor([[1.0, 0.0, 0.0]] * 2),
          "bitangent": torch.tensor([[0.0, 1.0, 0.0]] * 2)}
    with torch.no_grad():
        want = (disney.disney_eval(hd, v, n, l), disney.disney_pdf(hd, v, n, l))
    f = disney.disney_eval(hd, v, n, l)
    pdf = disney.disney_pdf(hd, v, n, l)
    assert torch.equal(f, want[0]) and torch.equal(pdf, want[1])
    assert torch.equal(want[0][0], torch.zeros(3)) and float(want[1][0]) == 1
    assert float(want[0][1].sum()) > 0 and float(want[1][1]) > 0
    got = torch.autograd.grad(f.sum() + pdf.sum(), list(params.values()))
    for k, g in zip(params, got):
        assert bool(torch.isfinite(g).all()), k
    assert float(got[0].abs().sum()) > 0


# The leaves whose gradient the JAX package leaves NaN in the discarded
# lane of ``test_a_discarded_lane_departs_from_the_reference``'s inputs.
NAN_IN_THE_REFERENCE = ("albedo", "anisotropic", "clearcoat", "metallic",
                        "roughness", "specular", "specularTint")


def test_a_discarded_lane_departs_from_the_reference():
    """The departure of (e) from the reference, pinned: on the same
    inputs (a discarded lane at l = -v beside a kept lane), the JAX
    package's gradient of ``disney_eval(...).sum() +
    disney_pdf(...).sum()`` is NaN in the discarded lane for exactly
    ``NAN_IN_THE_REFERENCE`` (0 x an infinite lobe), the port's is finite
    there for every leaf, and in the kept lane the two agree within
    test_torch_grad.py's rtol 1e-4 / atol 1e-6 (XLA contracts a*b+c into
    FMA, the port rounds every op)."""
    import jax.numpy as jnp
    from elevenrender_tpu.ops import disney as jax_disney
    from elevenrender_tpu_torch.ops import disney

    n = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
    v = np.array([[0.0, 0.6, 0.8]] * 2, np.float32)
    l = np.stack([-v[0], np.array([0.0, -0.6, 0.8], np.float32)])
    params = {k: np.full((2,), x, np.float32) for k, x in (
        ("roughness", 0.4), ("metallic", 0.2), ("specular", 0.5),
        ("specularTint", 0.1), ("sheenTint", 0.3), ("subsurface", 0.2),
        ("anisotropic", 0.3), ("sheen", 0.1), ("clearcoatGloss", 0.5),
        ("clearcoat", 0.2))}
    params["albedo"] = np.array([[0.5, 0.4, 0.3]] * 2, np.float32)
    fixed = {"transmission": np.zeros(2, np.float32),
             "tangent": np.array([[1.0, 0.0, 0.0]] * 2, np.float32),
             "bitangent": np.array([[0.0, 1.0, 0.0]] * 2, np.float32)}

    def jax_objective(p):
        hd = {**p, **{k: jnp.asarray(x) for k, x in fixed.items()}}
        return (jax_disney.disney_eval(hd, v, n, l).sum()
                + jax_disney.disney_pdf(hd, v, n, l).sum())

    want = _np(jax.grad(jax_objective)(
        {k: jnp.asarray(x) for k, x in params.items()}))
    leaves = {k: torch.tensor(x, requires_grad=True)
              for k, x in params.items()}
    hd = {**leaves, **{k: torch.tensor(x) for k, x in fixed.items()}}
    tv, tn, tl = map(torch.tensor, (v, n, l))
    got = torch.autograd.grad(disney.disney_eval(hd, tv, tn, tl).sum()
                              + disney.disney_pdf(hd, tv, tn, tl).sum(),
                              list(leaves.values()))
    got = {k: g.numpy() for k, g in zip(leaves, got)}
    nan = sorted(k for k, g in want.items() if np.isnan(g[0]).any())
    assert nan == sorted(NAN_IN_THE_REFERENCE)
    for k in params:
        assert np.isfinite(got[k]).all(), k
        assert np.isfinite(want[k][1]).all(), k
        np.testing.assert_allclose(got[k][1], want[k][1], rtol=1e-4,
                                   atol=1e-6, err_msg=k)
