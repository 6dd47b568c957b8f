"""Differentiable rendering: pixel gradients w.r.t. scene parameters.

Port of ``elevenrender_tpu/render/grad.py``: reverse-mode gradients of an
image loss with respect to material parameters, HDRI radiance, light
radiance and camera parameters, by the detached-sampling estimator.
Discrete decisions (BVH hit ids, texel and lobe choices, sampled
directions, the RNG stream) are constants of the backward pass; the
radiance estimators stay differentiable through the Disney BRDF, the
texture fetches and the environment lookups.

``params`` is a sub-tree of the IR, a dict of dicts of float tensors
such as ``{"materials": float_subtree(ir["materials"])}``; gradients
come back as the same tree.  The caller's tensors are not touched.
Typical use::

    params = {"materials": float_subtree(ir["materials"])}
    loss, grads = render_loss_and_grad_accum(config, ir, params, target,
                                             n_samples)

The compiled programs.  The JAX package jits ``render_loss_and_grad``
and three chunk programs of the accumulator (``_accum_fwd_chunk``,
``_accum_fwd_chunk_record``, ``_accum_bwd_chunk``) and drives the
chunks from a host loop.  Here each is a CUDA graph on a card
(``render/dispatch.py``'s ``CountedCall``: an eager warm-up, one
capture, then replays), under the same names and return values:

- pass 1 is ``SampleGraph`` replays, one a sample, ``record=True``
  copying each sample's trace record out of the graph's buffers;
- pass 2 is one graph of one sample's forward (replaying the record, or
  tracing again without one), its ``torch.autograd.grad`` and the add
  into static gradient buffers, replayed once a sample;
- ``render_loss_and_grad`` is one graph of the whole n-sample forward
  and its backward, one per n.

The parameters are static buffers that take new values on every call
(``static_params``): an inverse-rendering loop makes new parameter
tensors every step, and a capture keyed on their identities would be
made anew each step.  Both passes read the parameters through those
buffers, which are leaf tensors that require grad.  They and every
graph are cached per IR like the compiled sample (``dispatch.cached``:
the IR's other tensors, the parameters' tree, shapes and dtypes, the
pixel count, the device and the shader registry version) and freed with
it.  On the CPU the same code runs each unit eagerly.  ``_accum_fwd``
and ``_accum_bwd`` are the eager loops of the two passes: the reference
that the graphs are held to on the card.

Spans (``core/spans.py``) of ``render_loss_and_grad_accum``:
``grad.pass1`` (the chunks of pass 1), ``grad.loss`` (the loss and the
seed between the passes) and ``grad.pass2``; the integrator's spans of
the graphs' samples nest in the first and the last.
"""

from __future__ import annotations

import torch

from ..core import spans
from . import dispatch
from .integrator import (BEAUTY, init_state,
                         recommended_samples_per_dispatch, render_sample,
                         sample_radiance)


def float_subtree(tree: dict) -> dict:
    """Keep only the floating-point leaves: int tables such as texture
    ids are structure, not parameters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = float_subtree(v)
            if sub:
                out[k] = sub
        elif torch.as_tensor(v).is_floating_point():
            out[k] = v
    return out


def _merge(ir: dict, params: dict) -> dict:
    out = dict(ir)
    for k, v in params.items():
        if isinstance(v, dict) and isinstance(ir.get(k), dict):
            out[k] = {**ir[k], **v}
        else:
            out[k] = v
    return out


def _leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _paths(tree: dict, prefix=()) -> list:
    """The leaves' paths, in ``_leaves`` order."""
    out = []
    for k, v in tree.items():
        out.extend(_paths(v, prefix + (k,)) if isinstance(v, dict)
                   else [prefix + (k,)])
    return out


def _rebuild(tree: dict, leaves) -> dict:
    """``tree`` with its leaves replaced, in ``_leaves`` order, from the
    iterator ``leaves``."""
    return {k: (_rebuild(v, leaves) if isinstance(v, dict) else next(leaves))
            for k, v in tree.items()}


def _as_parameters(params: dict):
    """(the tree with every leaf a fresh tensor that requires grad, those
    leaves as a list)."""
    flat = [leaf.detach().clone().requires_grad_() for leaf in _leaves(params)]
    return _rebuild(params, iter(flat)), flat


def static_params(ir: dict, params: dict, device="cuda") -> dict:
    """The parameter buffers of ``ir`` for a tree like ``params``: leaf
    tensors that require grad, cached per IR (its other tensors), the
    tree's paths, shapes and dtypes and the device, with ``params``'
    values copied in (a leaf that is already the buffer is not copied).
    Every graph of the gradient path reads the parameters through them,
    so new parameter tensors replay the graphs already captured."""
    dev = dispatch.graph_device(device)
    paths = _paths(params)
    if ("tris", "verts") in paths:
        raise ValueError("ir['tris']['verts'] keys the IR's captures and "
                         "cannot be a gradient parameter")
    flat = _leaves(params)
    rest = {grp: {k: v for k, v in leaves.items() if (grp, k) not in paths}
            for grp, leaves in ir.items()}
    sig = tuple((p, tuple(t.shape), t.dtype) for p, t in zip(paths, flat))
    # The entry keeps the IR's other tensors alive with the buffers, so
    # their identities in the key are not reused while it lives.
    _, buffers = dispatch.cached(rest, ("params", sig, dev), lambda held: (
        held, _rebuild(params, iter([
            torch.empty(t.shape, dtype=t.dtype, device=dev).requires_grad_()
            for t in flat]))))
    with torch.no_grad():
        for buf, v in zip(_leaves(buffers), flat):
            if v is not buf:
                buf.copy_(v)
    return buffers


def render_beauty(config, ir, n_samples: int, state=None, device="cuda",
                  pixel_offset=0):
    """Render n samples and return (the beauty pass [npix, 3], the state):
    the linear mean estimate of native accumulation.  ``state`` (default:
    the whole image's) may be one shard's slice of the image, whose
    first pixel is ``pixel_offset``."""
    if state is None:
        state = init_state(config, device)
    for _ in range(n_samples):
        state = render_sample(config, ir, state, pixel_offset=pixel_offset,
                              device=device)
    return state["passes"][BEAUTY, :, :3], state


def loss_fn(config, ir, params, target, n_samples: int, device="cuda",
            state=None, pixel_offset=0, n_total=None):
    """MSE between the rendered beauty pass and ``target`` [npix, 3].

    On a shard (``state`` the slice of the image from ``pixel_offset``,
    ``target`` the same slice): the slice's squared error summed and
    divided by 3 x ``n_total`` pixels, so the shards' losses sum to the
    whole image's MSE."""
    img, _ = render_beauty(config, _merge(ir, params), n_samples, state,
                           device, pixel_offset)
    if n_total is None:
        return torch.mean((img - target) ** 2)
    return torch.sum((img - target) ** 2) / (n_total * 3)


def render_loss_and_grad(config, ir, params, target, n_samples: int,
                         device="cuda", state=None, pixel_offset=0,
                         n_total=None):
    """(loss, gradients as a tree like ``params``) of ``loss_fn``, by
    autograd straight through all n samples, as one captured graph per n
    (and per shard: ``state``, ``pixel_offset`` and ``n_total`` as
    ``loss_fn`` takes them).  The graph of every sample is alive at
    once, so its memory grows with n.  Returns copies that no later call
    writes."""
    dev = dispatch.graph_device(device)
    buffers = static_params(ir, params, dev)
    flat = _leaves(buffers)
    call = dispatch.cached(
        _merge(ir, buffers),
        ("loss_and_grad", config, n_samples, target.shape[0], pixel_offset,
         n_total, state is not None, dev),
        lambda held: dispatch.CountedCall(dev, held, "loss_and_grad"))
    inputs = {"target": target}
    if state is not None:
        inputs.update({f"state.{k}": v for k, v in state.items()})

    def step(st):
        start = (None if state is None else
                 {k[6:]: v for k, v in st.items() if k.startswith("state.")})
        with torch.enable_grad():
            loss = loss_fn(config, ir, buffers, st["target"], n_samples, dev,
                           start, pixel_offset, n_total)
            got = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, got)]

    with call.turn():
        call.load(inputs)
        loss, grads = call.run(step)
        return loss.clone(), _rebuild(params, (g.clone() for g in grads))


def fwd_bwd_step(config, ir, target, n_samples: int = 1, device="cuda"):
    """One forward and backward pass, gradients with respect to the whole
    material table."""
    params = {"materials": float_subtree(ir["materials"])}
    return render_loss_and_grad(config, ir, params, target, n_samples,
                                device)


def _loss_and_seed(state, target):
    """(loss, seed [H*W, 3]: dL/dimg folded with the progressive
    average's 1/count) from pass 1's state."""
    img = state["passes"][BEAUTY, :, :3]
    count = torch.clamp(state["samples"].to(torch.float32), min=1.0)
    loss = torch.mean((img - target) ** 2)
    seed = (2.0 * (img - target) / img.numel()) / count[:, None]
    return loss, seed


def _vjp_sample(config, merged, flat, rng, seed, trace_cache=None):
    """Pass 2's unit: one sample again from ``rng`` (replaying
    ``trace_cache``, or tracing again without it) and its vector-Jacobian
    product against ``seed * ok``.  Returns (the gradients of ``flat``,
    None where unused; the next RNG state)."""
    with torch.enable_grad():
        out, rng = sample_radiance(config, merged, rng, seed.shape[0],
                                   trace_cache=trace_cache)
        got = torch.autograd.grad(
            out["light"], flat, grad_outputs=seed * out["ok"][:, None],
            allow_unused=True)
    return got, rng


def _accum_fwd(config, ir, params, target, n_samples: int,
               cache_traces: bool, dev):
    """Pass 1 of the accumulator, eagerly: n forward-only samples.
    Returns (loss, seed, the recorded traces, one per sample, or [], the
    final state)."""
    caches = []
    with torch.no_grad():
        merged = _merge(ir, params)
        state = init_state(config, dev)
        for _ in range(n_samples):
            if cache_traces:
                state, trace = render_sample(config, merged, state,
                                             record=True, device=dev)
                caches.append(trace)
            else:
                state = render_sample(config, merged, state, device=dev)
        loss, seed = _loss_and_seed(state, target)
    return loss, seed, caches, state


def _accum_bwd(config, ir, params, seed, caches, n_samples: int, dev):
    """Pass 2 of the accumulator, eagerly: each sample again from pass
    1's RNG stream (replayed from ``caches[s]``, or traced again when
    ``caches`` is empty), one vector-Jacobian product at a time, summed
    into gradients shaped like ``params``.  Returns (gradients, the
    final RNG state)."""
    tree, flat = _as_parameters(params)
    grads = [torch.zeros_like(p) for p in flat]
    rng = init_state(config, dev)["rng"]
    merged = _merge(ir, tree)
    for s in range(n_samples):
        got, rng = _vjp_sample(config, merged, flat, rng, seed,
                               caches[s] if caches else None)
        for acc, g in zip(grads, got):
            if g is not None:
                acc.add_(g)
    return _rebuild(params, iter(grads)), rng


def _accum_fwd_chunk(config, merged_ir, state, n: int, device="cuda"):
    """n forward samples, n replays of the captured sample (pass 1's
    unit without the record).  Returns the graph's state buffers
    ("donated": the next call for the same key overwrites them)."""
    return dispatch.render_samples_jit(config, merged_ir, state, n,
                                       device=device)


def _accum_fwd_chunk_record(config, merged_ir, state, n: int,
                            device="cuda"):
    """n forward samples by replay, recording each sample's discrete
    trace results (hit ids, occlusion bits) for pass 2 to replay.
    Returns (the graph's state buffers, "donated"; the records stacked
    [n, ...])."""
    graph = dispatch.sample_graph(config, merged_ir,
                                  state["samples"].shape[0], 0, device,
                                  record=True)
    return graph.run(merged_ir, state, n)


class _VjpCall(dispatch.CountedCall):
    """Pass 2's graph: static ``seed``, ``rng`` and (replaying) the trace
    record ``cache.*``; ``grads``, one buffer per parameter leaf, which
    every run adds its sample's gradients into."""

    def __init__(self, device, held, flat):
        super().__init__(device, held, "vjp")
        self.grads = [torch.zeros_like(p) for p in flat]


def _accum_bwd_chunk(config, ir, params, seed, rng, n: int, caches=None,
                     device="cuda"):
    """n per-sample vector-Jacobian products, n replays of one captured
    sample (pass 2's unit).  ``caches``: pass 1's records stacked [n,
    ...], the i-th copied into the graph's record buffers before replay
    i; without them the graph traces each sample again.  Returns (the
    chunk's gradients as a tree like ``params``, the RNG state after it),
    both the graph's buffers ("donated": the next call for the same key
    overwrites them)."""
    dev = dispatch.graph_device(device)
    buffers = static_params(ir, params, dev)
    merged = _merge(ir, buffers)
    flat = _leaves(buffers)
    call = dispatch.cached(
        merged, ("vjp", config, seed.shape[0],
                 None if caches is None else tuple(sorted(caches)), dev),
        lambda held: _VjpCall(dev, held, flat))

    def sample(st):
        cache = (None if caches is None else
                 {k[6:]: v for k, v in st.items() if k.startswith("cache.")})
        got, rng2 = _vjp_sample(config, merged, flat, st["rng"], st["seed"],
                                cache)
        for acc, g in zip(call.grads, got):
            if g is not None:
                acc.add_(g)
        st["rng"].copy_(rng2)

    with call.turn():
        for g in call.grads:
            g.zero_()
        for i in range(n):
            inputs = ({"seed": seed, "rng": rng} if i == 0 else
                      {k: call.static[k] for k in ("seed", "rng")})
            if caches is not None:
                inputs.update({f"cache.{k}": v[i] for k, v in caches.items()})
            call.load(inputs)
            call.run(sample)
        return _rebuild(params, iter(call.grads)), call.static["rng"]


def _chunks(n_samples: int, chunk: int):
    done = 0
    while done < n_samples:
        n = min(chunk, n_samples - done)
        yield n
        done += n


def _accum_fwd_chunked(config, merged, target, n_samples: int, chunk: int,
                       cache_traces: bool, dev):
    """Pass 1 by chunk programs.  Returns (loss, seed, the records, one
    stack [n, ...] per chunk, or [], the final state: the graph's
    buffers)."""
    caches = []
    with spans.span("grad.pass1", dev):
        state = init_state(config, dev)
        for n in _chunks(n_samples, chunk):
            if cache_traces:
                state, cache = _accum_fwd_chunk_record(config, merged, state,
                                                       n, dev)
                caches.append(cache)
            else:
                state = _accum_fwd_chunk(config, merged, state, n, dev)
    with torch.no_grad(), spans.span("grad.loss", dev):
        loss, seed = _loss_and_seed(state, target)
    return loss, seed, caches, state


def _accum_bwd_chunked(config, ir, params, seed, caches, n_samples: int,
                       chunk: int, dev):
    """Pass 2 by chunk programs, each chunk's gradients added on the
    host's loop.  Returns (gradients like ``params``, the final RNG
    state)."""
    rng = init_state(config, dev)["rng"]
    total = None
    for i, n in enumerate(_chunks(n_samples, chunk)):
        got, rng = _accum_bwd_chunk(config, ir, params, seed, rng, n,
                                    caches[i] if caches else None, dev)
        got = _leaves(got)
        total = ([g.clone() for g in got] if total is None
                 else [t.add_(g) for t, g in zip(total, got)])
    if total is None:
        total = [torch.zeros_like(p) for p in _leaves(params)]
    return _rebuild(params, iter(total)), rng


def render_loss_and_grad_accum(config, ir, params, target, n_samples: int,
                               chunk: int | None = None,
                               cache_traces: bool = True, device="cuda"):
    """The n-sample gradient in the memory of one sample's backward pass:
    the two-pass estimator.

    The Monte-Carlo mean is linear.  With per-pixel counts c and valid
    masks ok_s (the NaN guard):

        img = sum_s ok_s * light_s / c,   L = mean((img - target)^2)
        dL/dtheta = sum_s VJP(light_s)[ dL/dimg * ok_s / c ]

    Pass 1 renders forward only for img and c.  Pass 2 replays each
    sample from the same RNG stream and adds one sample's
    vector-Jacobian product at a time into preallocated gradients.

    ``cache_traces`` (default on): pass 1 records each sample's hit ids
    and occlusion bits (5 bytes per pixel per bounce, 6 with point
    lights) and pass 2 replays them, so it launches no traversal and
    sorts no rays.  Exact: those results are constants of the estimator
    either way.  Turn it off when device memory is too tight for the
    record; pass 2 then traces every sample again.

    ``chunk``: samples per call of a chunk program, as in the JAX
    package (default ``recommended_samples_per_dispatch``).  A chunk of
    n is n replays of one captured sample, so the result does not depend
    on it but for the order of the gradient sums across chunks; the loss
    and pass 1 are exactly the same.  Loss and seed are computed eagerly
    between the passes.

    Native mode only: compat's average starts its count at 1 and dims on
    purpose, and gradients aim at the unbiased native estimate."""
    if config.compat:
        raise ValueError("accumulated gradients are native-mode only")
    dev = dispatch.graph_device(device)
    if chunk is None:
        chunk = recommended_samples_per_dispatch(config, ir)
    if chunk < 1:
        raise ValueError(f"chunk {chunk}: expected >= 1")
    buffers = static_params(ir, params, dev)
    loss, seed, caches, _ = _accum_fwd_chunked(
        config, _merge(ir, buffers), target, n_samples, chunk, cache_traces,
        dev)
    with spans.span("grad.pass2", dev):
        grads, _ = _accum_bwd_chunked(config, ir, buffers, seed, caches,
                                      n_samples, chunk, dev)
    return loss, _rebuild(params, iter(_leaves(grads)))


def fwd_bwd_step_accum(config, ir, target, n_samples: int,
                       chunk: int | None = None, device="cuda"):
    """The headline unit: an n-sample render and its n-sample accumulated
    backward pass in flat memory, gradients with respect to the whole
    material table."""
    params = {"materials": float_subtree(ir["materials"])}
    return render_loss_and_grad_accum(config, ir, params, target, n_samples,
                                      chunk=chunk, device=device)
