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
come back as the same tree.  Inside, the leaves become fresh leaf
tensors that require grad and ``torch.autograd.grad`` does the rest; the
caller's tensors are not touched.  Typical use::

    params = {"materials": float_subtree(ir["materials"])}
    loss, grads = render_loss_and_grad_accum(config, ir, params, target,
                                             n_samples)
"""

from __future__ import annotations

import torch

from ..core.device import resolve_device
from .integrator import (BEAUTY, init_state, render_sample,
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
                         device="cuda"):
    """(loss, gradients as a tree like ``params``) by autograd straight
    through all n samples: the graph of every sample is alive at once."""
    tree, flat = _as_parameters(params)
    with torch.enable_grad():
        loss = loss_fn(config, ir, tree, target, n_samples, device)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(flat, grads)]
    return loss.detach(), _rebuild(params, iter(grads))


def fwd_bwd_step(config, ir, target, n_samples: int = 1, device="cuda"):
    """One forward and backward pass, gradients with respect to the whole
    material table."""
    params = {"materials": float_subtree(ir["materials"])}
    return render_loss_and_grad(config, ir, params, target, n_samples,
                                device)


def _accum_fwd(config, ir, params, target, n_samples: int,
               cache_traces: bool, dev):
    """Pass 1 of the accumulator: n forward-only samples.  Returns (loss,
    seed [H*W, 3]: dL/dimg folded with the progressive average's
    1/count, the recorded traces, one per sample, or [])."""
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
        img = state["passes"][BEAUTY, :, :3]
        count = torch.clamp(state["samples"].to(torch.float32), min=1.0)
        loss = torch.mean((img - target) ** 2)
        seed = (2.0 * (img - target) / img.numel()) / count[:, None]
    return loss, seed, caches


def _accum_bwd(config, ir, params, seed, caches, n_samples: int, dev):
    """Pass 2 of the accumulator: each sample again from pass 1's RNG
    stream (replayed from ``caches[s]``, or traced again when ``caches``
    is empty), one vector-Jacobian product at a time, summed into
    gradients shaped like ``params``."""
    tree, flat = _as_parameters(params)
    grads = [torch.zeros_like(p) for p in flat]
    rng = init_state(config, dev)["rng"]
    merged = _merge(ir, tree)
    for s in range(n_samples):
        with torch.enable_grad():
            out, rng = sample_radiance(
                config, merged, rng, seed.shape[0],
                trace_cache=caches[s] if caches else None)
            got = torch.autograd.grad(
                out["light"], flat, grad_outputs=seed * out["ok"][:, None],
                allow_unused=True)
        for acc, g in zip(grads, got):
            if g is not None:
                acc.add_(g)
    return _rebuild(params, iter(grads))


def render_loss_and_grad_accum(config, ir, params, target, n_samples: int,
                               chunk: int | None = None,
                               cache_traces: bool = True, device="cuda"):
    """The n-sample gradient in the memory of one sample's backward pass:
    the two-pass estimator.

    The Monte-Carlo mean is linear.  With per-pixel counts c and valid
    masks ok_s (the NaN guard):

        img = sum_s ok_s * light_s / c,   L = mean((img - target)^2)
        dL/dtheta = sum_s VJP(light_s)[ dL/dimg * ok_s / c ]

    Pass 1 renders forward only, under ``torch.no_grad()``, for img and
    c.  Pass 2 replays each sample from the same RNG stream and adds one
    sample's vector-Jacobian product at a time into preallocated
    gradients.

    ``cache_traces`` (default on): pass 1 records each sample's hit ids
    and occlusion bits (5 bytes per pixel per bounce, 6 with point
    lights) and pass 2 replays them, so it launches no traversal and
    sorts no rays.  Exact: those results are constants of the estimator
    either way.  Turn it off when device memory is too tight for the
    record; pass 2 then traces every sample again.

    ``chunk`` is ignored.  In the JAX package it is the number of samples
    per jitted dispatch; an eager program has no dispatch to bound, and
    the argument is kept only so both packages take the same call.

    Native mode only: compat's average starts its count at 1 and dims on
    purpose, and gradients aim at the unbiased native estimate."""
    if config.compat:
        raise ValueError("accumulated gradients are native-mode only")
    dev = resolve_device(device)
    loss, seed, caches = _accum_fwd(config, ir, params, target, n_samples,
                                    cache_traces, dev)
    return loss, _accum_bwd(config, ir, params, seed, caches, n_samples, dev)


def fwd_bwd_step_accum(config, ir, target, n_samples: int,
                       chunk: int | None = None, device="cuda"):
    """The headline unit: an n-sample render and its n-sample accumulated
    backward pass in flat memory, gradients with respect to the whole
    material table."""
    params = {"materials": float_subtree(ir["materials"])}
    return render_loss_and_grad_accum(config, ir, params, target, n_samples,
                                      chunk=chunk, device=device)
