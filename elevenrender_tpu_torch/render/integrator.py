"""The path-tracing integrator: one progressive sample over all pixels.

Port of ``elevenrender_tpu/render/integrator.py`` (``init_state``,
``_trace``, ``_generate_hitdata``, ``sample_radiance``,
``render_sample``).  The image is a flat wavefront of rays advanced in
lockstep; every branch of the reference megakernel is a lane mask.  Each
bounce: a closest-hit trace of the path rays, the hit attributes and
material row, Disney sample/eval/pdf, environment NEE with an any-hit
shadow trace (native) or a nearest-hit self-test (compat), and the MIS
accumulation.  Hit data comes from the material table or from the
texture atlas per map slot, with tangent-space normal mapping and the
programmable albedo shaders.  In native mode with point lights, each
bounce also picks one light per lane, and the environment and light
shadow rays go through one any-hit launch of 2N rays.

Both traversals of a bounce go through ``ops.traverse.traverse``: the
CUDA kernel on the card, its plain version on the CPU.  A sample makes no
host sync (no tensor built from host data, nothing read back), so on the
card ``render/dispatch.py`` captures it whole as a CUDA graph.  Rays are sorted
once per bounce by hit point and sampled direction (and the native
shadow rays by their own gate) so that neighbouring threads walk
neighbouring rays; the sort changes no result beyond equal-t ties.

The gradient path (``render/grad.py``) differentiates one sample's
radiance with the detached-sampling estimator: hit ids, texel and lobe
choices, sampled directions and the RNG stream are constants of the
backward pass.  ``record=True`` returns each bounce's discrete trace
results (hit ids, occlusion bits) and ``trace_cache=`` replays them, so
a replayed sample launches no traversal and sorts no rays.

Spans and counters (``core/spans.py``; they run where the sample's
Python runs: eagerly, at a warm-up and at a capture, and a replay
repeats the stamps the capture recorded).  ``sample`` is the whole of
``render_sample``: ``camera`` (the camera rays), one ``bounce`` a
bounce and ``accumulate`` (the pass update).  A bounce's children:
``traverse`` (the closest-hit trace), ``sort`` (the ray sorts and the
permutations of a trace; inside ``traverse`` and ``shadow`` where they
happen there), ``hitdata`` (the hit's attributes: ``hitdata.tri`` the
triangle rows and the hit, ``hitdata.material`` the material rows,
``hitdata.texture`` the texture taps) and ``shadow`` (the any-hit
trace and its rays).  Shading is the bounce's self time.  With tracing
on, each bounce counts ``lanes`` (its lanes, a host int),
``alive_lanes`` (its live path lanes) and ``shadow_lanes`` (its gated
shadow rays) on the device, the sums ``config.count_rays`` adds to
``ray_count``.  With ``remat_bounces`` the backward pass's recomputation
of a bounce records its spans and counters again.
"""

from __future__ import annotations

import functools
import logging
import os

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng as rng_mod
from ..core import spans
from ..core.device import constant, resolve_device
from ..core.vecmath import dot, normalize, where3
from ..ops import hdri as hdri_ops
from ..ops import traverse as traverse_ops
from ..ops.camera import camera_ray
from ..ops.disney import (disney_eval, disney_pdf, disney_sample,
                          off_lanes_at_normal)
from ..ops.intersect import full_hit, gather_tri
from ..ops.sort import sort_for_packets
from ..ops.texture import (reverse_spherical_mapping, sample_filtered,
                           sample_nearest, spherical_mapping)
from . import shaders as shader_registry

WIDE_TRACE_MODES = ("pallas_wide", "pallas_wide_stream")
BEAUTY, DENOISE, NORMAL, TANGENT, BITANGENT = range(5)
PASSES_COUNT = 5

_SCALAR_FIELDS = ("roughness", "metallic", "opacity", "transmission",
                  "clearcoat", "anisotropic", "eta", "specular",
                  "subsurface", "sheen", "clearcoat_gloss",
                  "specular_tint", "sheen_tint")


def init_state(config, device="cuda") -> dict:
    """Fresh accumulation state: passes (alpha 1), per-pixel sample
    counts (1 in compat mode, as the reference starts), RNG streams."""
    dev = resolve_device(device)
    npix = config.x_res * config.y_res
    passes = torch.zeros((PASSES_COUNT, npix, 4), device=dev)
    passes[:, :, 3] = 1.0
    state = {
        "passes": passes,
        "samples": torch.full((npix,), 1 if config.compat else 0,
                              dtype=torch.int64, device=dev),
        "rng": rng_mod.init_state(torch.arange(npix, device=dev)),
    }
    if config.count_rays:
        state["ray_count"] = torch.zeros((), device=dev)
    return state


@functools.lru_cache(maxsize=None)
def _warn_wide_mode(mode: str) -> None:
    """Once per process and mode: every trace of a render resolves it."""
    logging.getLogger(__name__).warning(
        "trace_mode=%r: the 8-wide walk is kept for measurement only "
        "(elevenrender_tpu_torch/experiments/bvh_wide.py); rendering with "
        "the binary traversal kernel", mode)


def resolve_trace_mode(config, ir) -> str:
    """"brute" for tiny scenes (<= 64 tris), ``use_bvh=False`` or
    ``trace_mode="brute"``; otherwise "bvh", the binary traversal kernel.
    The 8-wide walk is no render mode: ``trace_mode="pallas_wide"`` and
    ``"pallas_wide_stream"`` log a warning and take the binary kernel."""
    n_tris = ir["tris"]["verts"].shape[0]
    if not config.use_bvh:
        return "brute"
    if config.trace_mode in WIDE_TRACE_MODES:
        _warn_wide_mode(config.trace_mode)
        return "bvh"
    if (config.trace_mode == "brute"
            or (config.trace_mode == "auto" and n_tris <= 64)):
        return "brute"
    return "bvh"


def recommended_samples_per_dispatch(config, ir, default: int = 8) -> int:
    """Samples per chunk of a background render (``Renderer.start``
    takes the smaller of this and ``config.block_size``): the render
    thread publishes a snapshot after each chunk; and the gradient
    accumulator's default ``chunk``.

    The JAX package bounds this by scene scale, because one jitted
    dispatch there must stay inside its runtime's wall-time envelope.
    Here a chunk of n samples is n replays of one captured sample
    (``render/dispatch.py``, ``render/grad.py``), each its own launch,
    and the card has no per-launch watchdog, so no scene size forces a
    smaller chunk: the function keeps the two overrides and otherwise
    returns ``default``.
    ``config.samples_per_dispatch > 0`` wins over the default, and the
    ``ELEVENRT_SAMPLES_PER_DISPATCH`` environment variable wins over
    both."""
    env = os.environ.get("ELEVENRT_SAMPLES_PER_DISPATCH")
    if env:
        try:
            return max(int(env), 1)
        except ValueError:
            logging.getLogger(__name__).warning(
                "ELEVENRT_SAMPLES_PER_DISPATCH=%r is not an integer; "
                "ignoring the override", env)
    if config.samples_per_dispatch > 0:
        return config.samples_per_dispatch
    return default


def uses_sort(config, ir) -> bool:
    return config.sort_rays and resolve_trace_mode(config, ir) == "bvh"


@torch.no_grad()
def _sort(config, ir, origin, direction, mask):
    origin, direction = origin.detach(), direction.detach()
    return sort_for_packets(origin, direction, ir["bvh"]["node_bmin"][0],
                            ir["bvh"]["node_bmax"][0], mask=mask,
                            dir_major=config.sort_dir_major,
                            impl=config.sort_impl,
                            dir_bits=config.sort_dir_bits)


@torch.no_grad()
def _trace(config, ir, ray_o, ray_d, mask=None, perm=None, exclude=None,
           t_max=None, sort=True):
    """Nearest hit per ray (idx i64, -1 on a miss; t), or with
    ``exclude``/``t_max`` an occlusion query (idx >= 0 iff some tri other
    than exclude is hit closer than t_max).

    ``mask``: lanes that need a result; the others get a ray that misses
    the root's children at once.  ``perm``: a precomputed (order,
    inverse) pair; with ``sort`` and no ``perm`` the rays are sorted
    here.  Brute force emulates occlusion by nearest hit plus filter.
    ``config.trace_order`` and ``config.leaf_aabb`` choose the traversal
    kernel's variant.  No gradient flows through a trace: its results
    are constants of the estimator.  ``torch.no_grad`` stops only the
    reverse mode, so the rays are detached too: under forward-mode AD
    the kernel receives primal tensors and returns no tangent."""
    ray_o, ray_d = ray_o.detach(), ray_d.detach()
    if t_max is not None:
        t_max = t_max.detach()
    traverse_ops.check_variant(config.trace_order, config.leaf_aabb, "full")
    occl = exclude is not None
    if resolve_trace_mode(config, ir) == "brute":
        idx, t = traverse_ops.brute_force(ir["tris"]["verts"], ray_o, ray_d)
        if mask is not None:
            idx = torch.where(mask, idx, torch.full_like(idx, -1))
            t = torch.where(mask, t, torch.full_like(t, float("inf")))
        if occl:
            good = (idx >= 0) & (idx != exclude) & (t < t_max)
            idx = torch.where(good, idx, torch.full_like(idx, -1))
        return idx, t

    if mask is not None:
        far = ir["bvh"]["node_bmax"][0] + 1e7
        up = constant((0.0, 0.0, 1.0), ray_d.device)
        ray_o = where3(mask, ray_o, far.expand_as(ray_o))
        ray_d = where3(mask, ray_d, up.expand_as(ray_d))

    inverse = None
    if config.sort_rays and sort:
        with spans.span("sort", ray_d.device):
            if perm is not None:
                order, inverse = perm
            else:
                order, inverse = _sort(config, ir, ray_o, ray_d, mask)
            ray_o = ray_o[order]
            ray_d = ray_d[order]
            if occl:
                exclude = exclude[order]
                t_max = t_max[order]
    if occl:
        exclude = exclude.to(torch.int32).contiguous()
        t_max = t_max.contiguous()
    idx, t = traverse_ops.traverse(ir["kernel"], ray_o.contiguous(),
                                   ray_d.contiguous(), config.bvh_depth,
                                   exclude=exclude, t_max=t_max,
                                   order=config.trace_order,
                                   leaf_aabb=config.leaf_aabb)
    idx = idx.to(torch.int64)
    if inverse is not None:
        with spans.span("sort", ray_d.device):
            idx = idx[inverse]
            t = t[inverse]
    return idx, t


class _ClipBalanced(torch.autograd.Function):
    """``clamp(x, lo, hi)`` with the JAX package's gradient at the
    bounds: ``jnp.clip`` is ``minimum(maximum(x, lo), hi)``, and each of
    the two splits the cotangent evenly on a tie, where ``torch.clamp``
    passes all of it.  A pixel whose radiance is exactly 0 (every term
    masked or occluded) is such a tie, and its emission gradient would
    otherwise be twice the reference's."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def _scale(ctx, t):
        """``t * up * down``: the factor of each of the two halves, 1
        inside, 1/2 at a tie, 0 outside, as ``lax.max`` and ``lax.min``
        differentiate in either mode."""
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        up = (x > lo).to(t.dtype) + 0.5 * (x == lo).to(t.dtype)
        y = torch.clamp(x, min=lo)
        down = (y < hi).to(t.dtype) + 0.5 * (y == hi).to(t.dtype)
        return t * up * down

    @staticmethod
    def backward(ctx, ct):
        return _ClipBalanced._scale(ctx, ct), None, None

    @staticmethod
    def jvp(ctx, t, _lo, _hi):
        return _ClipBalanced._scale(ctx, t)


class _GatherRowsMmBwd(torch.autograd.Function):
    """``table[m]`` whose backward is a one-hot matrix product,
    ``onehot(m).T @ ct`` in full float32, instead of the colliding
    scatter-add that autograd derives for a gather of [npix] rows from a
    table of a few.  The forward value is the gather's, bit for bit."""

    @staticmethod
    def forward(ctx, table, m):
        ctx.save_for_backward(m)
        ctx.save_for_forward(m)
        ctx.rows = table.shape[0]
        return table[m]

    @staticmethod
    def jvp(ctx, t_table, _t_m):
        """The gather's tangent, ``t_table[m]``."""
        (m,) = ctx.saved_tensors
        return t_table[m]

    @staticmethod
    def backward(ctx, ct):
        (m,) = ctx.saved_tensors
        flat = m.reshape(-1)
        onehot = (flat[:, None] == torch.arange(
            ctx.rows, device=m.device)[None, :]).to(ct.dtype)
        return _matmul_fp32(onehot.t(), ct.reshape(flat.shape[0], -1)), None


def _matmul_fp32(a, b):
    """``a @ b`` accumulated in full float32, PyTorch's default on the
    card.  It changes no process-wide precision setting; where the
    caller has allowed TF32 products it raises rather than lose digits
    silently."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "material_fetch='mm_bwd'/'onehot' needs full-float32 matrix "
            "products: torch.backends.cuda.matmul.allow_tf32 is True")
    return a @ b


def _material_rows(config, table, m):
    """Rows ``m`` of the packed [M, 19] material table, by
    ``config.material_fetch``: "mm_bwd" gathers forward and multiplies
    backward, "onehot" multiplies both ways, "gather" (and any table of
    more than 64 rows) leaves both to autograd."""
    if config.material_fetch not in ("mm_bwd", "onehot", "gather"):
        raise ValueError(f"material_fetch {config.material_fetch!r}: "
                         "expected 'mm_bwd', 'onehot' or 'gather'")
    if table.shape[0] <= 64:
        if config.material_fetch == "mm_bwd":
            return _GatherRowsMmBwd.apply(table, m)
        if config.material_fetch == "onehot":
            onehot = (m[..., None] == torch.arange(
                table.shape[0], device=m.device)).to(torch.float32)
            return _matmul_fp32(onehot, table)
    return table[m]


def _generate_hitdata(config, ir, hit, ray_d) -> dict:
    """Material constants or texture fetches per map slot, tangent-space
    normal mapping, the ^2.2 quirk on roughness and metallic, the hit's
    frame, and the albedo shaders on the mapped normal.  Slots that no
    material binds (``config.tex_slots_used``) are skipped outright."""
    mats = ir["materials"]
    atlas = ir["atlas"]
    m = hit["mat"]
    dev = m.device
    with spans.span("hitdata.material", dev):
        table = torch.cat([mats["albedo"], mats["emission"]]
                          + [mats[s][:, None] for s in _SCALAR_FIELDS],
                          dim=1)
        row = _material_rows(config, table, m)
        scalar = {s: row[..., 6 + i] for i, s in enumerate(_SCALAR_FIELDS)}
        tex = mats["tex"][m]
    tu, tv = hit["tu"], hit["tv"]
    used = config.tex_slots_used

    def fetch(slot):
        tid = tex[..., slot]
        with spans.span("hitdata.texture", dev):
            val = sample_filtered(atlas, torch.clamp(tid, min=0), tu, tv,
                                  uniform_filter=config.tex_uniform_filter)
        return tid >= 0, val

    def tex_rgb(slot, fallback):
        if not used[slot]:
            return fallback
        bound, val = fetch(slot)
        return where3(bound, val, fallback)

    def tex_x(slot, fallback):
        if not used[slot]:
            return fallback
        bound, val = fetch(slot)
        return torch.where(bound, val[..., 0], fallback)

    hd = {
        "albedo": tex_rgb(0, row[..., 0:3]),
        "emission": tex_rgb(1, row[..., 3:6]),
        "roughness": tex_x(2, scalar["roughness"]),
        "metallic": tex_x(3, scalar["metallic"]),
        "opacity": tex_x(5, scalar["opacity"]),
        "transmission": tex_x(6, scalar["transmission"]),
        "normal": hit["normal"],
    }
    if used[4]:
        # Normal map: nearest fetch, tangent-space y flipped.
        ntid = tex[..., 4]
        with spans.span("hitdata.texture", dev):
            local_n = sample_nearest(atlas, torch.clamp(ntid, min=0), tu,
                                     tv) * 2.0 - 1.0
        world_n = normalize(local_n[..., 0:1] * hit["tangent"]
                            - local_n[..., 1:2] * hit["bitangent"]
                            + local_n[..., 2:3] * hit["normal"])
        hd["normal"] = where3(ntid >= 0, world_n, hit["normal"])
    hd["roughness"] = torch.pow(hd["roughness"], 2.2)
    hd["metallic"] = torch.pow(hd["metallic"], 2.2)
    for k in ("clearcoat", "anisotropic", "eta", "specular", "subsurface",
              "sheen"):
        hd[k] = scalar[k]
    hd["clearcoatGloss"] = scalar["clearcoat_gloss"]
    hd["specularTint"] = scalar["specular_tint"]
    hd["sheenTint"] = scalar["sheen_tint"]
    hd["gnormal"] = hit["gnormal"]
    hd["tangent"] = hit["tangent"]
    hd["bitangent"] = hit["bitangent"]
    hd["position"] = hit["position"]
    if config.use_shaders:
        hd["albedo"] = shader_registry.apply_shaders(
            mats["shader"][m], hd["albedo"], hit["position"], ray_d,
            hd["normal"], hit["gnormal"], tu, tv)
    return hd


def sample_radiance(config, ir, rng, npix, pixel_offset=0,
                    trace_cache=None, record=False):
    """One path-traced sample for every pixel, without the progressive
    accumulation.  Returns (out, rng) with out = {"light" (clamped),
    "ok" (no NaN), "normal"/"tangent"/"bitangent"/"albedo" first-hit
    AOVs, "rays" (alive-ray count when config.count_rays)}.

    ``record=True`` adds out["trace"], each bounce's discrete trace
    results: {"hit" [B, npix] int32 path-hit tri ids, "occ" [B, npix]
    bool environment-shadow occlusion, "locc" the light shadow's with
    point lights}.  ``trace_cache=<that dict>`` replays them instead of
    tracing: the bounce loop then launches no traversal and sorts no
    rays.  The estimator treats those results as constants either way,
    so a replayed sample's gradient is exactly the traced one's.

    ``config.remat_bounces`` checkpoints each bounce: the backward pass
    recomputes a bounce from its carry (the RNG state rides in the
    carry, so the recomputation draws the same numbers) instead of
    keeping its intermediates."""
    dev = rng.device
    x_res, y_res = config.x_res, config.y_res
    f32 = dict(dtype=torch.float32, device=dev)

    with spans.span("camera", dev):
        idx = pixel_offset + torch.arange(npix, device=dev)
        px = idx % x_res
        py = idx // x_res
        rng, r1 = rng_mod.next_float(rng)
        rng, r2 = rng_mod.next_float(rng)
        rng, r3 = rng_mod.next_float(rng)
        rng, r4 = rng_mod.next_float(rng)
        rng, r5 = rng_mod.next_float(rng)
        cam = dict(ir["camera"])
        cam["bokeh"] = config.bokeh
        ray_o, ray_d = camera_ray(cam, x_res, y_res, px, py, r1, r2, r3, r4,
                                  r5)

    zeros3 = torch.zeros((npix, 3), **f32)
    env = ir["env"]
    H, W, _ = env["img"].shape
    replay = trace_cache is not None
    use_sort = uses_sort(config, ir) and not replay
    inf_col = torch.full((npix,), float("inf"), **f32)
    merge_lights = not config.compat and config.n_lights > 0
    n_bounces = max(config.max_bounces, 1)  # bounce 0 always runs
    tracing = spans.enabled()

    def bounce_body(bounce, carry, perm):
        """One bounce.  Returns (carry, the permutation for the next
        bounce's path rays, (hit ids, env occlusion, light occlusion))."""
        (rng, ray_o, ray_d, light, reduction, alive, aov_normal,
         aov_tangent, aov_bitangent, aov_albedo, prev_brdf_pdf, had_bounce,
         rays) = carry
        if config.count_rays or tracing:
            n_alive = alive.to(torch.float32).sum()
            spans.count_device("alive_lanes", n_alive)
            if config.count_rays:
                rays = rays + n_alive
        with spans.span("traverse", dev):
            if replay:
                hit_idx = trace_cache["hit"][bounce].to(torch.int64)
            else:
                # The distance is dropped: full_hit recomputes t and the
                # position, differentiably, from the hit tri.  Bounce 0's
                # camera rays are pixel-ordered: no sort.
                hit_idx, _ = _trace(config, ir, ray_o, ray_d, mask=alive,
                                    perm=perm, sort=use_sort and bounce > 0)

        miss = alive & (hit_idx < 0)
        if config.compat:
            env_val = hdri_ops.env_radiance(env, ray_d)
            light = light + where3(miss, reduction * env_val, zeros3)
        else:
            # The miss radiance is added below with the NEE fetch: miss
            # and shading lanes are disjoint, so one texel fetch serves
            # both.
            u_miss, v_miss = spherical_mapping(-ray_d)
        alive = alive & ~miss

        with spans.span("hitdata", dev):
            with spans.span("hitdata.tri", dev):
                tri = gather_tri(ir["tris"], torch.clamp(hit_idx, min=0))
                hit = full_hit(ray_o, ray_d, tri)
            hd = _generate_hitdata(config, ir, hit, ray_d)

        rng, r_op = rng_mod.next_float_masked(rng, alive)
        shade = alive & (r_op <= hd["opacity"])

        rng, r_hdri = rng_mod.next_float_masked(rng, shade)
        rng, rs1 = rng_mod.next_float_masked(rng, shade)
        rng, rs2 = rng_mod.next_float_masked(rng, shade)
        rng, rs3 = rng_mod.next_float_masked(rng, shade)

        wo = -ray_d
        n = hd["normal"]

        # --- environment NEE direction ---------------------------------
        if config.compat:
            sx, sy = hdri_ops.sample_env(env, r_hdri)
            nu = sx.to(torch.float32) / float(W)
            nv = sy.to(torch.float32) / float(H)
        else:
            if config.env_sampler == "alias":
                if "alias_prob" not in env:
                    raise ValueError(
                        "env_sampler='alias' but the IR's env has no alias "
                        "table; rebuild it with the alias config or set "
                        "env_sampler='cdf'")
                rng, r_al = rng_mod.next_float_masked(rng, shade)
                sx, sy = hdri_ops.sample_env_alias(env, r_hdri, r_al)
            else:
                sx, sy = hdri_ops.sample_env_exact(env, r_hdri)
            # Uniform jitter within the texel: env_pdf_uv is then the
            # sampler's exact density.
            rng, ju = rng_mod.next_float_masked(rng, shade)
            rng, jv = rng_mod.next_float_masked(rng, shade)
            nu = (sx.to(torch.float32) + ju) / float(W)
            nv = (sy.to(torch.float32) + jv) / float(H)
        wihdri = -normalize(reverse_spherical_mapping(nu, nv))
        shadow_o = hd["position"] + n * 1e-3

        if config.compat:
            wibrdf = disney_sample(hd, wo, n, rs1, rs2, rs3)
        else:
            # Detached sampling: the sampled direction is a constant of
            # the backward pass and, detached, of a forward-mode one.
            with torch.no_grad():
                wibrdf = disney_sample(hd, wo, n, rs1, rs2, rs3).detach()

        last = bounce == n_bounces - 1
        bounce_perm = None
        if use_sort and (not last or config.compat
                         or not config.shadow_sort):
            # One sort per bounce, keyed on the hit point and the sampled
            # direction: it orders the next bounce's path rays (and the
            # shadow rays, unless they get their own sort).
            with spans.span("sort", dev):
                bounce_perm = _sort(config, ir, hd["position"], wibrdf,
                                    alive)

        if merge_lights:
            # One light per lane, drawn after every other draw of the
            # bounce.
            rng, r_l = rng_mod.next_float_masked(rng, shade)
            n_l = config.n_lights
            li = torch.clamp(torch.trunc(r_l * n_l).to(torch.int64), 0,
                             n_l - 1)
            lpos = ir["lights"]["pos"][li]
            lrad = ir["lights"]["rad"][li]
            to_light = lpos - hd["position"]
            ldist = torch.sqrt(torch.clamp(dot(to_light, to_light),
                                           min=1e-12))
            wi_l = to_light / ldist[..., None]

        l_occluded = None
        if not config.compat:
            # NEE gate = disney_eval's own gate: where it fails, the NEE
            # term is 0 and occlusion does not matter.
            g_common = shade & (dot(wo, n) > 0.0) \
                & (hd["transmission"] < 1.0)
            g_hdri = g_common & (dot(wihdri, n) > 0.0)
            if merge_lights:
                g_l = g_common & (dot(wi_l, n) > 0.0)
        with spans.span("shadow", dev):
            if replay:
                occluded = trace_cache["occ"][bounce]
                if merge_lights:
                    l_occluded = trace_cache["locc"][bounce]
            elif config.compat:
                # Reference parity: nearest hit plus the self-hit test; every
                # shading lane launches.
                s_idx, _ = _trace(config, ir, shadow_o, wihdri, mask=shade,
                                  perm=bounce_perm)
                occluded = (s_idx >= 0) & (s_idx != hit_idx)
            else:
                if merge_lights:
                    # The environment and light shadow rays as one any-hit
                    # launch of 2N rays: the light half starts 1e-3 along
                    # wi_l and stops 1e-3 short of the light; both halves
                    # exclude the source tri.
                    so = torch.cat([shadow_o, hd["position"] + wi_l * 1e-3])
                    sd = torch.cat([wihdri, wi_l])
                    gate = torch.cat([g_hdri, g_l])
                    excl = torch.cat([hit_idx, hit_idx])
                    t_max = torch.cat([inf_col, ldist - 1e-3])
                else:
                    so, sd, gate, excl, t_max = (shadow_o, wihdri, g_hdri,
                                                 hit_idx, inf_col)
                if use_sort and config.shadow_sort:
                    with spans.span("sort", dev):
                        perm_s = _sort(config, ir, so, sd, gate)
                elif bounce_perm is not None and merge_lights:
                    order, inverse = bounce_perm
                    perm_s = (torch.cat([order, order + npix]),
                              torch.cat([inverse, inverse + npix]))
                else:
                    perm_s = bounce_perm
                s_idx, _ = _trace(config, ir, so, sd, mask=gate, perm=perm_s,
                                  exclude=excl, t_max=t_max)
                occluded = s_idx[:npix] >= 0
                if merge_lights:
                    l_occluded = s_idx[npix:] >= 0

        # Every use of the lobes below keeps the shading lanes alone; the
        # others take their lobes at wo = l = n under autograd, so that
        # their backward stays finite (ops.disney.off_lanes_at_normal).
        wo_s, wihdri_s, wibrdf_s = off_lanes_at_normal(shade, n, wo, wihdri,
                                                       wibrdf)
        f_nee = disney_eval(hd, wo_s, n, wihdri_s)
        if config.compat:
            hdri_val = hdri_ops.env_fetch_uv(env, nu, nv)
            hdri_val = where3(occluded, torch.zeros_like(hdri_val), hdri_val)
            hdri_pdf = hdri_ops.env_pdf(env, sx, sy)
            hdri_int = hdri_val * f_nee * torch.abs(
                dot(wihdri, n))[..., None] / hdri_pdf[..., None]
        else:
            sel_u = torch.where(miss, u_miss, nu)
            sel_v = torch.where(miss, v_miss, nv)
            env_rgb, env_pdf_sel = hdri_ops.env_fetch_pdf_uv(env, sel_u,
                                                             sel_v)
            # Deferred miss radiance, balance-heuristic weighted against
            # the env sampler's density.
            bw = hdri_ops.balance_heuristic(prev_brdf_pdf, env_pdf_sel)
            env_w = torch.where(had_bounce, bw, torch.ones_like(bw))
            light = light + where3(miss, reduction * env_rgb
                                   * env_w[..., None], zeros3)
            hdri_val = where3(occluded, torch.zeros_like(env_rgb), env_rgb)
            hdri_pdf = env_pdf_sel
            nee_brdf_pdf = disney_pdf(hd, wo_s, n, wihdri_s)
            hw = hdri_ops.balance_heuristic(hdri_pdf, nee_brdf_pdf)
            hdri_int = (hdri_val * f_nee
                        * torch.abs(dot(wihdri, n))[..., None]
                        / torch.clamp(hdri_pdf, min=1e-12)[..., None]
                        * (hdri_pdf > 0)[..., None] * hw[..., None])

        brdf_pdf = disney_pdf(hd, wo_s, n, wibrdf_s)
        f_brdf = disney_eval(hd, wo_s, n, wibrdf_s)

        contrib = hd["emission"] + hdri_int
        if merge_lights:
            # Point-light NEE: the uniform 1/N pick cancels the N; delta
            # lights take no MIS weight.
            f_l = disney_eval(hd, wo_s, n,
                              *off_lanes_at_normal(shade, n, wi_l))
            pl_c = (lrad / (ldist * ldist)[..., None]) * f_l \
                * torch.abs(dot(wi_l, n))[..., None] * float(config.n_lights)
            contrib = contrib + where3(shade & ~l_occluded, pl_c,
                                       torch.zeros_like(pl_c))
        light = light + where3(shade, reduction * contrib, zeros3)
        throughput = f_brdf * torch.abs(dot(wibrdf, n))[..., None] / (
            brdf_pdf[..., None] if config.compat
            else torch.clamp(brdf_pdf, min=1e-12)[..., None])
        reduction = where3(shade, reduction * throughput, reduction)

        if bounce == 0:
            # AOVs at the first bounce only; a pass-through leaves zeros.
            aov_normal = where3(shade, n, aov_normal)
            aov_tangent = where3(shade, hd["tangent"], aov_tangent)
            aov_bitangent = where3(shade, hd["bitangent"], aov_bitangent)
            aov_albedo = where3(shade, hd["albedo"], aov_albedo)

        next_o = where3(shade, hit["position"] + wibrdf * 1e-3,
                        hit["position"] + ray_d * 1e-3)
        next_d = where3(shade, normalize(wibrdf), ray_d)
        ray_o = where3(alive, next_o, ray_o)
        ray_d = where3(alive, next_d, ray_d)
        prev_brdf_pdf = torch.where(shade, brdf_pdf, prev_brdf_pdf)
        had_bounce = had_bounce | shade
        if config.count_rays or tracing:
            launched = [shade if config.compat else g_hdri]
            if merge_lights:
                launched.append(g_l)
            for gate in launched:
                n_shadow = gate.to(torch.float32).sum()
                spans.count_device("shadow_lanes", n_shadow)
                if config.count_rays:
                    rays = rays + n_shadow
        carry = (rng, ray_o, ray_d, light, reduction, alive, aov_normal,
                 aov_tangent, aov_bitangent, aov_albedo, prev_brdf_pdf,
                 had_bounce, rays)
        return carry, bounce_perm, (hit_idx, occluded, l_occluded)

    carry = (rng, ray_o, ray_d, zeros3, torch.ones((npix, 3), **f32),
             torch.ones((npix,), dtype=torch.bool, device=dev), zeros3,
             zeros3, zeros3, zeros3, torch.zeros((npix,), **f32),
             torch.zeros((npix,), dtype=torch.bool, device=dev),
             torch.zeros((), **f32))
    perm = None
    recorded = []
    for bounce in range(n_bounces):
        if tracing:
            spans.count("lanes", npix)
        with spans.span("bounce", dev):
            if config.remat_bounces:
                carry, perm, found = checkpoint(
                    bounce_body, bounce, carry, perm, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                carry, perm, found = bounce_body(bounce, carry, perm)
        recorded.append(found)

    (rng, _, _, light, _, _, aov_normal, aov_tangent, aov_bitangent,
     aov_albedo, _, _, rays) = carry
    light = _ClipBalanced.apply(light, 0.0, config.clamp_radiance)
    ok = ~torch.isnan(light).any(dim=-1)
    out = {"light": light, "ok": ok, "normal": aov_normal,
           "tangent": aov_tangent, "bitangent": aov_bitangent,
           "albedo": aov_albedo, "rays": rays}
    if record:
        out["trace"] = {
            "hit": torch.stack([f[0].to(torch.int32) for f in recorded]),
            "occ": torch.stack([f[1] for f in recorded])}
        if merge_lights:
            out["trace"]["locc"] = torch.stack([f[2] for f in recorded])
    return out, rng


def render_sample(config, ir, state, pixel_offset=0, record=False,
                  device="cuda"):
    """Advance the accumulators by one progressive sample for every
    pixel of ``state``; returns the new state (the input is not
    modified), or with ``record=True`` (new state, the sample's trace
    record: see ``sample_radiance``).  ``state`` and ``ir`` must lie on
    ``device``."""
    dev = resolve_device(device)
    if state["rng"].device.type != dev.type:
        raise ValueError(f"state is on {state['rng'].device}, "
                         f"render_sample was asked for {dev}")
    with spans.span("sample", dev):
        npix = state["samples"].shape[0]
        out, rng = sample_radiance(config, ir, state["rng"], npix,
                                   pixel_offset, record=record)
        with spans.span("accumulate", dev):
            ok = out["ok"]
            sa = state["samples"].to(torch.float32)
            scale = torch.where(sa > 0, sa / (sa + 1.0),
                                torch.ones_like(sa))
            inv = 1.0 / (sa + 1.0)
            passes = state["passes"]
            rgb_scale = torch.where(ok[None, :, None], scale[None, :, None],
                                    torch.ones_like(scale)[None, :, None])
            rgb = passes[:, :, :3] * rgb_scale
            adds = [None] * PASSES_COUNT
            for pid, val in ((BEAUTY, out["light"]),
                             (NORMAL, out["normal"]),
                             (TANGENT, out["tangent"]),
                             (BITANGENT, out["bitangent"]),
                             (DENOISE, out["albedo"])):
                add = val * inv[:, None]
                adds[pid] = torch.where(ok[:, None], add,
                                        torch.zeros_like(add))
            rgb = rgb + torch.stack(adds)
            new_state = {
                "passes": torch.cat([rgb, passes[:, :, 3:]], dim=2),
                "samples": state["samples"] + ok.to(torch.int64),
                "rng": rng,
            }
            if config.count_rays:
                new_state["ray_count"] = state["ray_count"] + out["rays"]
    if record:
        return new_state, out["trace"]
    return new_state
