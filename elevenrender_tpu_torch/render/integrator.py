"""The path-tracing integrator: one progressive sample over all pixels.

Port of ``elevenrender_tpu/render/integrator.py`` (``init_state``,
``_trace``, ``_generate_hitdata``, ``sample_radiance``,
``render_sample``).  The image is a flat wavefront of rays advanced in
lockstep; every branch of the reference megakernel is a lane mask.  Each
bounce: a closest-hit trace of the path rays, the hit attributes and
material row, Disney sample/eval/pdf, environment NEE with an any-hit
shadow trace (native) or a nearest-hit self-test (compat), and the MIS
accumulation.

Both traversals of a bounce go through ``ops.traverse.traverse``: the
CUDA kernel on the card, its plain version on the CPU.  Rays are sorted
once per bounce by hit point and sampled direction (and the native
shadow rays by their own gate) so that neighbouring threads walk
neighbouring rays; the sort changes no result beyond equal-t ties.

Scope of this slice: native and compat modes, untextured scenes, no
point lights, no programmable shaders, forward only.  The rest raises
``NotImplementedError`` (see ``check_supported``).
"""

from __future__ import annotations

import torch

from ..core import rng as rng_mod
from ..core.device import resolve_device
from ..core.vecmath import dot, normalize, where3
from ..ops import hdri as hdri_ops
from ..ops import traverse as traverse_ops
from ..ops.camera import camera_ray
from ..ops.disney import disney_eval, disney_pdf, disney_sample
from ..ops.intersect import full_hit, gather_tri
from ..ops.sort import sort_for_packets
from ..ops.texture import reverse_spherical_mapping, spherical_mapping

BEAUTY, DENOISE, NORMAL, TANGENT, BITANGENT = range(5)
PASSES_COUNT = 5

_SCALAR_FIELDS = ("roughness", "metallic", "opacity", "transmission",
                  "clearcoat", "anisotropic", "eta", "specular",
                  "subsurface", "sheen", "clearcoat_gloss",
                  "specular_tint", "sheen_tint")


def check_supported(config) -> None:
    """Raise for what this slice of the port does not render yet."""
    if any(config.tex_slots_used):
        raise NotImplementedError(
            "textured materials (config.tex_slots_used) are not ported yet")
    if config.n_lights > 0:
        raise NotImplementedError("point lights are not ported yet")
    if config.use_shaders:
        raise NotImplementedError(
            "programmable shaders (config.use_shaders) are not ported yet")


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


def resolve_trace_mode(config, ir) -> str:
    """"brute" for tiny scenes (<= 64 tris), ``use_bvh=False`` or
    ``trace_mode="brute"``; otherwise "bvh", the traversal kernel."""
    n_tris = ir["tris"]["verts"].shape[0]
    if (not config.use_bvh or config.trace_mode == "brute"
            or (config.trace_mode == "auto" and n_tris <= 64)):
        return "brute"
    return "bvh"


def uses_sort(config, ir) -> bool:
    return config.sort_rays and resolve_trace_mode(config, ir) == "bvh"


def _sort(config, ir, origin, direction, mask):
    return sort_for_packets(origin, direction, ir["bvh"]["node_bmin"][0],
                            ir["bvh"]["node_bmax"][0], mask=mask,
                            dir_major=config.sort_dir_major,
                            impl=config.sort_impl,
                            dir_bits=config.sort_dir_bits)


def _trace(config, ir, ray_o, ray_d, mask=None, perm=None, exclude=None,
           t_max=None, sort=True):
    """Nearest hit per ray (idx i64, -1 on a miss; t), or with
    ``exclude``/``t_max`` an occlusion query (idx >= 0 iff some tri other
    than exclude is hit closer than t_max).

    ``mask``: lanes that need a result; the others get a ray that misses
    the root's children at once.  ``perm``: a precomputed (order,
    inverse) pair; with ``sort`` and no ``perm`` the rays are sorted
    here.  Brute force emulates occlusion by nearest hit plus filter."""
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
        up = torch.tensor([0.0, 0.0, 1.0], dtype=ray_d.dtype,
                          device=ray_d.device)
        ray_o = where3(mask, ray_o, far.expand_as(ray_o))
        ray_d = where3(mask, ray_d, up.expand_as(ray_d))

    inverse = None
    if config.sort_rays and sort:
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
                                   exclude=exclude, t_max=t_max)
    idx = idx.to(torch.int64)
    if inverse is not None:
        idx = idx[inverse]
        t = t[inverse]
    return idx, t


def _generate_hitdata(config, ir, hit) -> dict:
    """Material constants at the hit (untextured), the ^2.2 quirk on
    roughness and metallic, and the hit's frame."""
    mats = ir["materials"]
    table = torch.cat([mats["albedo"], mats["emission"]]
                      + [mats[s][:, None] for s in _SCALAR_FIELDS], dim=1)
    if table.requires_grad and config.material_fetch != "gather":
        raise NotImplementedError(
            f"material_fetch={config.material_fetch!r} defines a custom "
            "backward (gradient slice, not ported yet); use 'gather'")
    row = table[hit["mat"]]
    scalar = {s: row[..., 6 + i] for i, s in enumerate(_SCALAR_FIELDS)}
    hd = {
        "albedo": row[..., 0:3],
        "emission": row[..., 3:6],
        "roughness": torch.pow(scalar["roughness"], 2.2),
        "metallic": torch.pow(scalar["metallic"], 2.2),
        "opacity": scalar["opacity"],
        "transmission": scalar["transmission"],
        "normal": hit["normal"],
        "clearcoatGloss": scalar["clearcoat_gloss"],
        "specularTint": scalar["specular_tint"],
        "sheenTint": scalar["sheen_tint"],
        "gnormal": hit["gnormal"],
        "tangent": hit["tangent"],
        "bitangent": hit["bitangent"],
        "position": hit["position"],
    }
    for k in ("clearcoat", "anisotropic", "eta", "specular", "subsurface",
              "sheen"):
        hd[k] = scalar[k]
    return hd


def sample_radiance(config, ir, rng, npix, pixel_offset=0,
                    trace_cache=None, record=False):
    """One path-traced sample for every pixel, without the progressive
    accumulation.  Returns (out, rng) with out = {"light" (clamped),
    "ok" (no NaN), "normal"/"tangent"/"bitangent"/"albedo" first-hit
    AOVs, "rays" (alive-ray count when config.count_rays)}.

    ``record``/``trace_cache`` (the gradient accumulator's trace replay)
    belong to the gradient slice and raise for now."""
    if record or trace_cache is not None:
        raise NotImplementedError(
            "record/trace_cache (gradient trace replay) are not ported yet")
    check_supported(config)
    dev = rng.device
    x_res, y_res = config.x_res, config.y_res
    f32 = dict(dtype=torch.float32, device=dev)

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
    ray_o, ray_d = camera_ray(cam, x_res, y_res, px, py, r1, r2, r3, r4, r5)

    zeros3 = torch.zeros((npix, 3), **f32)
    light = zeros3
    reduction = torch.ones((npix, 3), **f32)
    aov_normal = aov_tangent = aov_bitangent = aov_albedo = zeros3
    alive = torch.ones((npix,), dtype=torch.bool, device=dev)
    env = ir["env"]
    H, W, _ = env["img"].shape
    prev_brdf_pdf = torch.zeros((npix,), **f32)
    had_bounce = torch.zeros((npix,), dtype=torch.bool, device=dev)
    rays = torch.zeros((), **f32)
    use_sort = uses_sort(config, ir)
    perm = None  # bounce 0's camera rays are pixel-ordered: no sort
    inf_col = torch.full((npix,), float("inf"), **f32)

    n_bounces = max(config.max_bounces, 1)  # bounce 0 always runs
    for bounce in range(n_bounces):
        if config.count_rays:
            rays = rays + alive.to(torch.float32).sum()
        hit_idx, _ = _trace(config, ir, ray_o, ray_d, mask=alive, perm=perm,
                            sort=use_sort and bounce > 0)

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

        tri = gather_tri(ir["tris"], torch.clamp(hit_idx, min=0))
        hit = full_hit(ray_o, ray_d, tri)
        hd = _generate_hitdata(config, ir, hit)

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

        wibrdf = disney_sample(hd, wo, n, rs1, rs2, rs3)

        last = bounce == n_bounces - 1
        bounce_perm = None
        if use_sort and (not last or config.compat
                         or not config.shadow_sort):
            # One sort per bounce, keyed on the hit point and the sampled
            # direction: it orders the next bounce's path rays (and the
            # shadow rays, unless they get their own sort).
            bounce_perm = _sort(config, ir, hd["position"], wibrdf, alive)

        if config.compat:
            # Reference parity: nearest hit plus the self-hit test; every
            # shading lane launches.
            s_idx, _ = _trace(config, ir, shadow_o, wihdri, mask=shade,
                              perm=bounce_perm)
            occluded = (s_idx >= 0) & (s_idx != hit_idx)
        else:
            # NEE gate = disney_eval's own gate: where it fails, the NEE
            # term is 0 and occlusion does not matter.
            g_common = shade & (dot(wo, n) > 0.0) \
                & (hd["transmission"] < 1.0)
            g_hdri = g_common & (dot(wihdri, n) > 0.0)
            if use_sort and config.shadow_sort:
                perm_s = _sort(config, ir, shadow_o, wihdri, g_hdri)
            else:
                perm_s = bounce_perm
            s_idx, _ = _trace(config, ir, shadow_o, wihdri, mask=g_hdri,
                              perm=perm_s, exclude=hit_idx, t_max=inf_col)
            occluded = s_idx >= 0
        perm = bounce_perm

        f_nee = disney_eval(hd, wo, n, wihdri)
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
            nee_brdf_pdf = disney_pdf(hd, wo, n, wihdri)
            hw = hdri_ops.balance_heuristic(hdri_pdf, nee_brdf_pdf)
            hdri_int = (hdri_val * f_nee
                        * torch.abs(dot(wihdri, n))[..., None]
                        / torch.clamp(hdri_pdf, min=1e-12)[..., None]
                        * (hdri_pdf > 0)[..., None] * hw[..., None])

        brdf_pdf = disney_pdf(hd, wo, n, wibrdf)
        f_brdf = disney_eval(hd, wo, n, wibrdf)

        contrib = hd["emission"] + hdri_int
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
        if config.count_rays:
            launched = shade if config.compat else g_hdri
            rays = rays + launched.to(torch.float32).sum()

    light = torch.clamp(light, 0.0, config.clamp_radiance)
    ok = ~torch.isnan(light).any(dim=-1)
    out = {"light": light, "ok": ok, "normal": aov_normal,
           "tangent": aov_tangent, "bitangent": aov_bitangent,
           "albedo": aov_albedo, "rays": rays}
    return out, rng


def render_sample(config, ir, state, pixel_offset=0, record=False,
                  device="cuda"):
    """Advance the accumulators by one progressive sample for every
    pixel of ``state``; returns the new state (the input is not
    modified).  ``state`` and ``ir`` must lie on ``device``."""
    dev = resolve_device(device)
    if state["rng"].device.type != dev.type:
        raise ValueError(f"state is on {state['rng'].device}, "
                         f"render_sample was asked for {dev}")
    npix = state["samples"].shape[0]
    out, rng = sample_radiance(config, ir, state["rng"], npix, pixel_offset,
                               record=record)
    ok = out["ok"]

    sa = state["samples"].to(torch.float32)
    scale = torch.where(sa > 0, sa / (sa + 1.0), torch.ones_like(sa))
    inv = 1.0 / (sa + 1.0)
    passes = state["passes"]
    rgb_scale = torch.where(ok[None, :, None], scale[None, :, None],
                            torch.ones_like(scale)[None, :, None])
    rgb = passes[:, :, :3] * rgb_scale
    adds = torch.zeros_like(rgb)
    for pid, val in ((BEAUTY, out["light"]), (NORMAL, out["normal"]),
                     (TANGENT, out["tangent"]),
                     (BITANGENT, out["bitangent"]),
                     (DENOISE, out["albedo"])):
        add = val * inv[:, None]
        adds[pid] = torch.where(ok[:, None], add, torch.zeros_like(add))
    rgb = rgb + adds
    new_state = {
        "passes": torch.cat([rgb, passes[:, :, 3:]], dim=2),
        "samples": state["samples"] + ok.to(torch.int64),
        "rng": rng,
    }
    if config.count_rays:
        new_state["ray_count"] = state["ray_count"] + out["rays"]
    return new_state
