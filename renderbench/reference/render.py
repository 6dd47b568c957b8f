"""The plain reference of a progressive render and of its gradient.

A path tracer in plain PyTorch over the raw scene the benchmark makes
(``renderbench/scene.py``): its own tables (``prepare``), its own ray
casting (``boxtree.py``), and the estimator of
``elevenrender_tpu_torch/render/integrator.py``'s native mode as of the
benchmark's first version, frozen here formula for formula: camera rays
with jitter, closest hit, the hit's smooth shading frame and textures
(albedo map, tangent-space normal map), Disney BRDF sampling, the
environment's alias-table next-event estimate with a jittered texel,
one point light per lane, one any-hit query per shadow ray, the
balance heuristic against the BRDF's pdf, the clamp, the NaN guard and
the progressive running mean.  It imports nothing of the port.

It renders any subset of the pixels: each pixel's path and random
stream depend on that pixel alone.  ``q`` (the control) rounds the
tables and every stage's floats to a lower precision; None leaves
float32 as the configuration states it.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bsdf
from .boxtree import BoxTree
from .texture import (FILTER_NONE, camera_ray, env_tables,
                      balance_heuristic, env_fetch_pdf_uv,
                      reverse_spherical_mapping, sample_env_alias,
                      sample_filtered, sample_nearest, spherical_mapping,
                      texel_table)
from .vec import (cross, dot, init_rng, next_float, next_float_masked,
                  normalize, where3)

PASSES = 5  # beauty, albedo, normal, tangent, bitangent
MAP_SLOTS = ("albedo", "emission", "roughness", "metallic", "normal",
             "opacity", "transmission")
SCALARS = ("roughness", "metallic", "opacity", "transmission", "clearcoat",
           "anisotropic", "eta", "specular", "subsurface", "sheen",
           "clearcoat_gloss", "specular_tint", "sheen_tint")


def _same(x):
    return x


def prepare(raw: dict, device, q=None) -> dict:
    """The reference's tables from the raw scene (numpy, see
    ``renderbench/scene.py``) on ``device``."""
    q = q or _same
    dev = torch.device(device)

    def t(a, dtype=None):
        x = torch.tensor(np.asarray(a), device=dev)
        if dtype is not None:
            x = x.to(dtype)
        return q(x) if x.is_floating_point() else x

    mesh = raw["mesh"]
    mats = raw["materials"]
    tex_ids = np.array([[m["maps"].get(s, -1) for s in MAP_SLOTS]
                        for m in mats], np.int64)
    table = np.concatenate(
        [np.array([m["albedo"] for m in mats], np.float32),
         np.array([m["emission"] for m in mats], np.float32),
         np.array([[m[s] for s in SCALARS] for m in mats], np.float32)],
        axis=1)
    filters = sorted({f for _, f in raw["textures"]})
    env = env_tables(raw["env"])
    lights = raw["lights"]
    cam = raw["camera"]
    return {
        "res": (raw["x_res"], raw["y_res"]),
        "bounces": max(raw["bounces"], 1),
        "clamp": raw["clamp_radiance"],
        "boxes": BoxTree(mesh["verts"], dev, q),
        "tris": {k: t(mesh[k]) for k in ("verts", "normals", "uvs",
                                          "tangents", "sign")},
        "mat_of_tri": t(mesh["mat"], torch.int64),
        "table": t(table),
        "tex": t(tex_ids),
        "slots_used": tuple(bool(b) for b in (tex_ids >= 0).any(axis=0)),
        "uniform_filter": (filters[0] if len(filters) == 1
                           else (FILTER_NONE if not filters else -1)),
        "texels": {k: t(v) for k, v in texel_table(raw["textures"]).items()},
        "env": {k: t(v) for k, v in env.items()},
        "camera": {**{k: t(np.asarray(cam[k], np.float32))
                      for k in ("position", "rotation", "focal_length",
                                "sensor_width", "sensor_height", "aperture",
                                "focus_distance")},
                   "bokeh": bool(cam["bokeh"])},
        "n_lights": len(lights),
        "light_pos": t(np.array([l["position"] for l in lights]
                                or [[0.0, 0.0, 0.0]], np.float32)),
        "light_rad": t(np.array([l["radiance"] for l in lights]
                                or [[0.0, 0.0, 0.0]], np.float32)),
    }


def _hit(ref, ray_o, ray_d, idx):
    """The hit's shading attributes (the port's ``full_hit``)."""
    tris = ref["tris"]
    safe = torch.clamp(idx, min=0)
    verts = tris["verts"][safe]
    v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
    edge1 = v1 - v0
    edge2 = v2 - v0
    pvec = cross(ray_d, edge2)
    det = dot(edge1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30,
                                torch.full_like(det, 1e-30), det)
    tvec = ray_o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, edge1)
    v = dot(ray_d, qvec) * inv_det
    t = dot(edge2, qvec) * inv_det
    uvs = tris["uvs"][safe]
    t_uv = (uvs[:, 0] + (uvs[:, 1] - uvs[:, 0]) * u[:, None]
            + (uvs[:, 2] - uvs[:, 0]) * v[:, None])
    geom_pos = ray_o + ray_d * t[:, None]
    nrm = tris["normals"][safe]
    n0, n1, n2 = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    shading_normal = normalize(n0 + (n1 - n0) * u[:, None]
                               + (n2 - n0) * v[:, None])
    comp = normalize(cross(edge1, edge2))
    comp = torch.where(dot(comp, ray_d)[:, None] > 0.0, -comp, comp)
    tg = tris["tangents"][safe]
    tangent = (tg[:, 0] + (tg[:, 1] - tg[:, 0]) * u[:, None]
               + (tg[:, 2] - tg[:, 0]) * v[:, None])

    def project(p, origin, normal):
        return p - dot(p - origin, normal)[:, None] * normal

    p0 = project(geom_pos, v0, n0)
    p1 = project(geom_pos, v1, n1)
    p2 = project(geom_pos, v2, n2)
    shading_pos = p0 + (p1 - p0) * u[:, None] + (p2 - p0) * v[:, None]
    convex = dot(shading_pos - geom_pos, shading_normal) > 0.0
    return {
        "position": torch.where(convex[:, None], shading_pos, geom_pos),
        "normal": shading_normal,
        "gnormal": comp,
        "tangent": tangent,
        "bitangent": tris["sign"][safe][:, None] * cross(shading_normal,
                                                         tangent),
        "tu": t_uv[:, 0],
        "tv": t_uv[:, 1],
        "mat": ref["mat_of_tri"][safe],
    }


def _hitdata(ref, hit, table, q):
    """Material row or texture per map slot, the normal map, the ^2.2 on
    roughness and metallic (the port's ``_generate_hitdata``)."""
    m = hit["mat"]
    row = table[m]
    scalar = {s: row[:, 6 + i] for i, s in enumerate(SCALARS)}
    tex = ref["tex"][m]
    tu, tv = hit["tu"], hit["tv"]
    used = ref["slots_used"]
    texels = ref["texels"]

    def fetch(slot):
        tid = tex[:, slot]
        val = sample_filtered(texels, torch.clamp(tid, min=0), tu, tv,
                              ref["uniform_filter"])
        return tid >= 0, q(val)

    def rgb(slot, fallback):
        if not used[slot]:
            return fallback
        bound, val = fetch(slot)
        return where3(bound, val, fallback)

    def x(slot, fallback):
        if not used[slot]:
            return fallback
        bound, val = fetch(slot)
        return torch.where(bound, val[:, 0], fallback)

    hd = {"albedo": rgb(0, row[:, 0:3]), "emission": rgb(1, row[:, 3:6]),
          "roughness": x(2, scalar["roughness"]),
          "metallic": x(3, scalar["metallic"]),
          "opacity": x(5, scalar["opacity"]),
          "transmission": x(6, scalar["transmission"]),
          "normal": hit["normal"]}
    if used[4]:
        ntid = tex[:, 4]
        local_n = q(sample_nearest(texels, torch.clamp(ntid, min=0), tu,
                                   tv)) * 2.0 - 1.0
        world_n = normalize(local_n[:, 0:1] * hit["tangent"]
                            - local_n[:, 1:2] * hit["bitangent"]
                            + local_n[:, 2:3] * hit["normal"])
        hd["normal"] = where3(ntid >= 0, world_n, hit["normal"])
    hd["roughness"] = torch.pow(hd["roughness"], 2.2)
    hd["metallic"] = torch.pow(hd["metallic"], 2.2)
    for k in ("clearcoat", "anisotropic", "eta", "specular", "subsurface",
              "sheen"):
        hd[k] = scalar[k]
    hd["clearcoatGloss"] = scalar["clearcoat_gloss"]
    hd["specularTint"] = scalar["specular_tint"]
    hd["sheenTint"] = scalar["sheen_tint"]
    for k in ("gnormal", "tangent", "bitangent", "position"):
        hd[k] = hit[k]
    return {k: q(v) if v.is_floating_point() else v for k, v in hd.items()}


CARRY = ("rng", "ray_o", "ray_d", "light", "reduction", "alive",
         "aov_normal", "aov_tangent", "aov_bitangent", "aov_albedo",
         "prev_brdf_pdf", "had_bounce")


def _camera(ref, v, q):
    """The camera rays and the path's starting state (the carry)."""
    rng, pix = v["rng"], v["pix"]
    x_res, y_res = ref["res"]
    n = pix.shape[0]
    f32 = dict(dtype=torch.float32, device=pix.device)
    draws = []
    for _ in range(5):
        rng, r = next_float(rng)
        draws.append(r)
    ray_o, ray_d = camera_ray(ref["camera"], x_res, y_res, pix % x_res,
                              pix // x_res, *draws)
    zeros3 = torch.zeros((n, 3), **f32)
    return {"rng": rng, "ray_o": q(ray_o), "ray_d": q(ray_d),
            "light": zeros3, "reduction": torch.ones((n, 3), **f32),
            "alive": torch.ones((n,), dtype=torch.bool, device=pix.device),
            "aov_normal": zeros3, "aov_tangent": zeros3,
            "aov_bitangent": zeros3, "aov_albedo": zeros3,
            "prev_brdf_pdf": torch.zeros((n,), **f32),
            "had_bounce": torch.zeros((n,), dtype=torch.bool,
                                      device=pix.device)}


def _at_hit(ref, v, q, table):
    """From the closest hits ``hit_idx`` to the shadow rays: the hit's
    attributes and material, the bounce's draws, the environment and
    light directions, the sampled direction and the shadow rays' gates.
    Returns the carry and what the shadow queries and ``_at_light``
    read."""
    ray_d, alive, hit_idx = v["ray_d"], v["alive"], v["hit_idx"]
    env = ref["env"]
    H, W, _ = env["img"].shape
    miss = alive & (hit_idx < 0)
    u_miss, v_miss = spherical_mapping(-ray_d)
    alive = alive & ~miss
    hit = _hit(ref, v["ray_o"], ray_d, hit_idx)
    hit = {k: q(x) if x.is_floating_point() else x for k, x in hit.items()}
    hd = _hitdata(ref, hit, table, q)
    rng = v["rng"]
    rng, r_op = next_float_masked(rng, alive)
    shade = alive & (r_op <= hd["opacity"])
    rng, r_hdri = next_float_masked(rng, shade)
    rng, rs1 = next_float_masked(rng, shade)
    rng, rs2 = next_float_masked(rng, shade)
    rng, rs3 = next_float_masked(rng, shade)
    wo = -ray_d
    nrm = hd["normal"]
    rng, r_al = next_float_masked(rng, shade)
    sx, sy = sample_env_alias(env, r_hdri, r_al)
    rng, ju = next_float_masked(rng, shade)
    rng, jv = next_float_masked(rng, shade)
    nu = (sx.to(torch.float32) + ju) / float(W)
    nv = (sy.to(torch.float32) + jv) / float(H)
    wihdri = q(-normalize(reverse_spherical_mapping(nu, nv)))
    with torch.no_grad():
        wibrdf = q(bsdf.sample(hd, wo, nrm, rs1, rs2, rs3)).detach()
    g_common = shade & (dot(wo, nrm) > 0.0) & (hd["transmission"] < 1.0)
    out = {**{k: v[k] for k in CARRY}, "rng": rng, "alive": alive,
           "miss": miss, "u_miss": u_miss, "v_miss": v_miss, "shade": shade,
           "nu": nu, "nv": nv, "wihdri": wihdri, "wibrdf": wibrdf,
           "shadow_o": hd["position"] + nrm * 1e-3,
           "g_hdri": g_common & (dot(wihdri, nrm) > 0.0),
           "inf_col": torch.full(alive.shape, float("inf"),
                                 device=alive.device),
           "pos": hit["position"],
           **{"hd." + k: x for k, x in hd.items()}}
    if ref["n_lights"]:
        rng, r_l = next_float_masked(rng, shade)
        n_l = ref["n_lights"]
        li = torch.clamp(torch.trunc(r_l * n_l).to(torch.int64), 0, n_l - 1)
        to_light = ref["light_pos"][li] - hd["position"]
        ldist = torch.sqrt(torch.clamp(dot(to_light, to_light), min=1e-12))
        wi_l = to_light / ldist[:, None]
        out.update(rng=rng, lrad=ref["light_rad"][li], ldist=ldist,
                   wi_l=wi_l, g_l=g_common & (dot(wi_l, nrm) > 0.0),
                   l_o=hd["position"] + wi_l * 1e-3, l_tmax=ldist - 1e-3)
    return out


def _occlusion(ref, v, hit_idx):
    """The shadow rays' any-hit queries: (environment, light or None)."""
    boxes = ref["boxes"]
    occ = boxes.occluded(v["shadow_o"].detach(), v["wihdri"].detach(),
                         v["g_hdri"], hit_idx, v["inf_col"])
    if not ref["n_lights"]:
        return occ, None
    return occ, boxes.occluded(v["l_o"].detach(), v["wi_l"].detach(),
                               v["g_l"], hit_idx, v["l_tmax"].detach())


def _at_light(ref, v, q, bounce):
    """From the shadow queries to the next bounce's rays: the deferred
    environment radiance, the next-event estimates with their MIS
    weights, the throughput, the first-hit AOVs.  Returns the carry."""
    hd = {k[3:]: x for k, x in v.items() if k.startswith("hd.")}
    nrm, shade, miss = hd["normal"], v["shade"], v["miss"]
    ray_d, wihdri, wibrdf = v["ray_d"], v["wihdri"], v["wibrdf"]
    reduction, light = v["reduction"], v["light"]
    zeros3 = torch.zeros_like(light)
    wo_s, wihdri_s, wibrdf_s = bsdf.off_lanes_at_normal(
        shade, nrm, -ray_d, wihdri, wibrdf)
    f_nee = q(bsdf.evaluate(hd, wo_s, nrm, wihdri_s))
    sel_u = torch.where(miss, v["u_miss"], v["nu"])
    sel_v = torch.where(miss, v["v_miss"], v["nv"])
    env_rgb, env_pdf_sel = env_fetch_pdf_uv(ref["env"], sel_u, sel_v)
    bw = balance_heuristic(v["prev_brdf_pdf"], env_pdf_sel)
    env_w = torch.where(v["had_bounce"], bw, torch.ones_like(bw))
    light = light + where3(miss, reduction * env_rgb * env_w[:, None], zeros3)
    hdri_val = where3(v["occ"], torch.zeros_like(env_rgb), env_rgb)
    hdri_pdf = env_pdf_sel
    nee_brdf_pdf = bsdf.pdf(hd, wo_s, nrm, wihdri_s)
    hw = balance_heuristic(hdri_pdf, nee_brdf_pdf)
    hdri_int = (hdri_val * f_nee
                * torch.abs(dot(wihdri, nrm))[:, None]
                / torch.clamp(hdri_pdf, min=1e-12)[:, None]
                * (hdri_pdf > 0)[:, None] * hw[:, None])
    brdf_pdf = q(bsdf.pdf(hd, wo_s, nrm, wibrdf_s))
    f_brdf = q(bsdf.evaluate(hd, wo_s, nrm, wibrdf_s))
    contrib = hd["emission"] + hdri_int
    if ref["n_lights"]:
        ldist, wi_l = v["ldist"], v["wi_l"]
        f_l = bsdf.evaluate(hd, wo_s, nrm, *bsdf.off_lanes_at_normal(
            shade, nrm, wi_l))
        pl_c = (v["lrad"] / (ldist * ldist)[:, None]) * f_l \
            * torch.abs(dot(wi_l, nrm))[:, None] * float(ref["n_lights"])
        contrib = contrib + where3(shade & ~v["locc"], pl_c,
                                   torch.zeros_like(pl_c))
    light = q(light + where3(shade, reduction * q(contrib), zeros3))
    throughput = f_brdf * torch.abs(dot(wibrdf, nrm))[:, None] / \
        torch.clamp(brdf_pdf, min=1e-12)[:, None]
    out = {k: v[k] for k in CARRY}
    out["light"] = light
    out["reduction"] = q(where3(shade, reduction * throughput, reduction))
    if bounce == 0:
        for k, x in (("normal", nrm), ("tangent", hd["tangent"]),
                     ("bitangent", hd["bitangent"]), ("albedo", hd["albedo"])):
            out["aov_" + k] = where3(shade, x, v["aov_" + k])
    pos, alive = v["pos"], v["alive"]
    next_o = where3(shade, pos + wibrdf * 1e-3, pos + ray_d * 1e-3)
    next_d = where3(shade, normalize(wibrdf), ray_d)
    out["ray_o"] = q(where3(alive, next_o, v["ray_o"]))
    out["ray_d"] = q(where3(alive, next_d, ray_d))
    out["prev_brdf_pdf"] = torch.where(shade, brdf_pdf, v["prev_brdf_pdf"])
    out["had_bounce"] = v["had_bounce"] | shade
    return out


def _finish(ref, v):
    light = torch.clamp(v["light"], 0.0, ref["clamp"])
    aov = {k: v["aov_" + k] for k in ("albedo", "normal", "tangent",
                                      "bitangent")}
    return light, ~torch.isnan(light).any(dim=-1), aov


def sample_radiance(ref, rng, pix, q=None, table=None, record=None):
    """One native sample of the pixels ``pix`` from their streams
    ``rng``.  Returns (light [P, 3] clamped, ok [P], the first-hit AOVs
    {albedo, normal, tangent, bitangent}, the advanced streams, this
    sample's ray-casting results).  ``table``: the material table (a
    tensor that may require grad; default the scene's).  ``record``: the
    ray-casting results of a call with the same streams, reused instead
    of casting (they do not depend on the material table)."""
    q = q or _same
    table = ref["table"] if table is None else table
    v = _camera(ref, {"rng": rng, "pix": pix}, q)
    cast = {"hit": [], "occ": [], "locc": []}
    for b in range(ref["bounces"]):
        if record is not None:
            hit_idx = record["hit"][b]
        else:
            hit_idx = ref["boxes"].closest(v["ray_o"].detach(),
                                           v["ray_d"].detach(), v["alive"])
        v = _at_hit(ref, {**v, "hit_idx": hit_idx}, q, table)
        if record is not None:
            occ = record["occ"][b]
            locc = record["locc"][b] if ref["n_lights"] else None
        else:
            occ, locc = _occlusion(ref, v, hit_idx)
        cast["hit"].append(hit_idx)
        cast["occ"].append(occ)
        cast["locc"].append(locc)
        v = _at_light(ref, {**v, "occ": occ, "locc": locc}, q, b)
    light, ok, aov = _finish(ref, v)
    return light, ok, aov, v["rng"], cast


def accumulate(passes, samples, light, ok, aov):
    """The progressive running mean of every pass (the port's
    ``render_sample``): passes [5, P, 3], samples [P] int64."""
    sa = samples.to(torch.float32)
    scale = torch.where(sa > 0, sa / (sa + 1.0), torch.ones_like(sa))
    inv = 1.0 / (sa + 1.0)
    rgb = passes * torch.where(ok[None, :, None], scale[None, :, None],
                               torch.ones_like(scale)[None, :, None])
    adds = [torch.where(ok[:, None], val * inv[:, None],
                        torch.zeros_like(val))
            for val in (light, aov["albedo"], aov["normal"], aov["tangent"],
                        aov["bitangent"])]
    return rgb + torch.stack(adds), samples + ok.to(torch.int64)


class _Graphs:
    """The stages of a sample between two ray-casting queries, each
    captured once as a CUDA graph and replayed: the stages' small
    elementwise kernels then cost no launch from Python.  A stage's
    inputs are either ``fixed`` (the state buffers or the outputs of the
    stage before, which keep their addresses from sample to sample) or
    ``fresh`` (the queries' results, copied into the graph's buffers)."""

    def __init__(self):
        self.graphs = {}

    def run(self, key, fn, fixed, fresh):
        if key not in self.graphs:
            bufs = {k: x.clone() for k, x in fresh.items()}
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn({**fixed, **bufs})
            self.graphs[key] = (graph, bufs, out)
        graph, bufs, out = self.graphs[key]
        for k, x in fresh.items():
            bufs[k].copy_(x)
        graph.replay()
        return out


def _step(ref, state, v, q, fault):
    """The sample's end: the clamp, the NaN guard, the running mean, into
    ``state`` in place."""
    light, ok, aov = _finish(ref, v)
    if fault is not None:
        light = fault(light)
    passes, samples = accumulate(state["passes"], state["samples"], light,
                                 ok, aov)
    state["passes"].copy_(q(passes))
    state["samples"].copy_(samples)
    state["rng"].copy_(v["rng"])


def _eager(key, fn, fixed, fresh):
    return fn({**fixed, **fresh})


@torch.no_grad()
def render_pixels(ref, pix, n_samples: int, q=None, fault=None):
    """``n_samples`` progressive samples of the pixels ``pix`` from the
    start: (passes [5, P, 3], samples [P]).  ``fault(light)`` alters
    each sample's radiance (the harness's checks plant faults so).  On a
    card the first sample runs eagerly and the later ones replay each
    stage's graph; the ray-casting queries run eagerly between them."""
    q = q or _same
    n = pix.shape[0]
    state = {"passes": torch.zeros((PASSES, n, 3), device=pix.device),
             "samples": torch.zeros((n,), dtype=torch.int64,
                                    device=pix.device),
             "rng": init_rng(pix), "pix": pix}
    graphs = _Graphs() if pix.is_cuda else None
    boxes = ref["boxes"]
    for i in range(n_samples):
        stage = graphs.run if graphs is not None and i else _eager
        v = stage(("camera",), lambda s: _camera(ref, s, q),
                  {"rng": state["rng"], "pix": pix}, {})
        for b in range(ref["bounces"]):
            hit_idx = boxes.closest(v["ray_o"], v["ray_d"], v["alive"])
            v = stage(("hit", b), lambda s: _at_hit(ref, s, q, ref["table"]),
                      v, {"hit_idx": hit_idx})
            occ, locc = _occlusion(ref, v, hit_idx)
            fresh = {"occ": occ} if locc is None else {"occ": occ,
                                                       "locc": locc}
            v = stage(("light", b), lambda s, b=b: _at_light(ref, s, q, b),
                      v, fresh)
        stage(("step",), lambda s: _step(ref, state, s, q, fault), v, {})
    return state["passes"], state["samples"]
