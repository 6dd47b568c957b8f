"""The Disney BRDF of the plain reference: eval, pdf and sample.

Frozen copy of ``elevenrender_tpu_torch/ops/disney.py`` as of the
benchmark's first version (the knightcrawler25 Disney BRDF of the
original renderer), each expression in the same order.
"""

from __future__ import annotations

import torch

from .vec import (PIF, cosine_sample_hemisphere, dot, importance_sample_ggx,
                  lerp, normalize, reflect, where3)


def schlick_fresnel(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def gtr1(n_dot_h, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    val = (a2 - 1.0) / (PIF * torch.log(a2) * t)
    return torch.where(a >= 1.0, torch.full_like(val, 1.0 / PIF), val)


def gtr2_aniso(n_dot_h, h_dot_x, h_dot_y, ax, ay):
    a = h_dot_x / ax
    b = h_dot_y / ay
    c = a * a + b * b + n_dot_h * n_dot_h
    return 1.0 / (PIF * ax * ay * c * c)


def smith_g_ggx(n_dot_v, alpha_g):
    a = alpha_g * alpha_g
    b = n_dot_v * n_dot_v
    return 1.0 / (n_dot_v + torch.sqrt(a + b - a * b))


def smith_g_ggx_aniso(n_dot_v, v_dot_x, v_dot_y, ax, ay):
    a = v_dot_x * ax
    b = v_dot_y * ay
    c = n_dot_v
    return 1.0 / (n_dot_v + torch.sqrt(a * a + b * b + c * c))


def aniso_alphas(roughness, anisotropic):
    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    ax = torch.clamp(roughness / aspect, min=0.001)
    ay = torch.clamp(roughness * aspect, min=0.001)
    return ax, ay


def off_lanes_at_normal(keep, n, *dirs):
    """Under autograd, the lanes outside ``keep`` take l = v = n, so that
    a discarded lane's backward stays finite; the kept lanes are
    unchanged."""
    if not torch.is_grad_enabled():
        return list(dirs)
    return [where3(keep, d, n) for d in dirs]


def pdf(hd, v, n, l):
    below = dot(n, l) <= 0.0
    l, v = off_lanes_at_normal(~below, n, l, v)
    h = normalize(l + v)
    n_dot_h = torch.abs(dot(n, h))
    clearcoat_alpha = lerp(0.1, 0.001, hd["clearcoatGloss"])
    diffuse_ratio = 0.5 * (1.0 - hd["metallic"])
    specular_ratio = 1.0 - diffuse_ratio
    ax, ay = aniso_alphas(hd["roughness"], hd["anisotropic"])
    pdf_gtr2 = gtr2_aniso(n_dot_h, dot(h, hd["tangent"]),
                          dot(h, hd["bitangent"]), ax, ay) * n_dot_h
    pdf_gtr1 = gtr1(n_dot_h, clearcoat_alpha) * n_dot_h
    ratio = 1.0 / (1.0 + hd["clearcoat"])
    pdf_spec = lerp(pdf_gtr1, pdf_gtr2, ratio) / (
        4.0 * torch.abs(dot(l, h)) + 1e-12)
    pdf_diff = torch.abs(dot(l, n)) * (1.0 / PIF)
    brdf_pdf = diffuse_ratio * pdf_diff + specular_ratio * pdf_spec
    return torch.where(below, torch.ones_like(brdf_pdf), brdf_pdf)


def sample(hd, v, n, r1, r2, r3):
    t = hd["tangent"]
    b = hd["bitangent"]
    take_diffuse = r3 < 0.5 * (1.0 - hd["metallic"])
    hc = cosine_sample_hemisphere(r1, r2)
    dir_diffuse = t * hc[..., 0:1] + b * hc[..., 1:2] + n * hc[..., 2:3]
    hg = importance_sample_ggx(hd["roughness"], r1, r2)
    h = t * hg[..., 0:1] + b * hg[..., 1:2] + n * hg[..., 2:3]
    return where3(take_diffuse, dir_diffuse, reflect(-v, h))


def evaluate(hd, v, n, l):
    gate = ((hd["transmission"] < 1.0) & (dot(n, l) > 0.0)
            & (dot(n, v) > 0.0))
    l, v = off_lanes_at_normal(gate, n, l, v)
    t = hd["tangent"]
    b = hd["bitangent"]
    h = normalize(l + v)
    n_dot_l = torch.abs(dot(n, l))
    n_dot_v = torch.abs(dot(n, v))
    n_dot_h = torch.abs(dot(n, h))
    l_dot_h = torch.abs(dot(l, h))

    cdlin = hd["albedo"]
    cdlum = 0.3 * cdlin[..., 0] + 0.6 * cdlin[..., 1] + 0.1 * cdlin[..., 2]
    ctint = where3(cdlum > 0.0,
                   cdlin / torch.clamp(cdlum, min=1e-12)[..., None],
                   torch.ones_like(cdlin))
    one3 = torch.ones_like(cdlin)
    cspec0 = lerp(hd["specular"][..., None] * 0.08 *
                  lerp(one3, ctint, hd["specularTint"][..., None]),
                  cdlin, hd["metallic"][..., None])
    csheen = lerp(one3, ctint, hd["sheenTint"][..., None])

    fl = schlick_fresnel(n_dot_l)
    fv = schlick_fresnel(n_dot_v)
    fd90 = 0.5 + 2.0 * l_dot_h * l_dot_h * hd["roughness"]
    fd = lerp(1.0, fd90, fl) * lerp(1.0, fd90, fv)
    fss90 = l_dot_h * l_dot_h * hd["roughness"]
    fss = lerp(1.0, fss90, fl) * lerp(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(n_dot_l + n_dot_v, min=1e-12)
                        - 0.5) + 0.5)

    ax, ay = aniso_alphas(hd["roughness"], hd["anisotropic"])
    ds = gtr2_aniso(n_dot_h, dot(h, t), dot(h, b), ax, ay)
    fh = schlick_fresnel(l_dot_h)
    fs = lerp(cspec0, one3, fh[..., None])
    gs = (smith_g_ggx_aniso(n_dot_l, dot(l, t), dot(l, b), ax, ay) *
          smith_g_ggx_aniso(n_dot_v, dot(v, t), dot(v, b), ax, ay))
    fsheen = fh[..., None] * hd["sheen"][..., None] * csheen
    dr = gtr1(n_dot_h, lerp(0.1, 0.001, hd["clearcoatGloss"]))
    fr = lerp(0.04, 1.0, fh)
    gr = smith_g_ggx(n_dot_l, 0.25) * smith_g_ggx(n_dot_v, 0.25)

    brdf = (((1.0 / PIF) * lerp(fd, ss, hd["subsurface"])[..., None] * cdlin
             + fsheen)
            * (1.0 - hd["metallic"])[..., None]
            + (gs * ds)[..., None] * fs
            + (0.25 * hd["clearcoat"] * gr * fr * dr)[..., None])
    return where3(gate, brdf, torch.zeros_like(brdf))
