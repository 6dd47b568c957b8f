"""Disney BRDF: eval, pdf and sample on tensors.

Port of ``elevenrender_tpu/ops/disney.py`` (the knightcrawler25 Disney
BRDF of the reference renderer): diffuse, retro-reflection, Hanrahan-
Krueger subsurface, sheen, anisotropic GGX specular and clearcoat, gated
on transmission < 1 and both cosines positive.  Every branch is a
``torch.where``, and each expression keeps the JAX package's order.
The lanes that a gate discards evaluate the lobes at l = v = n
(``off_lanes_at_normal``): the same values, and no NaN in a gradient.
"""

from __future__ import annotations

import torch

from ..core.vecmath import PIF, dot, lerp, normalize, reflect, where3
from .sampling import cosine_sample_hemisphere, importance_sample_ggx


def schlick_fresnel(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def dielectric_fresnel(cos_theta_i, eta):
    """Unpolarised Fresnel reflectance of a dielectric; 1 under total
    internal reflection."""
    sin_theta_t_sq = eta * eta * (1.0 - cos_theta_i * cos_theta_i)
    cos_theta_t = torch.sqrt(torch.clamp(1.0 - sin_theta_t_sq, min=0.0))
    rs = (eta * cos_theta_t - cos_theta_i) / (eta * cos_theta_t + cos_theta_i)
    rp = (eta * cos_theta_i - cos_theta_t) / (eta * cos_theta_i + cos_theta_t)
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(sin_theta_t_sq > 1.0, torch.ones_like(f), f)


def gtr1(n_dot_h, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    val = (a2 - 1.0) / (PIF * torch.log(a2) * t)
    return torch.where(a >= 1.0, torch.full_like(val, 1.0 / PIF), val)


def gtr2(n_dot_h, a):
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    return a2 / (PIF * t * t)


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


def _aniso_alphas(roughness, anisotropic):
    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    ax = torch.clamp(roughness / aspect, min=0.001)
    ay = torch.clamp(roughness * aspect, min=0.001)
    return ax, ay


def off_lanes_at_normal(keep, n, *dirs):
    """``dirs`` with every lane outside ``keep`` set to the normal, where
    autograd records (as is, under ``torch.no_grad``).  A lane that a
    ``where`` discards still runs the lobes' backward, with a cotangent
    of 0: where l = -v there, h vanishes, a lobe is infinite, and 0 x inf
    is NaN in the gradients.  At l = v = n the discarded lanes' lobes are
    finite, and the kept lanes are computed bit for bit as before, so
    the values and every finite gradient stay the JAX package's."""
    if not torch.is_grad_enabled():
        return list(dirs)
    return [where3(keep, d, n) for d in dirs]


def disney_pdf(hd, v, n, l):
    """Mixture pdf of the sampling strategy; 1.0 below the horizon."""
    below = dot(n, l) <= 0.0
    l, v = off_lanes_at_normal(~below, n, l, v)
    h = normalize(l + v)
    t = hd["tangent"]
    b = hd["bitangent"]

    n_dot_h = torch.abs(dot(n, h))

    clearcoat_alpha = lerp(0.1, 0.001, hd["clearcoatGloss"])
    diffuse_ratio = 0.5 * (1.0 - hd["metallic"])
    specular_ratio = 1.0 - diffuse_ratio
    ax, ay = _aniso_alphas(hd["roughness"], hd["anisotropic"])

    pdf_gtr2 = gtr2_aniso(n_dot_h, dot(h, t), dot(h, b), ax, ay) * n_dot_h
    pdf_gtr1 = gtr1(n_dot_h, clearcoat_alpha) * n_dot_h
    ratio = 1.0 / (1.0 + hd["clearcoat"])
    pdf_spec = lerp(pdf_gtr1, pdf_gtr2, ratio) / (
        4.0 * torch.abs(dot(l, h)) + 1e-12)
    pdf_diff = torch.abs(dot(l, n)) * (1.0 / PIF)

    brdf_pdf = diffuse_ratio * pdf_diff + specular_ratio * pdf_spec
    return torch.where(below, torch.ones_like(brdf_pdf), brdf_pdf)


def disney_sample(hd, v, n, r1, r2, r3):
    """Cosine hemisphere vs GGX reflection, by diffuse ratio."""
    t = hd["tangent"]
    b = hd["bitangent"]
    diffuse_ratio = 0.5 * (1.0 - hd["metallic"])

    take_diffuse = r3 < diffuse_ratio

    hc = cosine_sample_hemisphere(r1, r2)
    dir_diffuse = t * hc[..., 0:1] + b * hc[..., 1:2] + n * hc[..., 2:3]

    hg = importance_sample_ggx(hd["roughness"], r1, r2)
    h = t * hg[..., 0:1] + b * hg[..., 1:2] + n * hg[..., 2:3]
    dir_spec = reflect(-v, h)

    return where3(take_diffuse, dir_diffuse, dir_spec)


def disney_eval(hd, v, n, l):
    """Full lobe sum -> [..., 3] reflectance; 0 outside the gate."""
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

    ax, ay = _aniso_alphas(hd["roughness"], hd["anisotropic"])
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
