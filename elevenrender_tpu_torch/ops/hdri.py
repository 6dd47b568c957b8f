"""HDRI environment: host packing and device sampling.

Port of ``elevenrender_tpu/ops/hdri.py``.

Host (numpy): ``build_alias_table`` (Walker/Vose) and ``pack_hdri``.
Device, native mode: ``sample_env_alias``, ``sample_env_exact``,
``env_pdf_uv``, ``env_fetch_pdf_uv``, ``balance_heuristic``.
Device, compat mode (the reference's quirks): ``binary_search``,
``sample_env``, ``env_pdf``, ``env_fetch_uv``, ``env_radiance``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .texture import spherical_mapping


def build_alias_table(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Walker/Vose alias table for a discrete distribution p.

    Returns (prob [N] f32, alias [N] i32): with j = floor(u*N), the
    sample is j if the threshold draw < prob[j], else alias[j]."""
    p = np.asarray(p, np.float64)
    n = p.size
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int32)
    scaled = p * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = (scaled[l] + scaled[s]) - 1.0
        (small if scaled[l] < 1.0 else large).append(l)
    return prob.astype(np.float32), alias


def pack_hdri(hdri, alias_table: bool | None = None) -> dict:
    """Host HDRI -> dict of numpy arrays {img [H,W,3], cdf [H*W+1], rsum,
    + alias_prob/alias_idx [H*W]}.  ``alias_table``: True = build,
    False = skip, None = build when the env has at most 2^20 texels."""
    img = hdri.texture.data
    if img.shape[2] < 3:
        img = np.repeat(img[:, :, :1], 3, axis=2)
    img3 = img[:, :, :3].astype(np.float32)
    out = {
        "img": img3,
        "cdf": hdri.cdf.astype(np.float32),
        "rsum": np.float32(max(hdri.radiance_sum, 1e-30)),
    }
    n = img3.shape[0] * img3.shape[1]
    if alias_table is None:
        alias_table = n <= (1 << 20)
    if alias_table:
        lum = img3.sum(axis=2).reshape(-1).astype(np.float64)
        psum = lum.sum()
        p = lum / psum if psum > 0 else np.full(n, 1.0 / n)
        out["alias_prob"], out["alias_idx"] = build_alias_table(p)
    return out


# --------------------------------------------------------------------------
# Device samplers
# --------------------------------------------------------------------------

def binary_search_host(arr: np.ndarray, value: float, length: int) -> int:
    """The reference's binary search (HDRI.cpp:85-98) on one value: the
    host's scalar twin of ``binary_search``."""
    frm, to = 0, length - 1
    while to - frm > 0:
        m = frm + (to - frm) // 2
        if value == arr[m]:
            return m
        if value < arr[m]:
            to = m - 1
        if value > arr[m]:
            frm = m + 1
    return to


def binary_search(cdf, value, length: int):
    """The reference's binary search (it returns ``to``, one texel past
    the CDF step for most values), vectorized over ``value``."""
    iters = int(np.ceil(np.log2(max(length, 2)))) + 2
    frm = torch.zeros(value.shape, dtype=torch.int64, device=value.device)
    to = torch.full_like(frm, length - 1)
    for _ in range(iters):
        active = (to - frm) > 0
        m = frm + (to - frm) // 2
        vm = cdf[torch.clamp(m, 0, length - 1)]
        eq = value == vm
        lt = value < vm
        gt = value > vm
        new_to = torch.where(lt, m - 1, to)
        new_frm = torch.where(gt, m + 1, frm)
        new_frm = torch.where(eq, m, new_frm)
        new_to = torch.where(eq, m, new_to)
        frm = torch.where(active, new_frm, frm)
        to = torch.where(active, new_to, to)
    return to


def sample_env(env, r1):
    """Compat CDF inversion -> (x, y) texel, with the one-off quirk."""
    H, W, _ = env["img"].shape
    count = binary_search(env["cdf"], r1, H * W)
    return count % W, count // W


def sample_env_exact(env, r1):
    """Texel i iff cdf[i] <= r < cdf[i+1]."""
    H, W, _ = env["img"].shape
    count = torch.clamp(
        torch.searchsorted(env["cdf"], r1, right=True) - 1, 0, H * W - 1)
    return count % W, count // W


def sample_env_alias(env, r1, r2):
    """O(1) alias-table texel pick: r1 picks the bucket, the dedicated
    draw r2 decides bucket vs alias."""
    H, W, _ = env["img"].shape
    n = H * W
    j = torch.clamp((torch.clamp(r1, 0.0, 1.0 - 1e-7) * n).to(torch.int64),
                    0, n - 1)
    take_alias = r2 >= env["alias_prob"][j]
    count = torch.where(take_alias, env["alias_idx"][j], j)
    return count % W, count // W


def env_pdf(env, x, y, center: bool = False):
    """Compat solid-angle pdf of texel (x, y): corner theta and a
    2*pi*sin(theta) denominator, as the reference writes it; ``center``
    gives the texel-centre theta and the true 2*pi^2 normalization."""
    H, W, _ = env["img"].shape
    val = env["img"][torch.clamp(y, 0, H - 1), torch.clamp(x, 0, W - 1)]
    yf = y.to(torch.float32) + (0.5 if center else 0.0)
    theta = (yf / float(H)) * math.pi
    lum = val[..., 0] + val[..., 1] + val[..., 2]
    denom = (2.0 * math.pi * math.pi) if center else (2.0 * math.pi)
    return (lum / env["rsum"]) * W * H / (denom * torch.sin(theta))


def _texel(env, u, v):
    H, W, _ = env["img"].shape
    x = torch.clamp(torch.trunc(u * W).to(torch.int64), 0, W - 1)
    y = torch.clamp(torch.trunc(v * H).to(torch.int64), 0, H - 1)
    return env["img"][y, x]


def env_pdf_uv(env, u, v):
    """Exact solid-angle pdf of the native jittered sampler at (u, v)."""
    H, W, _ = env["img"].shape
    val = _texel(env, u, v)
    lum = val[..., 0] + val[..., 1] + val[..., 2]
    sin_t = torch.clamp(torch.sin(v * math.pi), min=1e-8)
    return (lum / env["rsum"]) * W * H / (2.0 * math.pi * math.pi * sin_t)


def env_fetch_pdf_uv(env, u, v):
    """One texel fetch serving both the radiance and the native pdf.
    Returns (rgb [..., 3], pdf [...])."""
    H, W, _ = env["img"].shape
    val = _texel(env, u, v)
    lum = val[..., 0] + val[..., 1] + val[..., 2]
    sin_t = torch.clamp(torch.sin(v * math.pi), min=1e-8)
    pdf = (lum / env["rsum"]) * W * H / (2.0 * math.pi * math.pi * sin_t)
    return val, pdf


def balance_heuristic(a, b):
    """a/(a+b), robust to a or b being 0 or inf (not both inf)."""
    ratio = b / torch.clamp(a, min=1e-12)
    return torch.where(a > 0.0, 1.0 / (1.0 + ratio), torch.zeros_like(ratio))


def env_fetch_uv(env, u, v):
    """Nearest truncating fetch with the C-style wrap and abs."""
    H, W, _ = env["img"].shape
    x = torch.trunc(u * W).to(torch.int64)
    y = torch.trunc(v * H).to(torch.int64)
    x = torch.abs(x) % W
    y = torch.abs(y) % H
    return env["img"][y, x]


def env_radiance(env, direction):
    """Environment radiance on a ray miss (compat)."""
    u, v = spherical_mapping(-direction)
    return env_fetch_uv(env, u, v)
