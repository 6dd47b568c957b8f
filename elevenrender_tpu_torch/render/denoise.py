"""The denoiser, as PyTorch ops: the port of
``elevenrender_tpu/render/denoise.py``.

The reference runs Intel OIDN's "RT" filter over the beauty pass,
colour only.  The JAX package replaces it with filters made of shifts
and elementwise math, and so does this port, op for op:

- ``denoise`` with guides (normal and first-hit albedo) runs the
  multi-scale, noise-compensated non-local means ``nlm_denoise_ms``;
  without, the colour-only cross-bilateral ``bilateral_denoise``.
- Both clamp fireflies first (``_despeckle``): a patch filter keeps an
  outlier, which matches none of its neighbours.
- ``nlm_denoise``'s noise floor is the median of the unit-offset squared
  log-luminance differences over lit pixels.  jnp.nanmedian averages
  the two middle values of an even count, where ``torch.nanmedian``
  returns the lower one, and ``torch.nanquantile`` takes at most 2^24
  values; so ``_lit_median`` sorts and picks the middle itself.  A
  frame with no lit pixel has floor 0.

On a card ``denoise`` replays a CUDA graph, the counterpart of the JAX
package's jitted filters: one capture per (device, guides given) at the
last shape denoised with them, made at the first call at that shape
after that call's eager run, with the tap weights
(host floats) as constants of the capture.  Its inputs are copied into
the graph's buffers and its result comes back as a fresh tensor; the
filters make no host sync, so the capture holds every kernel.

Taps are ``torch.roll`` (wrapping, as ``jnp.roll``), the pyramid's box
is edge-padded.  Every function takes and returns [H, W, C] float32
tensors on any device; XLA on the CPU contracts a*b+c where PyTorch
rounds each op, so the two packages agree to a tolerance, not bit for
bit.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.device import CapturedCall


def _roll(x, dy: int, dx: int):
    return torch.roll(x, shifts=(dy, dx), dims=(0, 1))


def _tap_weight(d2: float, sigma: float) -> float:
    """exp(-d2 / (2 sigma^2)) of a static tap offset, rounded to float32
    as the JAX package computes it (a float32 exp of a float32
    argument)."""
    return float(np.exp(np.float32(-d2 / (2.0 * sigma * sigma))))


def _guide_weight(wgt, guide, dy: int, dx: int, sigma: float):
    if guide is None:
        return wgt
    diff = ((_roll(guide, dy, dx) - guide) ** 2).sum(dim=-1, keepdim=True)
    return wgt * torch.exp(-diff / (2.0 * sigma * sigma))


def _despeckle(color, k: float = 2.5):
    """Clamp each pixel to k times its 8-neighbourhood mean, per
    channel."""
    acc = torch.zeros_like(color)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            acc = acc + _roll(color, dy, dx)
    neigh = acc / 8.0
    return torch.minimum(color, neigh * k + 1e-4)


def _log_lum(color):
    return torch.log1p(color.amax(dim=-1, keepdim=True))


def bilateral_denoise(color, normal=None, albedo=None, radius: int = 3,
                      sigma_s: float = 2.0, sigma_c: float = 0.35,
                      sigma_n: float = 0.3, sigma_a: float = 0.15):
    """Cross-bilateral over (2 radius + 1)^2 rolled taps.  color [H, W, 3]
    HDR; normal / albedo optional [H, W, 3] guides.  Returns [H, W, 3]."""
    h, w, _ = color.shape
    color = _despeckle(color)
    acc = torch.zeros_like(color)
    wacc = torch.zeros((h, w, 1), dtype=color.dtype, device=color.device)
    log_lum = _log_lum(color)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            ws = _tap_weight(dx * dx + dy * dy, sigma_s)
            s_lum = _roll(log_lum, dy, dx)
            wc = torch.exp(-torch.square(s_lum - log_lum)
                           / (2.0 * sigma_c * sigma_c))
            wgt = _guide_weight(wc * ws, normal, dy, dx, sigma_n)
            wgt = _guide_weight(wgt, albedo, dy, dx, sigma_a)
            acc = acc + _roll(color, dy, dx) * wgt
            wacc = wacc + wgt
    return acc / torch.clamp(wacc, min=1e-8)


def _box3(x):
    """3x3 box filter by separable rolls (wrapping)."""
    s = x + torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
    return (s + torch.roll(s, 1, 1) + torch.roll(s, -1, 1)) / 9.0


def _lit_median(d2s, lit):
    """Median of ``d2s`` over the lanes where ``lit`` holds and the value
    is not NaN, the two middle values averaged for an even count (as
    jnp.nanmedian); 0 where no lane qualifies.  A 0-d tensor, computed
    on the device without a host sync."""
    keep = lit & ~torch.isnan(d2s)
    vals = torch.where(keep, d2s, torch.full_like(d2s, float("inf")))
    srt = torch.sort(vals.reshape(-1)).values
    n = keep.sum().reshape(1)
    # gather, not srt[n]: a 0-d tensor index is read on the host.
    lo = srt.gather(0, torch.div(torch.clamp(n - 1, min=0), 2,
                                 rounding_mode="floor"))
    hi = srt.gather(0, torch.clamp(torch.div(n, 2, rounding_mode="floor"),
                                   max=srt.numel() - 1))
    return torch.where(n > 0, (lo + hi) * 0.5, torch.zeros_like(lo))[0]


def nlm_denoise(color, normal=None, albedo=None, radius: int = 4,
                sigma_s: float = 3.0, sigma_p: float = 0.22,
                sigma_n: float = 0.25, sigma_a: float = 0.15):
    """Guided, noise-compensated non-local means.  color [H, W, 3] HDR
    beauty; normal / albedo optional [H, W, 3] first-hit guides.
    Returns [H, W, 3].

    Patch distance is the 3x3 box of the squared log-luminance
    difference, less the noise floor ``var2`` (the median unit-offset
    squared difference over lit pixels, an estimate of 2 sigma^2 of the
    noise); the bandwidth grows with the same floor, so smoothing tracks
    the sample count."""
    irr = _despeckle(color)
    log_lum = _log_lum(irr)
    d2u = torch.square(torch.roll(log_lum, 1, 0) - log_lum)
    d2l = torch.square(torch.roll(log_lum, 1, 1) - log_lum)
    lit = log_lum > 0.02
    var2 = _lit_median(torch.stack([d2u, d2l]), torch.stack([lit, lit]))
    h2 = torch.clamp(1.5 * var2, min=2.0 * sigma_p * sigma_p)

    acc = torch.zeros_like(irr)
    wacc = torch.zeros(irr.shape[:2] + (1,), dtype=irr.dtype,
                       device=irr.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            ws = _tap_weight(dx * dx + dy * dy, sigma_s)
            d2 = torch.square(_roll(log_lum, dy, dx) - log_lum)
            pd = torch.clamp(_box3(d2) - var2, min=0.0)
            wgt = torch.exp(-pd / h2) * ws
            wgt = _guide_weight(wgt, normal, dy, dx, sigma_n)
            wgt = _guide_weight(wgt, albedo, dy, dx, sigma_a)
            acc = acc + _roll(irr, dy, dx) * wgt
            wacc = wacc + wgt
    return acc / torch.clamp(wacc, min=1e-8)


def _down2(x):
    """2x2 average pool of the even-cropped image."""
    h2, w2 = (x.shape[0] // 2) * 2, (x.shape[1] // 2) * 2
    x = x[:h2, :w2]
    return (x[0::2, 0::2] + x[1::2, 0::2]
            + x[0::2, 1::2] + x[1::2, 1::2]) * 0.25


def _box3_edge(x):
    """3x3 box with edge padding: the pyramid's band is added unweighted,
    so it must not wrap between opposite borders."""
    p = torch.cat([x[:1], x, x[-1:]], dim=0)
    p = torch.cat([p[:, :1], p, p[:, -1:]], dim=1)
    s = p[:-2] + p[1:-1] + p[2:]
    return (s[:, :-2] + s[:, 1:-1] + s[:, 2:]) / 9.0


def _up2(x, h: int, w: int):
    """2x nearest upsample, edge-padded or cropped to (h, w), then the
    edge-padded 3x3 box."""
    hx, wx, c = x.shape
    r = x[:, None, :, None].expand(hx, 2, wx, 2, c).reshape(2 * hx, 2 * wx, c)
    if r.shape[0] < h:
        r = torch.cat([r, r[-1:]], dim=0)
    if r.shape[1] < w:
        r = torch.cat([r, r[:, -1:]], dim=1)
    return _box3_edge(r[:h, :w])


def nlm_denoise_ms(color, normal=None, albedo=None, levels: int = 3,
                   radius: int = 4):
    """Multi-scale guided NL-means: R_L = D_L; R_l = D_l + up(R_{l+1} -
    down(D_l)).  The finest level keeps its own detail and takes the
    smoothed low band of the coarser ones; the recursion stops below 32
    pixels on the short side."""
    h, w = color.shape[0], color.shape[1]
    dn = nlm_denoise(color, normal, albedo, radius=radius)
    if levels <= 1 or min(h, w) < 32:
        return dn
    c1 = _down2(color)
    n1 = None if normal is None else _down2(normal)
    a1 = None if albedo is None else _down2(albedo)
    r1 = nlm_denoise_ms(c1, n1, a1, levels=levels - 1, radius=radius)
    return dn + _up2(r1 - _down2(dn), h, w)


def denoise(width: int, height: int, raw, normal=None, albedo=None):
    """Flat float4 [H*W*4] in (a tensor or a numpy array), flat float4
    [H*W*4] tensor out on the input's device, alpha 1.  With a guide the
    multi-scale guided NL-means, without the colour-only
    cross-bilateral.  On a card, by replay of the shape's captured graph
    (the module's note)."""
    raw = torch.as_tensor(raw)
    if not raw.is_cuda:
        return denoise_ops(width, height, raw, normal, albedo)
    inputs = {"raw": raw.reshape(-1)}
    for name, x in (("normal", normal), ("albedo", albedo)):
        if x is not None:
            inputs[name] = torch.as_tensor(x, device=raw.device).reshape(-1)
    key = (raw.device, normal is not None, albedo is not None)
    with _graphs_lock:
        shape, call = _graphs.get(key, (None, None))
        if shape != (height, width):
            call = CapturedCall(raw.device, "denoise")
            _graphs[key] = ((height, width), call)

    def run(st):
        return denoise_ops(width, height, st["raw"], st.get("normal"),
                           st.get("albedo"))

    with call.turn():
        call.load(inputs)
        if call.graph is None:
            res = call.warm_up(run)
            call.capture(run)
            return res
        return call.replay().clone()


# (device, normal given, albedo given) -> ((H, W), CapturedCall): the
# last shape denoised with those guides.  A call at another shape
# captures anew and drops the old graph and its pool, so the cache holds
# at most one pool per set of guides, whatever sizes a session reads.
_graphs: dict = {}
_graphs_lock = threading.Lock()


def denoise_ops(width: int, height: int, raw, normal=None, albedo=None):
    """``denoise`` op by op, on any device: what the graph captures."""
    img = torch.as_tensor(raw).reshape(height, width, 4)

    def guide(x):
        return (None if x is None else
                torch.as_tensor(x, device=img.device)
                .reshape(height, width, 4)[:, :, :3])

    with torch.no_grad():
        if normal is not None or albedo is not None:
            out = nlm_denoise_ms(img[:, :, :3], guide(normal), guide(albedo))
        else:
            out = bilateral_denoise(img[:, :, :3])
        res = torch.cat([out, torch.ones((height, width, 1),
                                         dtype=out.dtype,
                                         device=out.device)], dim=-1)
    return res.reshape(-1)
