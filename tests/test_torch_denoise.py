"""PyTorch port, the denoiser: every stage against the JAX package's on
the same seeded inputs, to rtol 1e-5 / atol 1e-6 (XLA on the CPU
contracts a*b+c, the port rounds each op).

Shapes: 48x64 (one pyramid level below it is under 32 pixels), 40x40
(two levels) and 66x70 (three levels, the middle one 33x35: odd extents
through ``_down2``'s crop and ``_up2``'s edge pad).  Plus the two cases
the median must get right: an even count of lit values (where
``torch.nanmedian`` would return the lower middle value) and a frame with
no lit pixel (floor 0)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevenrender_tpu.render import denoise as jd
from elevenrender_tpu_torch.render import denoise as td

SHAPES = [(48, 64), (40, 40), (66, 70)]
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(h, w, seed=0):
    g = np.random.default_rng(seed)
    color = g.gamma(1.0, 0.5, (h, w, 3)).astype(np.float32)
    color[3, 5] = 50.0  # a firefly
    color[h // 2:, : w // 3] *= 0.01  # a dark corner
    normal = g.normal(size=(h, w, 3)).astype(np.float32)
    albedo = g.uniform(size=(h, w, 3)).astype(np.float32)
    return color, normal, albedo


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_despeckle_and_boxes_equal_jax(shape):
    c, _, _ = _inputs(*shape)
    _close(td._despeckle(torch.tensor(c)), jd._despeckle(jnp.asarray(c)))
    _close(td._box3(torch.tensor(c)), jd._box3(jnp.asarray(c)))
    _close(td._box3_edge(torch.tensor(c)), jd._box3_edge(jnp.asarray(c)))
    _close(td._down2(torch.tensor(c)), jd._down2(jnp.asarray(c)))
    small = c[: shape[0] // 2, : shape[1] // 2]
    _close(td._up2(torch.tensor(small), *shape),
           jd._up2(jnp.asarray(small), *shape))


@pytest.mark.parametrize("guides", ["none", "normal", "both"])
@pytest.mark.parametrize("fn", ["bilateral_denoise", "nlm_denoise",
                                "nlm_denoise_ms"])
@pytest.mark.parametrize("shape", SHAPES)
def test_filters_equal_jax(shape, fn, guides):
    c, n, a = _inputs(*shape)
    args = {"none": (c,), "normal": (c, n), "both": (c, n, a)}[guides]
    got = getattr(td, fn)(*map(torch.tensor, args))
    ref = getattr(jd, fn)(*map(jnp.asarray, args))
    assert got.shape == ref.shape and got.dtype == torch.float32
    _close(got, ref)


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_denoise_entry_equals_jax(shape, guided):
    """The flat float4 entry: alpha 1, the guided or colour-only filter."""
    h, w = shape
    c, n, a = _inputs(h, w)

    def flat4(x):
        return np.concatenate([x, np.full((h, w, 1), 0.5, np.float32)],
                              axis=-1).reshape(-1)

    args = (flat4(c), flat4(n), flat4(a)) if guided else (flat4(c),)
    got = td.denoise(w, h, *args)
    ref = jd.denoise(w, h, *args)
    assert got.shape == (h * w * 4,)
    assert bool((got[3::4] == 1.0).all())
    _close(got, ref)
    got_t = td.denoise(w, h, *map(torch.tensor, args))
    assert torch.equal(got_t, got)


def test_median_of_an_even_count_averages_the_middle_values():
    """Four lit pixels -> eight lit differences, an even count: the
    floor is the mean of the two middle values, as jnp.nanmedian gives,
    where torch.nanmedian gives the lower one."""
    d2s = torch.tensor([1.0, 2.0, 3.0, 4.0, float("nan"), 9.0])
    lit = torch.tensor([True, True, True, True, True, False])
    assert float(td._lit_median(d2s, lit)) == 2.5
    assert float(torch.nanmedian(d2s[lit])) == 2.0
    ref = jnp.nanmedian(jnp.where(jnp.asarray(lit.numpy()),
                                  jnp.asarray(d2s.numpy()), jnp.nan))
    assert float(ref) == 2.5
    assert float(td._lit_median(d2s[:3], lit[:3])) == 2.0

    h, w = 32, 32
    c = np.zeros((h, w, 3), np.float32)
    c[4:6, 10:12] = [0.8, 0.5, 0.2]  # 4 lit pixels
    c[20, 3] = [0.3, 0.3, 0.3]
    _close(td.nlm_denoise(torch.tensor(c)), jd.nlm_denoise(jnp.asarray(c)))


def test_all_dark_frame():
    """No lit pixel: the median of nothing is NaN in JAX and mapped to
    0; the port gives 0 directly, and both denoise to black."""
    c = np.zeros((40, 36, 3), np.float32)
    assert float(td._lit_median(torch.zeros(2, 40, 36, 1),
                                torch.zeros(2, 40, 36, 1, dtype=bool))) == 0
    got = td.nlm_denoise_ms(torch.tensor(c), torch.tensor(c),
                            torch.tensor(c))
    ref = jd.nlm_denoise_ms(jnp.asarray(c), jnp.asarray(c), jnp.asarray(c))
    _close(got, ref)
    assert float(got.abs().max()) == 0.0
