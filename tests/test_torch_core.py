"""PyTorch port, core: the RNG streams and vector math against the JAX
package, on the same numpy inputs.  RNG results must be bit-exact."""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from elevenrender_tpu.core import rng as jrng
from elevenrender_tpu.core import vecmath as jvm
from elevenrender_tpu_torch.core import rng as trng
from elevenrender_tpu_torch.core import vecmath as tvm


def _seeds():
    """4096 uint32 seeds from a fixed numpy stream, with the edges."""
    s = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    s[:4] = [0, 1, 2**31, 2**32 - 1]
    return s.astype(np.uint32)


def _t(a):
    return torch.tensor(a.astype(np.int64))


def test_jenkins_hash_bit_exact():
    s = _seeds()
    want = np.asarray(jrng.jenkins_hash(jnp.asarray(s))).astype(np.int64)
    np.testing.assert_array_equal(trng.jenkins_hash(_t(s)).numpy(), want)


def test_init_state_bit_exact():
    s = _seeds()
    want = np.asarray(jrng.init_state(jnp.asarray(s))).astype(np.int64)
    np.testing.assert_array_equal(trng.init_state(_t(s)).numpy(), want)


def test_next_state_and_float_bit_exact_over_steps():
    s = _seeds()
    js, ts = jnp.asarray(s), _t(s)
    for _ in range(6):
        js, jf = jrng.next_float(js)
        ts, tf = trng.next_float(ts)
        np.testing.assert_array_equal(ts.numpy(),
                                      np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_to_float_divides_by_float32_uint_max():
    """float32(4294967295.0) rounds to 2^32, so the top state maps to
    exactly 1.0 in both packages."""
    s = _seeds()
    np.testing.assert_array_equal(trng.to_float(_t(s)).numpy(),
                                  np.asarray(jrng.to_float(jnp.asarray(s))))
    assert float(trng.to_float(torch.tensor([2**32 - 1]))[0]) == 1.0


def test_next_float_masked_bit_exact():
    s = _seeds()
    mask = np.random.default_rng(1).uniform(size=s.shape) < 0.5
    js, jf = jrng.next_float_masked(jnp.asarray(s), jnp.asarray(mask))
    ts, tf = trng.next_float_masked(_t(s), torch.tensor(mask))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # Masked-off lanes keep their state.
    np.testing.assert_array_equal(ts.numpy()[~mask],
                                  s.astype(np.int64)[~mask])


@pytest.mark.parametrize("fn", ["normalize", "cross", "dot", "reflect"])
def test_vecmath_matches_jax(fn):
    rng = np.random.default_rng(2)
    a = rng.normal(size=(257, 3)).astype(np.float32)
    b = rng.normal(size=(257, 3)).astype(np.float32)
    a[0] = 0.0  # the normalize guard
    if fn == "normalize":
        got, want = tvm.normalize(torch.tensor(a)), jvm.normalize(a)
    elif fn == "cross":
        got, want = tvm.cross(torch.tensor(a), torch.tensor(b)), jvm.cross(a, b)
    elif fn == "dot":
        got, want = tvm.dot(torch.tensor(a), torch.tensor(b)), jvm.dot(a, b)
    else:
        got = tvm.reflect(torch.tensor(a), torch.tensor(b))
        want = jvm.reflect(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", ["clampf", "mapf"])
def test_clampf_and_mapf_match_jax(fn):
    rng = np.random.default_rng(6)
    a = rng.normal(0, 2, 513).astype(np.float32)
    a[:3] = [np.nan, np.inf, -np.inf]
    if fn == "clampf":
        got = tvm.clampf(torch.tensor(a), -1.0, 0.5).numpy()
        want = np.asarray(jvm.clampf(jnp.asarray(a), -1.0, 0.5))
        assert tvm.clampf(3.0, 0.0, 1.0).item() == 1.0
    else:
        args = (-2.0, 3.0, 10.0, -4.0)
        got = tvm.mapf(torch.tensor(a), *args).numpy()
        want = np.asarray(jvm.mapf(jnp.asarray(a), *args))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_native_uniform_shape_range_and_generator():
    """No bit parity with the JAX package's threefry draw (neither
    promises one): float32 of the asked shape in [0, 1) on the
    generator's device, the same numbers from the same seed, and a
    stream that moves on."""
    g = torch.Generator().manual_seed(7)
    a = trng.native_uniform(g, (64, 33))
    b = trng.native_uniform(g, (64, 33))
    assert a.shape == (64, 33) and a.dtype == torch.float32
    assert a.device == g.device
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    assert not torch.equal(a, b)
    again = torch.Generator().manual_seed(7)
    assert torch.equal(trng.native_uniform(again, (64, 33)), a)
    assert abs(float(torch.cat([a, b]).mean()) - 0.5) < 0.02
