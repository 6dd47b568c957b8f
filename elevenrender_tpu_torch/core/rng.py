"""Per-pixel xorshift32 streams seeded by a Jenkins hash.

Port of ``elevenrender_tpu/core/rng.py``: the same generator bit for bit
(the reference renderer's kernel.cpp:25-47), and ``native_uniform``, a
decorrelated generator for native mode that makes no parity promise.
torch's uint32 arithmetic is partial, so the state is carried as int64
holding a value in [0, 2^32): every left shift is masked back to 32
bits.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# float32(4294967295.0): the JAX package's divisor, which rounds up to
# 2^32 in float32.  A power of two, so the quotient is exact whether the
# division runs in float32 or double, or (a CUDA tensor over a Python
# scalar) as a product with the reciprocal.
_UINT_MAX_F32 = 4294967296.0


def jenkins_hash(seed: torch.Tensor) -> torch.Tensor:
    """Jenkins one-at-a-time over the 4 LSB-first bytes of a uint32."""
    seed = seed.to(torch.int64) & MASK32
    h = torch.zeros_like(seed)
    for i in range(4):
        h = (h + ((seed >> (i * 8)) & 0xFF)) & MASK32
        h = (h + (h << 10)) & MASK32
        h = h ^ (h >> 6)
    h = (h + (h << 3)) & MASK32
    h = h ^ (h >> 11)
    h = (h + (h << 15)) & MASK32
    return h


def init_state(pixel_idx: torch.Tensor) -> torch.Tensor:
    """Seed = jenkins(pixel + 1), with the uint32 wrap of the addition."""
    return jenkins_hash((pixel_idx.to(torch.int64) + 1) & MASK32)


def next_state(state: torch.Tensor) -> torch.Tensor:
    """One xorshift32 step."""
    state = state ^ ((state << 13) & MASK32)
    state = state ^ (state >> 17)
    state = state ^ ((state << 5) & MASK32)
    return state


def to_float(state: torch.Tensor) -> torch.Tensor:
    """float32(state) / float32(4294967295.0), as the JAX package divides.
    The divisor is a Python float: a tensor built here would be a
    host-to-device copy per draw, and on a card a stream sync."""
    return state.to(torch.float32) / _UINT_MAX_F32


def next_float(state: torch.Tensor):
    state = next_state(state)
    return state, to_float(state)


def next_float_masked(state: torch.Tensor, mask: torch.Tensor):
    """Advance only the lanes where ``mask`` holds; the value is drawn
    from the advanced state on every lane (callers ignore masked-off
    lanes)."""
    new = next_state(state)
    return torch.where(mask, new, state), to_float(new)


def native_uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform float32 in [0, 1) of ``shape`` from an explicit
    ``torch.Generator``, on the generator's device.  The JAX package
    draws these from a threefry key: the two give other numbers, as they
    promise no bit parity."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)
