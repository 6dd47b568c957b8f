"""Ray reordering for coherent traversal.

Port of ``morton_key``, ``counting_order`` and ``sort_for_packets`` from
``elevenrender_tpu/ops/sort.py``.  A sort key is a 30-bit Morton code of
the scene-normalized origin combined with a direction class; keys are
bit-identical to the JAX package's uint32 keys but held as int64 in
[0, 2^32), because torch's uint32 arithmetic is partial.  Neighbouring
threads of the CUDA traversal then walk neighbouring rays, the GPU
counterpart of the TPU's spatially compact packets.
"""

from __future__ import annotations

import torch

DEAD_KEY = 0xFFFFFFFF


def _expand_bits10(v):
    """Spread 10 bits to every third position (Morton dilation)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_key(origin, direction, bounds_min, bounds_max,
               dir_major: bool = False, dir_bits: int = 3):
    """Morton code of the origin plus a direction class, as int64.

    ``dir_major=False``: ``morton << 3 | octant``.  ``dir_major=True``:
    the direction class in the top bits; ``dir_bits > 3`` uses an
    equirectangular direction grid of that many bits instead of the
    eight sign octants."""
    ext = torch.clamp(bounds_max - bounds_min, min=1e-12)
    q = torch.clamp((origin - bounds_min) / ext, 0.0, 1.0)
    qi = (q * 1023.0).to(torch.int64)
    code = (_expand_bits10(qi[..., 0])
            | (_expand_bits10(qi[..., 1]) << 1)
            | (_expand_bits10(qi[..., 2]) << 2))
    if dir_major and dir_bits > 3:
        from .texture import spherical_mapping
        bu = (dir_bits + 1) // 2
        bv = dir_bits - bu
        u, v = spherical_mapping(direction)
        ui = torch.clamp((u * (1 << bu)).to(torch.int64), 0, (1 << bu) - 1)
        vi = torch.clamp((v * (1 << bv)).to(torch.int64), 0, (1 << bv) - 1)
        dclass = (ui << bv) | vi
        return (((dclass << (32 - dir_bits)) & 0xFFFFFFFF)
                | (code >> (dir_bits - 2)))
    octant = ((direction[..., 0] > 0).to(torch.int64)
              | ((direction[..., 1] > 0).to(torch.int64) << 1)
              | ((direction[..., 2] > 0).to(torch.int64) << 2))
    if dir_major:
        return ((octant << 30) & 0xFFFFFFFF) | code
    return ((code << 3) & 0xFFFFFFFF) | octant


SORT_IMPLS = ("argsort", "counting")


def _inverse_of(order):
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(order.shape[0], device=order.device)
    return inverse


def counting_order(key, bits: int = 8, chunk: int = 2048):
    """Stable sort of the keys (int64 in [0, 2^32)) by their top ``bits``
    bits alone: 2^bits buckets, and inside a bucket the order the rays
    came in, so the grouping refines from bounce to bounce.

    Returns (order, inverse): ``key[order]`` is bucket-sorted and
    ``inverse[order[i]] = i``, integer for integer the JAX package's
    ``counting_order``.  That one ranks by one-hot prefix sums over chunks
    of ``chunk`` keys, its answer to a machine without a fast sort; here a
    stable sort of the bucket ids gives the same permutation, and
    ``chunk`` is taken for call parity and changes nothing."""
    del chunk
    bucket = key >> (32 - bits)
    order = torch.sort(bucket, stable=True).indices
    return order, _inverse_of(order)


def sort_for_packets(origin, direction, bounds_min, bounds_max, mask=None,
                     dir_major: bool = False, impl: str = "argsort",
                     dir_bits: int = 3):
    """(order, inverse): ``origin[order]`` is coherent; ``x[inverse]``
    scatters results back.  Lanes outside ``mask`` get the largest key,
    so they pack at the tail.  ``impl``: "argsort", a full sort of the
    keys, stable as ``jnp.argsort`` is, or "counting", the stable bucket
    sort ``counting_order``; either order equals the JAX package's."""
    if impl not in SORT_IMPLS:
        raise ValueError(f"sort_impl {impl!r}: expected one of {SORT_IMPLS}")
    key = morton_key(origin, direction, bounds_min, bounds_max,
                     dir_major=dir_major, dir_bits=dir_bits)
    if mask is not None:
        key = torch.where(mask, key, torch.full_like(key, DEAD_KEY))
    if impl == "counting":
        return counting_order(key)
    order = torch.sort(key, stable=True).indices
    return order, _inverse_of(order)
