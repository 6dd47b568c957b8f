"""The bytes of one whole-image readback over a pixel mesh, counted
here and not by the program: the least that the link has to carry.

The image's state lies in contiguous pixel slices, one a rank.  A
readback brings every pass (4 float32 a pixel) and the per-pixel sample
count (one int64) of the other ranks' slices to rank 0, so rank 0
receives (ranks - 1) / ranks of the image's bytes.  ``LINK_BYTES_PER_S``
is an H100 SXM's NVLink bandwidth in one direction, 450 GB/s, the
fastest link a card of such a host has, so no gather can move those
bytes faster."""

from __future__ import annotations

# Bytes a pixel of a pass (RGBA float32) and of the sample count (int64).
PASS_PIXEL_BYTES = 16
SAMPLE_PIXEL_BYTES = 8
LINK_BYTES_PER_S = 450e9


def gather_bytes(ranks: int, passes: int, pixels: int) -> int:
    """The bytes rank 0 receives in one whole-image readback."""
    if pixels % ranks:
        raise ValueError(f"{pixels} pixels do not split over {ranks} ranks")
    per_pixel = passes * PASS_PIXEL_BYTES + SAMPLE_PIXEL_BYTES
    return (ranks - 1) * (pixels // ranks) * per_pixel


def least_seconds(ranks: int, passes: int, pixels: int) -> float:
    """The least time of one readback's gather at the link's bandwidth."""
    return gather_bytes(ranks, passes, pixels) / LINK_BYTES_PER_S
