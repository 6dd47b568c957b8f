"""HDRI environment with its luminance CDF (host side, numpy).

The port's copy of ``elevenrender_tpu/scene/hdri.py``: the row-major
per-texel luminance CDF and the radiance sum the device samplers read,
and the host's solid-angle pdf and CDF inversion (``pdf``, ``sample``).
The default environment is a constant 0.5 grey.
"""

from __future__ import annotations

import numpy as np

from .texture import Texture


class HDRI:
    def __init__(self, texture: Texture | None = None):
        if texture is None:
            texture = Texture.from_color([0.5, 0.5, 0.5])
        self.texture = texture
        self.cdf: np.ndarray = np.zeros(1, np.float32)
        self.radiance_sum: float = 0.0
        self.generate_cdf()

    def generate_cdf(self) -> None:
        """cdf[i+1] = cdf[i] + (r+g+b)/radiance_sum in row-major texel
        order, cdf[0] = 0; an all-black env gives an all-zero CDF."""
        img = self.texture.data
        if img.shape[2] >= 3:
            lum = img[..., 0] + img[..., 1] + img[..., 2]
        else:
            lum = img[..., 0] * 3.0
        lum = lum.astype(np.float64).reshape(-1)
        self.radiance_sum = float(lum.sum())
        cdf = np.empty(lum.size + 1, np.float64)
        cdf[0] = 0.0
        np.cumsum(lum / max(self.radiance_sum, 1e-30), out=cdf[1:])
        self.cdf = cdf.astype(np.float32)

    def pdf(self, x: int, y: int) -> float:
        """Solid-angle pdf of texel (x, y): its luminance share over the
        sphere's 2 pi sin(theta) per texel row (the reference's
        HDRI.cpp:101-107)."""
        dv = self.texture.value_at(x, y)
        theta = (float(y) / float(self.texture.height)) * np.pi
        return (float(dv.sum()) / self.radiance_sum) * self.texture.width * \
            self.texture.height / (2.0 * np.pi * np.sin(theta))

    def sample(self, r1: float) -> tuple[int, int]:
        """Invert the CDF at ``r1`` -> texel (x, y), with the reference's
        binary search and its one-off quirk (``ops.hdri.binary_search_host``,
        the scalar twin of the device sampler)."""
        from ..ops.hdri import binary_search_host
        count = binary_search_host(self.cdf, r1,
                                   self.texture.width * self.texture.height)
        return count % self.texture.width, count // self.texture.width
