"""Host-side texture: a float image as a [height, width, channels] array.

The port's copy of ``elevenrender_tpu/scene/texture.py``, cut to what the
forward slice reads: the image data (the HDRI's, here) and its filter.
Texture files and atlas sampling come with the textured slice.
"""

from __future__ import annotations

import numpy as np


class Texture:
    FILTER_NONE = 0
    FILTER_BILINEAR = 1

    def __init__(self, name: str = "", data: np.ndarray | None = None,
                 filter: int = FILTER_NONE):
        if data is None:
            data = np.zeros((1, 1, 1), np.float32)
        if np.ndim(data) != 3:
            raise ValueError(f"texture data must be [height, width, "
                             f"channels], got shape {np.shape(data)}")
        self.name = name
        self.data = np.ascontiguousarray(data, np.float32)
        self.filter = filter

    @staticmethod
    def from_color(color) -> "Texture":
        """1x1 constant-color texture."""
        return Texture("", np.asarray(color, np.float32).reshape(1, 1, 3))

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def channels(self) -> int:
        return self.data.shape[2]
