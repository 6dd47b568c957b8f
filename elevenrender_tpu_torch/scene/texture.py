"""Host-side texture: a float image as a [height, width, channels] array.

The port's copy of ``elevenrender_tpu/scene/texture.py``: construction
from raw float data (with sRGB to linear) or a constant colour, the
host-side image ops (mirror, channel clamp, circular pixel shift, gamma)
and ``value_at``; ``from_file`` reads PNG, HDR, BMP, TGA and JPEG
through ``utils/image.py``.  Device sampling over the packed atlas is
``ops/texture.py``.
"""

from __future__ import annotations

import numpy as np


def srgb_to_linear(s: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF (the reference's fast_pow version of the same
    curve is not reproduced)."""
    s = s.astype(np.float32)
    return np.where(s <= 0.04045, s / 12.92,
                    ((s + 0.055) / 1.055) ** 2.4).astype(np.float32)


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
    def from_raw(name: str, width: int, height: int, channels: int,
                 data: np.ndarray, filter: int = FILTER_NONE,
                 srgb: bool = False) -> "Texture":
        """Texture from a raw row-major float buffer; sRGB data is
        linearized."""
        arr = np.asarray(data, np.float32).reshape(height, width, channels)
        if srgb:
            arr = srgb_to_linear(arr)
        return Texture(name, arr, filter)

    @staticmethod
    def from_color(color) -> "Texture":
        """1x1 constant-color texture."""
        return Texture("", np.asarray(color, np.float32).reshape(1, 1, 3))

    @staticmethod
    def from_file(path: str, srgb: bool = True,
                  filter: int = FILTER_NONE) -> "Texture":
        """An image file, flipped vertically and, when sRGB, raised to
        the power 2.2 (stb's load flip and ldr-to-hdr gamma, as the
        reference loads textures)."""
        from ..utils.image import read_image
        arr = read_image(path)[::-1]
        if srgb:
            arr = arr ** 2.2
        return Texture(path, np.ascontiguousarray(arr, np.float32), filter)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def channels(self) -> int:
        return self.data.shape[2]

    def mirror_x(self) -> None:
        self.data = np.ascontiguousarray(self.data[:, ::-1])

    def mirror_y(self) -> None:
        self.data = np.ascontiguousarray(self.data[::-1])

    def clamp_channels(self) -> None:
        """Drop channels beyond RGB."""
        if self.channels > 3:
            self.data = np.ascontiguousarray(self.data[:, :, :3])

    def pixel_shift(self, x_amount: float, y_amount: float) -> None:
        """Circular shift by a fraction of width/height."""
        sx = int(self.width * x_amount)
        sy = int(self.height * y_amount)
        self.data = np.ascontiguousarray(
            np.roll(self.data, shift=(sy, sx), axis=(0, 1)))

    def apply_gamma(self, gamma: float) -> None:
        """data ** gamma with exact pow.  A documented deviation from the
        reference, whose fast_pow returns 0 for every input (see the JAX
        package's ``Texture.apply_gamma``): gamma'd textures render as
        the reference intends, not as its binary would."""
        self.data = np.power(self.data, gamma).astype(np.float32)

    def value_at(self, x: int, y: int) -> np.ndarray:
        """Host-side texel fetch with the device wrap (C ``%`` then
        absolute value); returns a 3-vector, grey-broadcast for one
        channel."""
        w, h, c = self.width, self.height, self.channels
        x = abs(int(np.fmod(x, w)))
        y = abs(int(np.fmod(y, h)))
        px = np.zeros(3, np.float32)
        px[:min(c, 3)] = self.data[y, x, :min(c, 3)]
        if c == 1:
            px[:] = self.data[y, x, 0]
        return px
