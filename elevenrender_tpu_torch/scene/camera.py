"""Physical camera model (host side): 35 mm focal length, 36x24 mm
sensor, thin-lens aperture/focus distance, XYZ Euler rotation in degrees.
The port's copy of ``elevenrender_tpu/scene/camera.py``."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Camera:
    focal_length: float = 35 * 0.001
    sensor_width: float = 36 * 0.001
    sensor_height: float = 24 * 0.001
    aperture: float = 2.8
    focus_distance: float = 1000000.0
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    bokeh: bool = False
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
