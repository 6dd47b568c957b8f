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

    @staticmethod
    def from_json(obj: dict) -> "Camera":
        """The wire JSON: every field required, position and rotation as
        {"x", "y", "z"} (the reference's parse_camerajson)."""
        pos = obj["position"]
        rot = obj["rotation"]
        return Camera(
            focal_length=float(obj["focal_length"]),
            sensor_width=float(obj["sensor_width"]),
            sensor_height=float(obj["sensor_height"]),
            aperture=float(obj["aperture"]),
            focus_distance=float(obj["focus_distance"]),
            bokeh=bool(obj["bokeh"]),
            position=np.array([pos["x"], pos["y"], pos["z"]], np.float32),
            rotation=np.array([rot["x"], rot["y"], rot["z"]], np.float32),
        )
