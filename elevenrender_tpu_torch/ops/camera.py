"""Primary rays for the whole pixel wavefront.

Port of ``elevenrender_tpu/ops/camera.py``: physical sensor model, XYZ
Euler rotation in degrees (X, then Y, then Z), AA jitter and the
thin-lens bokeh path.
"""

from __future__ import annotations

import torch

from ..core.vecmath import PIF, normalize, vec3
from .sampling import uniform_circle_sampling


def _rot_xyz(v, rotation_rad):
    rx = rotation_rad[..., 0]
    ry = rotation_rad[..., 1]
    rz = rotation_rad[..., 2]
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    y, z = (y * torch.cos(rx) - z * torch.sin(rx),
            y * torch.sin(rx) + z * torch.cos(rx))
    x, z = (x * torch.cos(ry) + z * torch.sin(ry),
            z * torch.cos(ry) - x * torch.sin(ry))
    x, y = (x * torch.cos(rz) - y * torch.sin(rz),
            x * torch.sin(rz) + y * torch.cos(rz))
    return torch.stack([x, y, z], dim=-1)


def camera_ray(cam: dict, x_res: int, y_res: int, x, y, r1, r2, r3, r4, r5):
    """cam: position [3], rotation [3] (degrees) and 0-d focal_length,
    sensor_width, sensor_height, aperture, focus_distance tensors, plus
    ``bokeh`` (a Python bool).  x, y: integer pixel coordinates;
    r1..r5: uniforms.  Returns (origin [..., 3], unit direction)."""
    pos = cam["position"]
    fx = x.to(torch.float32) / float(x_res)
    fy = y.to(torch.float32) / float(y_res)

    dx = pos[0] + fx * cam["sensor_width"]
    dy = pos[1] + fy * cam["sensor_height"]
    odx = (-cam["sensor_width"] / 2.0) + dx
    ody = (-cam["sensor_height"] / 2.0) + dy
    rx = (1.0 / x_res) * (r1 - 0.5) * cam["sensor_width"]
    ry = (1.0 / y_res) * (r2 - 0.5) * cam["sensor_height"]
    spx = odx + rx
    spy = ody + ry
    spz = pos[2] + cam["focal_length"]

    rot = cam["rotation"] * (PIF / 180.0)
    d = vec3(spx, spy, spz) - pos
    d = _rot_xyz(d, rot)
    origin = torch.broadcast_to(pos, d.shape)
    direction = normalize(d)

    if not cam["bokeh"]:
        return origin, direction

    diameter = cam["focal_length"] / cam["aperture"]
    l = cam["focus_distance"] + cam["focal_length"]
    focus_point = origin + direction * l
    ipx, ipy = uniform_circle_sampling(r3, r4, r5)
    ipx = ipx * diameter * 0.5
    ipy = ipy * diameter * 0.5
    ip = _rot_xyz(vec3(ipx, ipy, torch.zeros_like(ipx)), rot)
    new_origin = pos + ip
    new_dir = normalize(focus_point - new_origin)
    return new_origin, new_dir
