"""Python client for the render server (and any reference-compatible
server): speaks the 1024-byte-header wire protocol.  The port's copy of
``elevenrender_tpu/server/client.py``.

The reference has no client (its Blender plug-in is external); this is
the equivalent, for tests and as a user-facing API.
"""

from __future__ import annotations

import socket

import numpy as np

from .protocol import Message, read_message, write_message


class RenderClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 5557,
                 timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        ok = read_message(self.sock)  # handshake
        if ok.get_string_data() != "ok":
            self.sock.close()
            raise ConnectionError(
                f"no handshake from the server: {ok.get_string_data()!r}")

    def close(self) -> None:
        write_message(self.sock, Message.close_session())
        self.sock.close()

    # -- low level ---------------------------------------------------------
    def command(self, cmd: str) -> None:
        write_message(self.sock, Message.command(cmd))

    def recv(self) -> Message:
        return read_message(self.sock)

    def _expect_ok(self) -> None:
        msg = self.recv()
        if msg.get_string_data() != "ok":
            raise RuntimeError(f"expected ok, got {msg.get_string_data()!r}")

    # -- high level --------------------------------------------------------
    def load_config(self, x_res: int, y_res: int, sample_target: int,
                    denoise: bool = False, device: str = "",
                    block_size: int = 8, compat: bool = True) -> None:
        self.command("--load_config")
        write_message(self.sock, Message.json_msg({
            "x_res": x_res, "y_res": y_res, "sample_target": sample_target,
            "denoise": denoise, "device": device, "block_size": block_size,
            "compat": compat}))
        self._expect_ok()

    def load_camera(self, camera_json: dict) -> None:
        self.command("--load_camera")
        write_message(self.sock, Message.json_msg(camera_json))
        self._expect_ok()

    def load_object(self, obj_text: str, mtl_text: str = "",
                    recompute_normals: bool = False) -> None:
        cmd = "--load_object"
        if recompute_normals:
            cmd += " --recompute_normals"
        self.command(cmd)
        write_message(self.sock, Message("data", "string", obj_text.encode()))
        write_message(self.sock, Message("data", "string", mtl_text.encode()))
        self._expect_ok()

    def load_texture(self, name: str, data: np.ndarray,
                     color_space: str = "LINEAR") -> None:
        h, w, c = data.shape
        self.command("--load_texture")
        write_message(self.sock, Message.json_msg(
            {"name": name, "width": w, "height": h, "channels": c,
             "color_space": color_space}))
        write_message(self.sock, Message.float_data(data.reshape(-1)))
        self._expect_ok()

    def load_hdri(self, data: np.ndarray, mirror_x: bool = False,
                  mirror_y: bool = False) -> None:
        h, w, c = data.shape
        cmd = "--load_hdri"
        if mirror_x:
            cmd += " --mirror_x"
        if mirror_y:
            cmd += " --mirror_y"
        self.command(cmd)
        write_message(self.sock, Message.json_msg(
            {"name": "hdri", "width": w, "height": h, "channels": c,
             "color_space": "LINEAR"}))
        write_message(self.sock, Message.float_data(data.reshape(-1)))
        self._expect_ok()

    def load_brdf_material(self, mat_json: dict) -> None:
        self.command("--load_brdf_material")
        write_message(self.sock, Message.json_msg(mat_json))
        self._expect_ok()

    def load_point_light(self, position, radiance) -> None:
        """Protocol superset: the reference's point lights are dead code
        with no load command (kernel.cpp:269-301); here they feed live
        NEE in native mode."""
        self.command("--load_point_light")
        write_message(self.sock, Message.json_msg(
            {"position": list(map(float, position)),
             "radiance": list(map(float, radiance))}))
        self._expect_ok()

    def load_osl_material(self, material: str, shader: str,
                          slot: int | None = None) -> None:
        """Bind a NAMED shader from the server's registry to a material's
        albedo slot (render/shaders.NAMED_SHADERS) — the wire-reachable
        form of the reference's ASL albedoShaderID hook (shader.h:5-18,
        declared-but-unhandled at main.cpp:60)."""
        cmd = f"--load_osl_material --material {material} --shader {shader}"
        if slot is not None:
            cmd += f" --slot {slot}"
        self.command(cmd)
        self._expect_ok()

    def help(self) -> str:
        """Command vocabulary (the reference's --help, main.cpp:48-83)."""
        self.command("--help")
        return self.recv().get_string_data()

    def start(self) -> None:
        self.command("--start")
        self._expect_ok()

    def pause(self) -> None:
        """Stop rendering, keep progress; start() resumes."""
        self.command("--pause")
        self._expect_ok()

    def abort(self) -> None:
        """Stop rendering and discard progress."""
        self.command("--abort")
        self._expect_ok()

    def get_info(self) -> dict:
        self.command("--get_info")
        return self.recv().get_json_data()

    def get_device_info(self) -> dict:
        self.command("--get_sycl_info")
        return self.recv().get_json_data()

    def get_pass(self, name: str = "beauty") -> np.ndarray:
        self.command(f"--get_pass {name}")
        return self.recv().get_float_data()
