"""Command layer: argv-style command parsing, session state, dispatch.

Port of ``elevenrender_tpu/server/commands.py`` (the reference's
main.cpp:36-187 and CommandManager): command strings arrive as
messages, are parsed argv-style, asset payloads follow as one or two
data messages, and every load and start replies OK.  The commands and
flags are the JAX package's:

  load_config load_texture load_object load_camera load_hdri
  load_brdf_material load_osl_material load_point_light start pause abort
  --path --recompute_normals --mirror_x --mirror_y --output
  --get_info --get_sycl_info --get_pass <name> --help

``pause`` stops the render thread and keeps the accumulated state, so a
bare ``start`` resumes the remaining samples; ``abort`` discards it.
The session builds the scene into tensors on the device its config
names (``Renderer.find_device``: a config without ``"device"`` renders
on cuda:0) and renders there with the port's ``Renderer``.
``get_sycl_info`` lists every CUDA device, each probed by a real launch,
and then the CPU; ``devices[0]`` is the default device.
"""

from __future__ import annotations

import json
import os
import shlex

import numpy as np
import torch

from ..render import shaders as shader_registry
from ..render.renderer import Renderer, find_device
from ..scene.camera import Camera
from ..scene.hdri import HDRI
from ..scene.ir import RenderConfig
from ..scene.material import Material
from ..scene.objloader import load_objs
from ..scene.scene import PointLight, Scene
from ..scene.texture import Texture
from ..utils.logging import get_logger
from .protocol import Message

log = get_logger()


def parse_config_json(obj: dict) -> RenderConfig:
    """The wire config (ConfigTCPLoadInputCommand::load).  ``compat``
    (default true, the reference's quirks) false selects native mode:
    proper MIS weights, exact env CDF inversion and live point-light
    NEE.  ``device`` (default "") names the render device."""
    return RenderConfig(
        x_res=int(obj["x_res"]), y_res=int(obj["y_res"]),
        sample_target=int(obj["sample_target"]),
        denoise=bool(obj["denoise"]),
        device=str(obj.get("device", "")),
        block_size=int(obj.get("block_size", 8)),
        compat=bool(obj.get("compat", True)),
    )


def parse_texture_msgs(metadata: dict, data: np.ndarray) -> Texture:
    """A texture from its JSON metadata and raw float payload."""
    cs = metadata.get("color_space", "sRGB")
    return Texture.from_raw(
        name=str(metadata["name"]), width=int(metadata["width"]),
        height=int(metadata["height"]), channels=int(metadata["channels"]),
        data=data, filter=Texture.FILTER_NONE, srgb=(cs == "sRGB"))


COMMAND_WORDS = ("load_config", "load_texture", "load_object", "load_camera",
                 "load_hdri", "load_brdf_material", "load_osl_material",
                 "load_point_light", "start", "pause", "abort", "get_info",
                 "get_sycl_info", "get_pass")


def parse_command_args(command_str: str) -> dict[str, list[str]]:
    """argv-style parse -> {flag: [values]}.

    Malformed quoting falls back to whitespace splitting; a value may not
    begin with '--' (it starts the next flag); a repeated flag keeps its
    last occurrence; a leading bare command word acts as a flag, so
    ``get_pass normal`` binds ``normal`` as its value.
    """
    try:
        args = shlex.split(command_str)
    except ValueError:  # unbalanced quotes
        args = command_str.split()

    flags: dict[str, list[str]] = {}
    current: str | None = None
    for a in args:
        if a.startswith("--"):
            current = a[2:]
            flags[current] = []
        elif current is not None:
            flags[current].append(a)
        elif a in COMMAND_WORDS:
            current = a
            flags[current] = []
        else:
            flags.setdefault(a, [])
    return flags


class CommandSession:
    """Per-connection session: scene and render lifecycle."""

    def __init__(self, send, recv):
        """send(Message) and recv() -> Message are the transport."""
        self.send = send
        self.recv = recv
        self.scene = Scene()
        self.config = RenderConfig()
        self.renderer: Renderer | None = None
        self._config_dirty = True
        # Shader name -> registry slot bound by load_osl_material.
        self._shader_slots: dict[str, int] = {}

    # ---- command handling ----------------------------------------------
    def handle_command(self, command_str: str) -> bool:
        """Execute one command string.  Returns False to close the
        session (never, today: a failed command is logged and the
        session goes on, as the reference's catch-all does)."""
        log.info("Parsing: %s", command_str)
        flags = parse_command_args(command_str)
        path = " ".join(flags["path"]).strip('"') if "path" in flags else None

        try:
            if "load_config" in flags:
                self._load_config(path)
            elif "load_camera" in flags:
                self._load_camera(path)
            elif "load_texture" in flags:
                self._load_texture(path, "mirror_x" in flags,
                                   "mirror_y" in flags)
            elif "load_hdri" in flags:
                self._load_hdri(path, "mirror_x" in flags,
                                "mirror_y" in flags)
            elif "load_brdf_material" in flags:
                self._load_brdf(path)
            elif "load_object" in flags:
                self._load_object(path, "recompute_normals" in flags)
            elif "load_point_light" in flags:
                self._load_point_light(path)
            elif "load_osl_material" in flags:
                self._load_osl_material(path, flags)
            elif "start" in flags:
                self._start()
            elif "pause" in flags:
                # Stop at the next chunk boundary and keep the state: a
                # bare start resumes (the reference's pause is a no-op).
                if self.renderer is not None:
                    self.renderer.stop()
                    self.renderer.join()
                self.send(Message.ok())
            elif "abort" in flags:
                # Discard progress: the next start re-renders.
                if self.renderer is not None:
                    self.renderer.stop()
                    self.renderer.join()
                    self.renderer = None
                self.send(Message.ok())
            elif "help" in flags:
                self._help()
            elif "get_info" in flags:
                self._get_info()
            elif "get_sycl_info" in flags:
                self._get_device_info()
            elif "get_pass" in flags:
                name = flags["get_pass"][0] if flags["get_pass"] else "beauty"
                if "output" in flags and flags["output"]:
                    self._save_pass(name, flags["output"][0])
                else:
                    self._get_pass(name)
            else:
                log.error("Input Command not recognized in: %s", command_str)
        except Exception as e:  # noqa: BLE001 -- log and go on
            log.error("Command failed: %s", e, exc_info=True)
        return True

    # ---- loads ----------------------------------------------------------
    def _json_payload(self, path):
        if path:
            with open(path) as f:
                return json.load(f)
        return self.recv().get_json_data()

    def _load_config(self, path):
        rp = parse_config_json(self._json_payload(path))
        self.config = rp
        self.scene.x_res = rp.x_res
        self.scene.y_res = rp.y_res
        self._config_dirty = True
        self.send(Message.ok())

    def _load_camera(self, path):
        self.scene.set_camera(Camera.from_json(self._json_payload(path)))
        self.send(Message.ok())

    def _texture_payload(self, path, srgb):
        if path:
            return Texture.from_file(path, srgb=srgb)
        metadata = self.recv().get_json_data()
        data = self.recv().get_float_data()
        return parse_texture_msgs(metadata, data)

    def _load_texture(self, path, mirror_x=False, mirror_y=False):
        tex = self._texture_payload(path, srgb=True)
        if mirror_x:
            tex.mirror_x()
        if mirror_y:
            tex.mirror_y()
        self.scene.add_texture(tex)
        self.scene.pair_textures()
        self.send(Message.ok())

    def _load_hdri(self, path, mirror_x=False, mirror_y=False):
        """HdriTCPLoadInputCommand::load: mirrors, then a half-width
        circular shift."""
        tex = self._texture_payload(path, srgb=False)
        if mirror_x:
            tex.mirror_x()
        if mirror_y:
            tex.mirror_y()
        tex.pixel_shift(0.5, 0)
        self.scene.add_hdri(HDRI(tex))
        self.send(Message.ok())

    def _load_brdf(self, path):
        self.scene.add_material(Material.from_json(self._json_payload(path)))
        self.scene.pair_materials()
        self.scene.pair_textures()
        self.send(Message.ok())

    def _load_point_light(self, path):
        """A JSON ``{"position": [x, y, z], "radiance": [r, g, b]}``, from
        --path or a data message, for the native integrator's point-light
        NEE (the reference has the type but no command)."""
        obj = self._json_payload(path)
        self.scene.add_point_light(PointLight(
            position=np.asarray(obj["position"], np.float32),
            radiance=np.asarray(obj["radiance"], np.float32)))
        self.send(Message.ok())

    def _load_osl_material(self, path, flags):
        """Bind a shader of the named library (``render/shaders.py
        NAMED_SHADERS``) to a material's albedo slot: no code crosses the
        wire, as the reference's albedoShaderID selects one of its
        compiled-in bodies.

          load_osl_material --material <mat> --shader <name> [--slot N]
          load_osl_material --path spec.json   # the same keys in JSON

        Every malformed or unknown request keeps the reference's no-op
        (log and OK), and leaves the registry and bindings untouched:
        the reply is always sent, or the client would wait for it."""
        try:
            spec = {}
            if path:
                with open(path) as f:
                    spec = json.load(f)
            if "material" in flags and flags["material"]:
                spec["material"] = flags["material"][0]
            if "shader" in flags and flags["shader"]:
                spec["shader"] = flags["shader"][0]
            if "slot" in flags and flags["slot"]:
                spec["slot"] = int(flags["slot"][0])
        except Exception as e:  # noqa: BLE001 -- malformed input = no-op
            log.error("load_osl_material: malformed request (%s); ignoring",
                      e)
            self.send(Message.ok())
            return

        name = spec.get("shader")
        mat_name = spec.get("material")
        if not name or not mat_name:
            log.error("load_osl_material needs --material and --shader "
                      "(or a --path JSON with those keys); ignoring")
            self.send(Message.ok())
            return
        fn = shader_registry.NAMED_SHADERS.get(name)
        if fn is None:
            log.error("load_osl_material: unknown shader %r (known: %s); "
                      "ignoring", name,
                      sorted(shader_registry.NAMED_SHADERS))
            self.send(Message.ok())
            return
        mat = next((m for m in self.scene.materials if m.name == mat_name),
                   None)
        if mat is None:
            log.error("load_osl_material: material %r not loaded; ignoring",
                      mat_name)
            self.send(Message.ok())
            return
        slot = spec.get("slot")
        if slot is None:
            slot = self._free_slot(name)
        slot = int(slot)
        if not 0 <= slot < shader_registry.MAX_SHADERS:
            log.error("load_osl_material: slot %d out of range [0, %d); "
                      "ignoring", slot, shader_registry.MAX_SHADERS)
            self.send(Message.ok())
            return
        shader_registry.register_shader(slot, fn)
        self._shader_slots[name] = slot
        mat.albedo_shader_id = slot
        self.scene.dirty = True
        log.info("Bound shader %r (slot %d) to material %r albedo",
                 name, slot, mat_name)
        self.send(Message.ok())

    def _free_slot(self, name: str) -> int:
        """The slot ``name`` is bound to, else the first slot no name is
        bound to; with every slot bound, the next one in turn, with a
        warning, forgetting the names bound there."""
        if name in self._shader_slots:
            return self._shader_slots[name]
        used = set(self._shader_slots.values())
        free = [s for s in range(shader_registry.MAX_SHADERS)
                if s not in used]
        if free:
            return free[0]
        slot = len(self._shader_slots) % shader_registry.MAX_SHADERS
        log.warning("load_osl_material: all %d shader slots bound; "
                    "auto-assigning %r to slot %d EVICTS the shader "
                    "previously there (materials bound to that slot change "
                    "appearance)", shader_registry.MAX_SHADERS, name, slot)
        for other in [k for k, v in self._shader_slots.items() if v == slot]:
            del self._shader_slots[other]
        return slot

    def _load_object(self, path, recompute_normals):
        if path:
            meshes, _ = load_objs(path, recompute_normals=recompute_normals)
        else:
            obj_msg = self.recv()
            mtl_msg = self.recv()
            # Materials arrive as BRDF JSON; the MTL text names them.
            meshes, _ = load_objs(
                obj_msg.data.decode("utf-8", "replace"),
                mtl_text=mtl_msg.get_string_data(),
                recompute_normals=recompute_normals)
        self.scene.add_meshes(meshes)
        self.scene.pair_materials()
        self.send(Message.ok())

    # ---- actions --------------------------------------------------------
    def _start(self):
        if (self.renderer is not None and not self.scene.dirty
                and not self._config_dirty):
            # Resume a paused render: nothing changed since the build.
            # Settle the render thread first, or the count read below
            # could be short and the resumed render overshoot the target.
            self.renderer.stop()
            self.renderer.join()
            done = self.renderer.get_render_info()["samples"]
            remaining = self.config.sample_target - done
            if remaining > 0:
                self.renderer.start(remaining)
            self.send(Message.ok())
            return
        if self.renderer is not None:
            self.renderer.stop()
            self.renderer.join()
            # Dropped before the new scene is built: its IR, state and
            # captured samples (each with its memory pool) go with it.
            self.renderer = None
        device = find_device(self.config.device)
        config, ir = self.scene.build(config=self.config, device=device)
        self.config = config
        self.scene.dirty = False
        self._config_dirty = False
        self.renderer = Renderer(config, ir, device=device)
        self.renderer.start(config.sample_target)
        self.send(Message.ok())

    _HELP_TEXT = """Allowed options:
  --help                     show this message
  --load_config              load render config (JSON follows, or --path)
  --load_camera              load camera (JSON follows, or --path)
  --load_texture             load texture (JSON + float data follow, or
                             --path; flags: --mirror_x --mirror_y)
  --load_hdri                load environment (JSON + float data follow,
                             or --path; flags: --mirror_x --mirror_y)
  --load_brdf_material       load Disney BRDF material (JSON, or --path)
  --load_osl_material        bind a named shader to a material's albedo:
                             --material <mat> --shader <name> [--slot N]
  --load_object              load OBJ (obj + mtl strings follow, or --path;
                             flag: --recompute_normals)
  --load_point_light         load point light (JSON, or --path)
  --start                    build scene and start rendering (resumes after
                             pause)
  --pause                    stop rendering, keep progress
  --abort                    stop rendering, discard progress
  --get_info                 render progress JSON
  --get_sycl_info            device inventory JSON
  --get_pass <name>          fetch pass (beauty/denoise/normal/tangent/
                             bitangent); --output <path> saves a PNG instead
"""

    def _help(self):
        """The command vocabulary, as a string message."""
        self.send(Message("data", "string", self._HELP_TEXT.encode()))

    def _get_info(self):
        info = {"samples": 0}
        if self.renderer is not None:
            info = self.renderer.get_render_info()
        self.send(Message.json_msg(info))

    # Device -> compatible, probed once per device and server process.
    _probe_cache: dict = {}

    @classmethod
    def _probe_device(cls, dev: torch.device) -> bool:
        """A real launch on ``dev`` (the reference's
        sycl::is_compatible test-compiles a kernel): 2x + 1 over 8 ones
        must give 3; any failure marks the device incompatible."""
        if dev not in cls._probe_cache:
            try:
                out = torch.ones(8, device=dev) * 2.0 + 1.0
                cls._probe_cache[dev] = bool(
                    (out == 3.0).all().item())
            except Exception:  # noqa: BLE001 -- any failure = incompatible
                cls._probe_cache[dev] = False
        return cls._probe_cache[dev]

    def _get_device_info(self):
        """get_sycl_info: every CUDA device, probed, then the CPU."""
        devices = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            devices.append({
                "name": f"{props.name}:{i}",
                "platform": "cuda",
                "memory": {"bytes_limit": int(props.total_memory)},
                "max_compute_units": int(props.multi_processor_count),
                "is_compatible": self._probe_device(torch.device("cuda", i)),
                "online_compiler": True,
                "type": "gpu",
            })
        devices.append({
            "name": "cpu:0", "platform": "cpu", "memory": {},
            "max_compute_units": os.cpu_count() or 1,
            "is_compatible": self._probe_device(torch.device("cpu")),
            "online_compiler": True, "type": "cpu",
        })
        self.send(Message.json_msg({"devices": devices}))

    def _get_pass(self, name):
        if self.renderer is None:
            self.send(Message.json_msg({"error": "no render started"}))
            return
        self.send(Message.float_data(self.renderer.get_pass(name), "float4"))

    def _save_pass(self, name, path):
        if self.renderer is not None:
            self.renderer.save_pass(name, path)
        self.send(Message.ok())
