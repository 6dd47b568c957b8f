"""PyTorch port, the render server: wire protocol, command parser,
command session, TCP server and client, against the JAX package's.

- Protocol headers and payloads byte for byte, and the hostile headers
  both refuse.
- ``parse_command_args`` on ``tests/test_parser.py``'s strings and more.
- A full session over localhost with ``"device": "cpu"``: config,
  camera, materials, a texture, the HDRI, OBJ text, a point light,
  ``load_osl_material``, ``--help`` (the JAX package's text),
  ``get_info``, ``get_pass``, hostile commands, reconnect; pause, resume
  and abort at small targets; a poisoned connection.
- The slice as a whole: one message list through a port
  ``CommandSession`` and a JAX ``CommandSession`` (in memory, no
  socket) builds the same IR, and the port's server render of it (2
  samples at 16x16, native) agrees with the JAX render of the JAX IR at
  the integrator tests' tolerance: rtol 1e-4 / atol 1e-5 on >= 99% of
  pixels.

Every server binds a free port of its own (never 5873 or 5557: the JAX
server tests hold 5873, and test files run at the same time)."""

import torch_threads  # noqa: F401  (first: torch's threads a worker)

import dataclasses
import json
import socket
import threading
import time

import numpy as np
import jax
import pytest
import torch

from elevenrender_tpu.render import shaders as jax_shaders
from elevenrender_tpu.render.integrator import init_state as jax_init_state
from elevenrender_tpu.render.integrator import render_sample as jax_render
from elevenrender_tpu.server import commands as jax_commands
from elevenrender_tpu.server import protocol as jax_protocol
from elevenrender_tpu_torch.convert import ir_from_numpy
from elevenrender_tpu_torch.render import shaders as t_shaders
from elevenrender_tpu_torch.scene import demo
from elevenrender_tpu_torch.server import commands
from elevenrender_tpu_torch.server import protocol
from elevenrender_tpu_torch.server.client import RenderClient
from elevenrender_tpu_torch.server.protocol import Message
from elevenrender_tpu_torch.server.tcp import RenderServer

from scenes import CORNELL_OBJ
from test_parser import FakeTransport

CAMERA = {"position": {"x": 0.0, "y": 1.0, "z": -3.5},
          "rotation": {"x": 0.0, "y": 0.0, "z": 0.0},
          "focal_length": 0.035, "sensor_width": 0.036,
          "sensor_height": 0.024, "aperture": 2.8,
          "focus_distance": 1e6, "bokeh": False}
MATERIALS = [
    {"name": "white", "albedo": {"r": 0.73, "g": 0.73, "b": 0.73},
     "albedo_map": "checker"},
    {"name": "red", "albedo": {"r": 0.65, "g": 0.05, "b": 0.05},
     "roughness": 0.4, "metalness": 0.3},
    {"name": "green", "albedo": {"r": 0.12, "g": 0.45, "b": 0.15}},
    {"name": "lamp", "albedo": {"r": 0, "g": 0, "b": 0},
     "emission": {"r": 15, "g": 15, "b": 15}},
]
MTL = "newmtl white\nnewmtl red\nnewmtl green\nnewmtl lamp\n"
# A 2x4 sRGB texture, columns 0.2 and 0.9, for white's albedo map.
TEXTURE = np.tile(np.array([[[0.2], [0.9]]], np.float32), (4, 1, 3))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def server():
    srv = RenderServer(host="127.0.0.1", port=_free_port())
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    deadline = time.time() + 10
    while srv._sock is None or not srv._running:
        assert time.time() < deadline
        time.sleep(0.01)
    yield srv
    srv.shutdown()
    th.join(10)
    assert not th.is_alive()


@pytest.fixture
def shaders_reset():
    yield
    t_shaders.reset_shaders()
    jax_shaders.reset_shaders()


def _wait_samples(c, n, timeout=120):
    deadline = time.time() + timeout
    while c.get_info()["samples"] < n:
        assert time.time() < deadline, c.get_info()
        time.sleep(0.02)


# ---- protocol ----------------------------------------------------------------

def _messages(mod):
    M = mod.Message
    return [M.ok(), M.close_session(),
            M.command("--load_object --recompute_normals"),
            M.json_msg({"x_res": 640, "denoise": False, "k": [1, 2.5]}),
            M.json_msg({"k": "x" * 2000}, type="command"),
            M.float_data(np.arange(12, dtype=np.float32), "float3"),
            M.float_data(np.linspace(0, 1, 8), "float4"),
            M("data", "string", "newmtl é\n".encode()), M()]


def test_protocol_bytes_equal_jax():
    for ours, theirs in zip(_messages(protocol), _messages(jax_protocol)):
        assert ours.header_bytes() == theirs.header_bytes()
        assert ours.data == theirs.data
        assert len(ours.header_bytes()) == protocol.MESSAGE_HEADER_SIZE
        got, size = Message.parse_header(theirs.header_bytes())
        assert (got.type, got.data_format, size) == (
            theirs.type, theirs.data_format, len(theirs.data))
        if ours.data_format == "json":
            assert ours.get_json_data() == theirs.get_json_data()
        if ours.data_format.startswith("float"):
            np.testing.assert_array_equal(ours.get_float_data(),
                                          theirs.get_float_data())
        assert ours.get_string_data() == theirs.get_string_data()


@pytest.mark.parametrize("raw", [
    b"\xff\xfegarbage", b"[1, 2, 3]",
    json.dumps({"type": "command", "data_size": 1 << 60}).encode(),
    json.dumps({"type": "command", "data_size": -5}).encode(),
    json.dumps({"type": "command", "data_size": "x"}).encode()])
def test_hostile_headers_are_refused_as_jax_refuses_them(raw):
    hdr = raw + b"\x00" * (protocol.MESSAGE_HEADER_SIZE - len(raw))
    for mod in (protocol, jax_protocol):
        with pytest.raises(ValueError):
            mod.Message.parse_header(hdr)
    with pytest.raises(ValueError, match="header size"):
        Message("command", "string" * 200, b"").header_bytes()


# ---- parser ------------------------------------------------------------------

@pytest.mark.parametrize("cmd", [
    '--load_object --path "/tmp/my scene.obj"',
    "--load_object --path /tmp/my scene.obj", "--get_pass --output",
    "--path a --path b", '--path "unterminated', "get_pass normal",
    "frobnicate --start", "", "-- --- ----",
    "--get_pass denoise --output out.png",
    "load_osl_material --material white --shader checker --slot 2",
    "--load_hdri --mirror_x --mirror_y", "start extra words"])
def test_parse_command_args_equals_jax(cmd):
    assert commands.parse_command_args(cmd) == \
        jax_commands.parse_command_args(cmd)


def test_help_text_equals_jax():
    assert (commands.CommandSession._HELP_TEXT
            == jax_commands.CommandSession._HELP_TEXT)


@pytest.mark.parametrize("cmd", [
    "frobnicate", '--load_config --path "/nonexistent file.json"',
    '--path "unterminated', "--get_pass", "--load_osl_material", "",
    "-- --- ----", "--start"])
def test_session_survives_hostile_commands(cmd):
    """test_parser.py's hostile list, and a start with nothing loaded on
    a config that names the card (cuda:0): each command is logged and
    the session goes on, as the JAX session does."""
    t = FakeTransport()
    s = commands.CommandSession(send=t.send, recv=t.recv)
    assert s.handle_command(cmd) is True


def test_malformed_json_payload_survives():
    t = FakeTransport()
    s = commands.CommandSession(send=t.send, recv=t.recv)
    t.inbox.append(Message("data", "json", b"{not json"))
    assert s.handle_command("--load_config") is True
    assert not t.sent


def test_a_config_without_device_renders_on_the_card():
    """No "device" in the config means cuda:0: without a card, start
    fails (logged, no reply, as any failed command) instead of rendering
    on the CPU."""
    t = FakeTransport()
    s = commands.CommandSession(send=t.send, recv=t.recv)
    t.inbox.append(Message.json_msg({"x_res": 8, "y_res": 8,
                                     "sample_target": 1, "denoise": False}))
    s.handle_command("--load_config")
    assert s.config.device == ""
    t.sent.clear()
    s.handle_command("--start")
    if torch.cuda.is_available():
        assert s.renderer.device == torch.device("cuda", 0)
        s.renderer.join()
    else:
        assert s.renderer is None and not t.sent


def test_device_info_lists_cuda_devices_then_the_cpu():
    t = FakeTransport()
    s = commands.CommandSession(send=t.send, recv=t.recv)
    s.handle_command("--get_sycl_info")
    devices = t.sent[-1].get_json_data()["devices"]
    assert len(devices) == torch.cuda.device_count() + 1
    assert devices[-1]["type"] == "cpu" and devices[-1]["platform"] == "cpu"
    for d in devices:
        assert d["is_compatible"] is True
        assert set(d) == {"name", "platform", "memory", "max_compute_units",
                          "is_compatible", "online_compiler", "type"}
    assert all(d["type"] == "gpu" for d in devices[:-1])
    assert commands.CommandSession._probe_device(torch.device("cpu"))


def test_device_probe_marks_a_failing_device_incompatible(monkeypatch):
    dev = torch.device("meta")
    monkeypatch.setattr(commands.CommandSession, "_probe_cache", {})
    assert commands.CommandSession._probe_device(dev) is False


# ---- sessions over localhost ---------------------------------------------------

def _load_scene(c, x_res=16, y_res=16, sample_target=2, compat=False,
                **config):
    c.load_config(x_res=x_res, y_res=y_res, sample_target=sample_target,
                  device="cpu", compat=compat, **config)
    c.load_camera(CAMERA)
    c.load_texture("checker", TEXTURE, color_space="sRGB")
    for m in MATERIALS:
        c.load_brdf_material(m)
    c.load_hdri(np.full((2, 4, 3), 0.1, np.float32))
    c.load_object(CORNELL_OBJ, mtl_text=MTL)


def test_full_session(server, shaders_reset, tmp_path):
    c = RenderClient("127.0.0.1", server.port, timeout=120)
    info = c.get_device_info()
    assert info["devices"][-1]["type"] == "cpu"
    assert c.help() == jax_commands.CommandSession._HELP_TEXT
    c.command("--get_pass")
    assert c.recv().get_json_data() == {"error": "no render started"}
    assert c.get_info() == {"samples": 0}

    _load_scene(c, sample_target=3, denoise=False)
    c.load_point_light([0.0, 1.5, -1.0], [20.0, 20.0, 20.0])
    c.load_osl_material("green", "checker", slot=1)
    c.command("--load_osl_material --material green --shader nope")
    assert c.recv().get_string_data() == "ok"
    c.command("--load_osl_material --material ghost --shader yellow")
    assert c.recv().get_string_data() == "ok"
    c.command("frobnicate --now")  # no reply, the session goes on
    c.start()
    _wait_samples(c, 3)
    for name in ("beauty", "normal", "tangent", "bitangent", "denoise",
                 "nonsense"):
        img = c.get_pass(name)
        assert img.shape == (16 * 16 * 4,) and np.isfinite(img).all(), name
    assert np.array_equal(c.get_pass("nonsense"), c.get_pass("beauty"))
    assert c.get_pass("beauty").reshape(-1, 4)[:, :3].max() > 0
    out = tmp_path / "beauty.png"
    c.command(f"--get_pass beauty --output {out}")
    assert c.recv().get_string_data() == "ok"
    assert out.exists()
    c.close()

    # The server survives the close and accepts again.
    c2 = RenderClient("127.0.0.1", server.port, timeout=30)
    assert c2.get_info() == {"samples": 0}  # a new session
    c2.abort()
    c2.close()


def test_pause_resume_abort(server):
    """pause keeps progress and a bare start resumes to the target;
    abort discards it (the JAX package's semantics, at a CPU-sized
    target: chunks of one sample)."""
    c = RenderClient("127.0.0.1", server.port, timeout=120)
    target = 40
    _load_scene(c, x_res=8, y_res=8, sample_target=target, block_size=1)
    c.start()
    _wait_samples(c, 2)
    c.pause()
    s1 = c.get_info()["samples"]
    assert 2 <= s1 < target
    time.sleep(0.2)
    assert c.get_info()["samples"] == s1, "samples advanced while paused"
    c.start()
    deadline = time.time() + 120
    while (s := c.get_info()["samples"]) < target:
        assert s >= s1, "resume dropped accumulated progress"
        assert time.time() < deadline
        time.sleep(0.02)
    time.sleep(0.1)
    assert c.get_info()["samples"] == target
    c.start()  # at the target: nothing more
    assert c.get_info()["samples"] == target
    c.abort()
    assert c.get_info()["samples"] == 0
    c.close()


def test_disk_loads_by_path(server, tmp_path):
    """--path loads of the config, camera and BRDF JSON and of an OBJ
    file."""
    files = {"config.json": {"x_res": 8, "y_res": 8, "sample_target": 1,
                             "denoise": True, "device": "cpu",
                             "compat": False},
             "camera.json": CAMERA, "white.json": MATERIALS[0]}
    for name, obj in files.items():
        (tmp_path / name).write_text(json.dumps(obj))
    (tmp_path / "box.obj").write_text(CORNELL_OBJ)
    c = RenderClient("127.0.0.1", server.port, timeout=120)
    for cmd in (f"--load_config --path {tmp_path / 'config.json'}",
                f"--load_camera --path {tmp_path / 'camera.json'}",
                f"--load_brdf_material --path {tmp_path / 'white.json'}",
                f"--load_object --path {tmp_path / 'box.obj'}", "--start"):
        c.command(cmd)
        assert c.recv().get_string_data() == "ok", cmd
    _wait_samples(c, 1)
    img = c.get_pass("normal").reshape(-1, 4)
    assert (img[:, 3] == 1.0).all()  # config.denoise: alpha := 1
    c.close()


def test_server_survives_garbage_header_and_reaccepts(server):
    c1 = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    assert protocol.read_message(c1).get_string_data() == "ok"
    c1.sendall(b"\xde\xad" * (protocol.MESSAGE_HEADER_SIZE // 2))
    time.sleep(0.2)
    c1.close()
    c2 = RenderClient("127.0.0.1", server.port, timeout=10)
    assert c2.get_info() == {"samples": 0}
    c2.close()


# ---- the slice as a whole -------------------------------------------------------

def _message_list(mod, obj_text, mtl, res, sample_target, point_light):
    """(command, payload messages) of a client session, for ``mod``'s
    Message class."""
    M = mod.Message
    hdri = np.random.default_rng(5).uniform(0, 2, (4, 8, 3)).astype(
        np.float32)
    out = [("--load_config", [M.json_msg({
        "x_res": res, "y_res": res, "sample_target": sample_target,
        "denoise": False, "device": "cpu", "compat": False})]),
        ("--load_camera", [M.json_msg(CAMERA)]),
        ("--load_texture", [M.json_msg({
            "name": "checker", "width": 2, "height": 4, "channels": 3,
            "color_space": "sRGB"}), M.float_data(TEXTURE.reshape(-1))])]
    out += [("--load_brdf_material", [M.json_msg(m)]) for m in MATERIALS]
    out += [("--load_hdri --mirror_x", [M.json_msg({
        "name": "hdri", "width": 8, "height": 4, "channels": 3,
        "color_space": "LINEAR"}), M.float_data(hdri.reshape(-1))]),
        ("--load_object", [M("data", "string", obj_text.encode()),
                           M("data", "string", mtl.encode())])]
    if point_light:
        out.append(("--load_point_light", [M.json_msg(
            {"position": [0.0, 1.5, -1.0], "radiance": [8.0, 8.0, 8.0]})]))
    out.append(("--load_osl_material --material green --shader checker "
                "--slot 1", []))
    return out


def _run_session(mod, messages):
    t = FakeTransport()
    s = mod.CommandSession(send=t.send, recv=t.recv)
    for cmd, payloads in messages:
        t.inbox.extend(payloads)
        t.sent.clear()
        assert s.handle_command(cmd) is True
        assert [m.get_string_data() for m in t.sent] == ["ok"], cmd
        assert not t.inbox, cmd
    return s


def _session_pair(monkeypatch, obj_text, mtl, res, point_light=True):
    args = (obj_text, mtl, res, 2, point_light)
    port = _run_session(commands, _message_list(protocol, *args))
    ref = _run_session(jax_commands, _message_list(jax_protocol, *args))
    monkeypatch.setenv("ELEVENRT_NATIVE", "0")  # the numpy BVH build
    jcfg, jir = ref.scene.build(config=ref.config)
    pcfg, pir = port.scene.build(config=port.config, device="cpu")
    ccfg, cir = ir_from_numpy(dataclasses.asdict(jcfg),
                              jax.tree.map(np.asarray, jir), device="cpu")
    for f in ("x_res", "y_res", "sample_target", "device", "compat",
              "block_size", "bvh_depth", "bvh_max_leaf", "bokeh",
              "n_lights", "tex_slots_used", "tex_uniform_filter",
              "use_shaders"):
        assert getattr(pcfg, f) == getattr(ccfg, f), f
    assert pir.keys() == cir.keys()
    for grp in pir:
        assert pir[grp].keys() == cir[grp].keys(), grp
        for k in pir[grp]:
            np.testing.assert_array_equal(pir[grp][k].numpy(),
                                          cir[grp][k].numpy(),
                                          err_msg=f"{grp}.{k}")
    return port, ref, jcfg, jir


def test_heightfield_session_builds_the_jax_ir(monkeypatch, shaders_reset):
    """The main path's session in miniature (a grid-12 heightfield as
    OBJ text, as the chip smoke test streams grid 182): the same IR."""
    mesh = demo.heightfield_mesh(12)
    mesh.mat_names = ["red"] * mesh.tri_count
    _session_pair(monkeypatch, demo.mesh_obj_text(mesh), MTL, 16)


def test_cornell_session_renders_what_the_jax_session_renders(
        monkeypatch, shaders_reset):
    """One message list through both sessions: the same IR, and the
    port's server render (its render thread, 2 samples) agrees with the
    JAX render of the JAX session's IR."""
    res = 16
    port, _, jcfg, jir = _session_pair(monkeypatch, CORNELL_OBJ, MTL, res)
    assert jcfg.n_lights == 1 and jcfg.use_shaders

    state = jax_init_state(jcfg)
    step = jax.jit(jax_render, static_argnums=0)
    for _ in range(2):
        state = step(jcfg, jir, state)
    want = np.asarray(state["passes"])

    t = FakeTransport()
    port.send, port.recv = t.send, t.recv
    port.handle_command("--start")
    assert [m.get_string_data() for m in t.sent] == ["ok"]
    port.renderer.join()
    assert port.renderer.error is None
    port.handle_command("--get_info")
    assert t.sent[-1].get_json_data() == {"samples": 2}
    for pid, name in ((0, "beauty"), (2, "normal")):
        port.handle_command(f"--get_pass {name}")
        got = t.sent[-1].get_float_data().reshape(res, res, 4)
        ref = want[pid].reshape(res, res, 4)
        close = np.isclose(got, ref, rtol=1e-4, atol=1e-5).all(-1).mean()
        assert close >= 0.99, (name, close)
        assert abs(got[..., :3].mean() - ref[..., :3].mean()) <= \
            1e-4 * abs(ref[..., :3].mean()), name
    assert want[0][:, :3].max() > 0
