"""PyTorch port, isolation: the port and chip_smoke.py import neither jax
nor the JAX package, and the entry points never fall back to the CPU on
their own."""

from torch_threads import child_env  # first: torch's threads a worker

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "elevenrender_tpu_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")

_BLOCK = ("import sys\n"
          "sys.modules['jax'] = None\n"
          "sys.modules['elevenrender_tpu'] = None\n")


def _port_files():
    out = [SMOKE]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        for name in _imported(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "elevenrender_tpu"), \
                (path, name)


def _string_constants(path):
    """The string constants of ``path`` that are not docstrings."""
    tree = ast.parse(open(path).read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                docs.add(id(first.value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_no_port_file_names_a_path_under_native_or_the_jax_package():
    """The port keeps its own copies (``csrc/elevenrt.cpp`` among them):
    no string in its code, or in chip_smoke.py's, names a file under
    ``native/`` or ``elevenrender_tpu/``.  The one allowed form is a
    citation ``elevenrender_tpu/<file>.py:<line>``, the "replaces" entry
    of chip_smoke.py's kernel table, which is never opened."""
    import re
    cite = re.compile(r"^elevenrender_tpu/[\w/]+\.py:\d+\b")
    jax_path = re.compile(r"(^|[^\w])elevenrender_tpu[/\\]")
    native = re.compile(r"(^|[^\w])native[/\\]|^native$|libelevenrt\.so")
    for path in _port_files():
        for text in _string_constants(path):
            assert not native.search(text), (path, text)
            assert not jax_path.search(text) or cite.match(text), (path, text)


def test_the_port_alone_builds_its_host_runtime_and_loads_objs(tmp_path):
    """A copy of the port without ``native/`` or ``elevenrender_tpu/``
    beside it builds its C++ runtime from its own source, and the C++
    tokenizer and SAH build run there."""
    import shutil
    shutil.copytree(PORT, tmp_path / "elevenrender_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = """
import os
from elevenrender_tpu_torch import kernels
from elevenrender_tpu_torch.ops import bvh
from elevenrender_tpu_torch.scene import demo, objloader
assert kernels.BUILD_DIR == kernels.Path(os.getcwd()) / "build" / "kernels"
mesh = demo.heightfield_mesh(80)
text = demo.mesh_obj_text(mesh)
assert len(text) > objloader.NATIVE_MIN_CHARS
meshes, _ = objloader.load_objs(text)
assert [m.name for m in meshes] == ["heightfield"]
assert (meshes[0].verts == mesh.verts).all()
assert kernels.build_info["elevenrt"]["seconds"] > 0
native = bvh.build_bvh(mesh.verts[:3000])
plain = bvh.build_bvh(mesh.verts[:3000], use_native=False)
assert all((native[k] == plain[k]).all() for k in ("perm", "node_bmin"))
print("alone ok", len(text))
"""
    res = subprocess.run([sys.executable, "-c", _BLOCK + code],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=child_env())
    assert res.returncode == 0, res.stderr
    assert "alone ok" in res.stdout
    assert sorted(os.listdir(tmp_path)) == ["build",
                                            "elevenrender_tpu_torch"]


def _run(code, **kw):
    return subprocess.run([sys.executable, "-c", _BLOCK + code], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=child_env(), **kw)


def test_port_imports_and_renders_without_jax():
    code = """
import importlib, pkgutil
import numpy as np
import elevenrender_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from elevenrender_tpu_torch.render.renderer import Renderer
from elevenrender_tpu_torch.scene.demo import (heightfield_scene,
                                               textured_heightfield_scene)
for build in (heightfield_scene, textured_heightfield_scene):
    _, config, ir = build(grid=10, res=8, device="cpu")
    r = Renderer(config, ir, device="cpu")
    r.step(1)
    img = r.get_pass("beauty").reshape(8, 8, 4)
    assert np.isfinite(img).all() and img[..., :3].mean() > 0.0
    print("rendered", build.__name__, float(img[..., :3].mean()))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "rendered heightfield_scene" in res.stdout
    assert "rendered textured_heightfield_scene" in res.stdout


def test_gradient_path_runs_without_jax():
    """The two-pass accumulator (record, replay, mm_bwd) and the direct
    gradient, with jax and the JAX package blocked from import."""
    code = """
import torch
from elevenrender_tpu_torch.render import grad
from elevenrender_tpu_torch.render.integrator import (BEAUTY, init_state,
                                                      render_sample)
from elevenrender_tpu_torch.scene.demo import textured_heightfield_scene
_, config, ir = textured_heightfield_scene(grid=10, res=8, device="cpu")
config = config.replace(compat=False, max_bounces=2)
assert config.material_fetch == "mm_bwd" and config.n_lights == 1
with torch.no_grad():
    state = render_sample(config, ir, init_state(config, "cpu"), device="cpu")
target = state["passes"][BEAUTY, :, :3] * 1.5 + 0.1
for step in (grad.fwd_bwd_step_accum, grad.fwd_bwd_step):
    loss, grads = step(config, ir, target, 2, device="cpu")
    g = grads["materials"]["roughness"]
    assert torch.isfinite(loss) and torch.isfinite(g).all() and g.abs().sum() > 0
    print("gradient", step.__name__, float(loss))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "gradient fwd_bwd_step_accum" in res.stdout
    assert "gradient fwd_bwd_step " in res.stdout


def test_traversal_sweep_runs_without_jax():
    """The A/B sweep's entry point, the frontier and wide walks and the
    counting sort, with jax and the JAX package blocked from import."""
    code = """
import torch
from elevenrender_tpu_torch import sweep_traverse
from elevenrender_tpu_torch.ops.sort import sort_for_packets
rows = sweep_traverse.main(["--device", "cpu", "--grids", "10", "--res", "16",
                            "--reps", "1", "--frontiers", "2,4"])
kernels = sorted({r["kernel"] for r in rows})
assert kernels == ["binary", "binary-v1", "frontier=2", "frontier=4",
                   "wide"], kernels
z = torch.rand((64, 3))
order, inverse = sort_for_packets(z, z, z.min(0).values, z.max(0).values,
                                  impl="counting")
assert torch.equal(inverse[order], torch.arange(64))
print("swept", len(rows))
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert "swept 18" in res.stdout


def test_new_walks_refuse_other_devices_and_never_fall_back():
    """``traverse(..., frontier=4)`` and ``traverse_wide`` take the plain
    version for a CPU tensor only: a tensor that claims another device
    raises, and so does the launch path itself where no kernel can be
    built, instead of giving way to the plain version."""
    from elevenrender_tpu_torch import kernels
    from elevenrender_tpu_torch.experiments import bvh_wide
    from elevenrender_tpu_torch.ops import traverse as tt
    from elevenrender_tpu_torch.scene import demo

    z = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tt.traverse({}, z, z, 3, frontier=4)
    with pytest.raises(ValueError, match="unsupported device"):
        bvh_wide.traverse_wide(None, None, None, z, z, 3)
    assert set(kernels.LIBRARIES) == {"bvh_traverse", "bvh_traverse_v1",
                                      "bvh_frontier", "bvh_wide", "hitdata"}
    for name, (sources, _, headers) in kernels.LIBRARIES.items():
        assert all((kernels.CSRC / f).exists() for f in sources + headers)
        assert ("bvh_common.cuh" in headers) == name.startswith("bvh_")
    if torch.cuda.is_available():
        return
    _, cfg, ir = demo.heightfield_scene(grid=10, res=8, device="cpu")
    o = torch.zeros((4, 3))
    d = torch.ones((4, 3))
    wide = {k: torch.tensor(v) for k, v in bvh_wide.pack_bvh_wide(
        {**{k: v.numpy() for k, v in ir["bvh"].items()},
         "depth": cfg.bvh_depth}).items()}
    tt.reset_counts()
    with pytest.raises((RuntimeError, OSError)):
        tt._launch_frontier(ir["kernel"], o, d, cfg.bvh_depth, 4, None, None)
    with pytest.raises((RuntimeError, OSError)):
        tt._launch_v1(ir["kernel"], o, d, cfg.bvh_depth, None, None)
    with pytest.raises((RuntimeError, OSError)):
        bvh_wide._launch(wide["nodes8"], wide["leaf8"], ir["kernel"]["tris"],
                         o, d, cfg.bvh_depth)
    assert tt.frontier_launches == 0 and tt.wide_launches == 0
    assert tt.v1_launches == 0 and not tt.variant_launches


def test_a_changed_header_changes_the_library_hash(tmp_path, monkeypatch):
    """The build key covers the headers a source includes, which nvcc is
    not handed: editing the shared header moves the target of every
    library that lists it, and of no other."""
    import shutil
    from elevenrender_tpu_torch import kernels

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    before = {name: kernels._target(name) for name in kernels.LIBRARIES}
    for name, (out, cmd) in before.items():
        assert not any(arg.endswith(".cuh") for arg in cmd), name
    with open(csrc / "bvh_common.cuh", "a") as f:
        f.write("// edited\n")
    for name, (out, cmd) in before.items():
        shares = "bvh_common.cuh" in kernels.LIBRARIES[name][2]
        assert (kernels._target(name)[0] != out) == shares, name
    with open(csrc / "bvh_wide.cu", "a") as f:
        f.write("// edited\n")
    edited = {name: kernels._target(name)[0] for name in kernels.LIBRARIES}
    with open(csrc / "bvh_wide.cu", "a") as f:
        f.write("// again\n")
    for name in kernels.LIBRARIES:
        assert (kernels._target(name)[0] != edited[name]) == (
            name == "bvh_wide")


def test_chip_smoke_refuses_to_run_without_a_card():
    """Without CUDA the smoke test exits non-zero and prints no result;
    its failure is the missing card, not a missing jax."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code = "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')"
    res = _run(code)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "CUDA" in res.stderr and "jax" not in res.stderr


def test_the_applications_import_no_jax_and_refuse_without_a_card():
    """``render_config5``, ``denoise_showcase``, ``demo`` and
    ``multichip_bench``, with jax and the JAX package blocked from import:
    each one's default device is the card, and without one each raises
    before it builds, reads or writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    code = """
import os
from elevenrender_tpu_torch import (demo, denoise_showcase,
                                    multichip_bench, render_config5)
before = sorted(os.listdir("."))
for mod in (render_config5, denoise_showcase, demo, multichip_bench):
    try:
        mod.main([])
    except RuntimeError as e:
        assert "cuda" in str(e), e
        print("refused", mod.__name__.rsplit(".", 1)[1])
assert sorted(os.listdir(".")) == before
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == [
        w for name in ("render_config5", "denoise_showcase", "demo",
                       "multichip_bench") for w in ("refused", name)]


def test_entry_points_default_to_cuda_and_refuse_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from elevenrender_tpu_torch.convert import ir_from_numpy
    from elevenrender_tpu_torch.render import integrator
    from elevenrender_tpu_torch.render.renderer import Renderer
    from elevenrender_tpu_torch.scene import demo

    scene, config, ir = demo.heightfield_scene(grid=6, res=8, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Renderer(config, ir)
    with pytest.raises(RuntimeError, match="cuda"):
        scene.build()
    with pytest.raises(RuntimeError, match="cuda"):
        integrator.init_state(config)
    state = integrator.init_state(config, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        integrator.render_sample(config, ir, state)
    ir_np = {g: {k: v.numpy() for k, v in leaves.items()}
             for g, leaves in ir.items()}
    import dataclasses
    with pytest.raises(RuntimeError, match="cuda"):
        ir_from_numpy(dataclasses.asdict(config), ir_np)
    # With device="cpu" the same calls work.
    cfg2, ir2 = ir_from_numpy(dataclasses.asdict(config), ir_np,
                              device="cpu")
    np.testing.assert_array_equal(ir2["kernel"]["boxes"].numpy(),
                                  ir["kernel"]["boxes"].numpy())
