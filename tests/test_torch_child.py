"""PyTorch port, profiling in a child process (``core/child.py``).

On a card the port's tracing entry points (``Renderer.profile``,
``profile_step.profile_forward`` and ``profile_grad``) never open a
``torch.profiler`` session in the caller's process, which may hold CUDA
graphs: a fresh child process rebuilds the work from CPU copies and
traces it.  Here, on the CPU, the child route is taken by asking for it
(``traces_in_child``), and the parent's ``torch.profiler.profile`` is
replaced by one that fails if entered.  The child's ``trace.json`` has
the form of the one traced in the process, and the renderer ends in the
same state, bit for bit."""

import torch_threads  # first: torch's threads a worker

import json
import operator
import os

import pytest
import torch
import torch.profiler

from elevenrender_tpu_torch import profile_step
from elevenrender_tpu_torch.core import child
from elevenrender_tpu_torch.render.renderer import Renderer
from elevenrender_tpu_torch.scene.demo import heightfield_scene

RES = 16


class _NoSession:
    """A stand-in for ``torch.profiler.profile`` that fails if made."""

    def __init__(self, *a, **kw):
        raise AssertionError("a profiling session opened in the parent")


def _renderer():
    _, cfg, ir = heightfield_scene(grid=8, res=RES, device="cpu")
    r = Renderer(cfg.replace(max_bounces=2), ir, device="cpu")
    r.step(1)
    return r


def _trace(path):
    assert sorted(p.name for p in path.iterdir()) == ["trace.json"]
    return json.load(open(path / "trace.json"))["traceEvents"]


def test_call_in_child_returns_its_result_and_raises_its_error(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch_threads.THREADS))
    assert child.call_in_child(os.getpid) != os.getpid()
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        child.call_in_child(operator.truediv, 1, 0)


def test_only_a_card_traces_in_a_child():
    assert child.traces_in_child("cuda") and child.traces_in_child("cuda:1")
    assert not child.traces_in_child("cpu")


def test_profile_traces_in_a_child_process(monkeypatch, tmp_path):
    """``Renderer.profile(path, 3)`` by the child route: the parent opens
    no session; the trace holds the child's events only, 3 samples' ray
    sorts as the in-process trace does, naming records once; the
    renderer is 3 samples on, in the state the in-process route
    reaches."""
    here, there = _renderer(), _renderer()
    here.profile(str(tmp_path / "here"), n_samples=3)
    monkeypatch.setenv("OMP_NUM_THREADS", str(torch_threads.THREADS))
    monkeypatch.setattr(child, "traces_in_child", lambda device: True)
    monkeypatch.setattr(torch.profiler, "profile", _NoSession)
    there.profile(str(tmp_path / "there"), n_samples=3)
    traces = {k: _trace(tmp_path / k) for k in ("here", "there")}
    sorts = {k: sum(e.get("name") == "aten::sort" for e in v)
             for k, v in traces.items()}
    assert sorts["here"] > 0 and sorts["there"] == sorts["here"]
    pids = {e["pid"] for e in traces["there"]
            if isinstance(e.get("pid"), int)}
    assert pids and os.getpid() not in pids
    named = [json.dumps([e.get(k) for k in ("name", "pid", "tid", "args")])
             for e in traces["there"] if e.get("ph") == "M"]
    assert len(named) == len(set(named))
    assert there.get_render_info() == here.get_render_info() == {
        "samples": 4}
    for k, v in here.state.items():
        assert torch.equal(there.state[k], v), k


@pytest.mark.parametrize("name", ["profile_forward", "profile_grad"])
def test_profile_step_traces_in_a_child(monkeypatch, name):
    """``profile_forward`` and ``profile_grad`` hand their work, with a
    CPU copy of the IR and its device, to ``call_in_child`` when the
    device traces in a child (the work itself needs a card)."""
    _, cfg, ir = heightfield_scene(grid=8, res=RES, device="cpu")
    calls = []
    monkeypatch.setattr(child, "traces_in_child", lambda device: True)
    monkeypatch.setattr(child, "call_in_child",
                        lambda fn, *args: calls.append((fn, args)) or {})
    assert getattr(profile_step, name)(cfg, ir, 2, 5) == {}
    ((fn, (cfg_, ir_, dev, samples, top)),) = calls
    assert fn is getattr(profile_step, f"_{name}_child")
    assert (cfg_, dev, samples, top) == (cfg, torch.device("cpu"), 2, 5)
    assert torch.equal(ir_["tris"]["verts"], ir["tris"]["verts"])


@pytest.mark.parametrize("name", ["profile_forward", "profile_grad"])
def test_the_child_side_runs_the_profile_on_its_device(monkeypatch, name):
    """The child's side of ``profile_forward`` / ``profile_grad`` moves
    the IR to the device it was given and runs the profile there, with
    the caller's samples and ``top``."""
    _, cfg, ir = heightfield_scene(grid=8, res=RES, device="cpu")
    seen = []
    monkeypatch.setattr(profile_step, f"_{name}_here",
                        lambda *a: seen.append(a) or {"ok": 1})
    fn = getattr(profile_step, f"_{name}_child")
    assert fn(cfg, child.to_cpu(ir), torch.device("cpu"), 3, 7) == {"ok": 1}
    ((cfg_, ir_, samples, top),) = seen
    assert (cfg_, samples, top) == (cfg, 3, 7)
    assert all(t.device == torch.device("cpu")
               for leaves in ir_.values() for t in leaves.values())
    assert torch.equal(ir_["tris"]["verts"], ir["tris"]["verts"])
