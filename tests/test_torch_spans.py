"""PyTorch port, the span and counter registry (``core/spans.py``).

On the CPU:
(a) off (the default) is a no-op: every span is one shared null
    context, a device counter adds nothing, nothing is launched or
    recorded;
(b) nested spans give inclusive and self time;
(c) host counters counted inside a capture of ``CapturedCall`` (the
    graph calls replaced by stand-ins, which the CPU has not) are taken
    out and added back by each replay, and the capture counts one
    ``capture``;
(d) a tiny scene rendered with tracing on equals the same render with
    tracing off, bit for bit (passes, sample counts, RNG streams), and
    the graph cache keeps the two apart;
(e) ``alive_lanes`` is the alive part of ``count_rays``'s ``ray_count``;
(f) a span inside a ``torch.profiler`` session lies on the profiler's own
    host clock, within 50 us of the profiler's event of the same range.

On a card (``-m card``; skipped without one): the stamps accumulate
over graph replays with no host sync, and a sample's phases sum to its
``sample`` span within 2%.

    python -m pytest tests/test_torch_spans.py -q [-m card]
"""

import torch_threads  # first: torch's threads a worker

import contextlib
import time

import pytest
import torch

from elevenrender_tpu_torch.core import device as device_mod
from elevenrender_tpu_torch.core import spans
from elevenrender_tpu_torch.ops import traverse as tt
from elevenrender_tpu_torch.render import dispatch
from elevenrender_tpu_torch.render.renderer import Renderer
from elevenrender_tpu_torch.scene.demo import heightfield_scene


@pytest.fixture
def tracing():
    """Tracing on for one test, from an empty registry; off after."""
    spans.reset()
    spans.enable(True)
    try:
        yield spans
    finally:
        spans.enable(False)
        spans.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def _scene(device="cpu", grid=10, res=8):
    _, cfg, ir = heightfield_scene(grid=grid, res=res, device=device)
    return cfg.replace(count_rays=True), ir


def _render(cfg, ir, n=3, device="cpu"):
    r = Renderer(cfg, ir, device=device)
    r.step(n)
    return r.state


def test_off_is_a_no_op(monkeypatch):
    assert not spans.enabled()
    spans.reset()

    def no_launch():
        raise AssertionError("a stamp library was asked for")

    monkeypatch.setattr(spans, "_library", no_launch)
    first = spans.span("a", "cpu")
    assert first is spans.span("b") is spans._NULL
    with first, spans.span("c", "cpu"):
        spans.count_device("alive_lanes", torch.tensor(3.0))
    cfg, ir = _scene()
    _render(cfg, ir, 2)
    got = spans.report()
    assert got["spans"] == {} and got["errors"] == 0
    assert "alive_lanes" not in got["counters"]
    assert "lanes" not in got["counters"]
    assert spans.series("sample") == []


def test_nested_spans_give_inclusive_and_self_time(tracing):
    with spans.span("outer", "cpu"):
        time.sleep(0.02)
        for _ in range(2):
            with spans.span("inner", "cpu"):
                time.sleep(0.01)
    with spans.span("host only"):
        pass
    got = spans.report()["spans"]
    outer, inner = got["outer"], got["inner"]
    assert outer["device_count"] == 1 and inner["device_count"] == 2
    assert inner["self_ms"] == inner["device_ms"] >= 20.0
    assert outer["device_ms"] >= inner["device_ms"] + 20.0
    assert outer["self_ms"] == pytest.approx(
        outer["device_ms"] - inner["device_ms"], abs=1e-6)
    assert outer["count"] == 1 and inner["count"] == 2
    assert outer["host_s"] * 1e3 == pytest.approx(outer["device_ms"],
                                                  abs=1.0)
    assert "device_ms" not in got["host only"]
    assert got["host only"]["count"] == 1
    assert len(spans.series("inner")) == 2
    assert spans.series("inner")[0] >= 10.0


class _Graph:
    replays = 0

    def replay(self):
        _Graph.replays += 1


def test_a_capture_takes_host_counts_out_and_replays_add_them(monkeypatch):
    """``CapturedCall.capture`` and ``replay`` on the CPU, with the CUDA
    graph, its device context and its stream replaced by stand-ins."""
    monkeypatch.setattr(device_mod.torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(device_mod.torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(device_mod.torch.cuda, "device",
                        lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(device_mod, "_capture_stream", lambda dev: None)
    spans.reset()
    tt.reset_counts()
    spans.count("lanes", 7)
    tt.launches = 3
    call = device_mod.CapturedCall(torch.device("cpu"), "sample")

    def fn(static):
        spans.count("lanes", 64)
        tt.launches += 2
        tt.count_variant(("near", 0, "full", False))
        return "out"

    captures = device_mod.CapturedCall.captures
    call.capture(fn)
    assert device_mod.CapturedCall.captures == captures + 1
    assert spans.counter("capture") == 1
    assert spans.counter("lanes") == 7 and tt.launches == 3
    assert not tt.variant_launches
    assert call.counts == {"lanes": 64, "launches": 2,
                           ("variant_launches", ("near", 0, "full", False)):
                           1}
    for _ in range(3):
        assert call.replay() == "out"
    assert spans.counter("lanes") == 7 + 3 * 64 and tt.launches == 9
    assert tt.variant_launches == {("near", 0, "full", False): 3}
    assert spans.counter("capture") == 1
    spans.reset()


def test_tracing_on_renders_the_same_bits(tracing):
    cfg, ir = _scene()
    spans.enable(False)
    off = _render(cfg, ir)
    off_graph = dispatch.sample_graph(cfg, ir, cfg.x_res * cfg.y_res, 0,
                                      "cpu")
    spans.enable(True)
    on = _render(cfg, ir)
    assert dispatch.sample_graph(cfg, ir, cfg.x_res * cfg.y_res, 0,
                                 "cpu") is not off_graph
    for k in ("passes", "samples", "rng", "ray_count"):
        assert torch.equal(on[k], off[k]), k
    got = spans.report()
    assert got["spans"]["sample"]["device_count"] == 3
    assert got["spans"]["bounce"]["device_count"] == 3 * cfg.max_bounces
    assert got["errors"] == 0


def test_alive_lanes_are_the_alive_part_of_ray_count(tracing):
    cfg, ir = _scene()
    state = _render(cfg, ir, 2)
    got = spans.report()["counters"]
    npix = cfg.x_res * cfg.y_res
    assert got["lanes"] == 2 * cfg.max_bounces * npix
    # Every lane is alive at bounce 0; some die later.
    assert 2 * npix <= got["alive_lanes"] < got["lanes"]
    assert got["alive_lanes"] + got["shadow_lanes"] == float(
        state["ray_count"])


def test_a_span_lies_on_the_profilers_host_clock(tracing):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("aligned"):
            time.sleep(0.005)
    ours = spans.report()["spans"]["aligned"]["last_ns"]
    theirs = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "er.aligned"]
    assert len(theirs) == 1
    assert abs(theirs[0].start_ns() - ours[0]) < 50_000
    assert abs(theirs[0].end_ns() - ours[1]) < 50_000
    assert not theirs[0].is_user_annotation()


def test_off_spans_are_host_ranges_in_a_profiler_session():
    from torch.profiler import ProfilerActivity, profile

    assert not spans.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("seen"):
            pass
    assert [e.name for e in prof.events() if e.name == "er.seen"]
    assert "seen" not in spans.report()["spans"]


@pytest.mark.card
def test_stamps_accumulate_over_replays_without_a_host_sync(card, tracing):
    cfg, ir = _scene(card, grid=24, res=64)
    r = Renderer(cfg, ir, device=card)
    r.step(2)  # the warm-up sample, the capture, one replay
    spans.reset()
    torch.cuda.synchronize(card)
    torch.cuda.set_sync_debug_mode("error")
    try:
        r.step(5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = spans.report()
    assert got["errors"] == 0
    assert got["spans"]["sample"]["device_count"] == 5
    assert got["spans"]["bounce"]["device_count"] == 5 * cfg.max_bounces
    assert got["spans"]["replay"]["count"] == 5
    assert got["counters"]["lanes"] == 5 * cfg.max_bounces * 64 * 64
    assert len(spans.series("sample")) == 5


@pytest.mark.card
def test_a_samples_phases_sum_to_its_span(card, tracing):
    cfg, ir = _scene(card, grid=64, res=256)
    r = Renderer(cfg, ir, device=card)
    r.step(2)
    spans.reset()
    r.step(8)
    got = spans.report()["spans"]
    whole = got["sample"]["device_ms"]
    parts = sum(got[k]["device_ms"] for k in ("camera", "bounce",
                                              "accumulate"))
    assert parts == pytest.approx(whole, rel=0.02)
    bounce = got["bounce"]
    children = sum(got[k]["device_ms"] for k in ("traverse", "hitdata",
                                                 "shadow"))
    assert bounce["self_ms"] > 0
    assert bounce["self_ms"] + children <= bounce["device_ms"] * 1.02
