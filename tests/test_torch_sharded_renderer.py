"""PyTorch port, ``Renderer(config, ir, mesh=...)`` on spawned gloo ranks
on the CPU: the pixel-sharded progressive render on the normal path.

The scene is BASELINE config 5's in miniature, as the benchmark makes it
(``renderbench/configs/config5_textured_1m.json`` at grid 10 and 16x16,
its raw scene from ``renderbench/scene.py`` built by
``renderbench/port.py``): an albedo map, a normal map, a point light and
the sky, with the ray count on.  Each rank builds it itself, renders its
slice for a few samples and reads back; the ranks are held to the
renderer in one process (every pass and sample count bit for bit, the
ray count summed), to the benchmark's plain reference on its checked
pixels (``renderbench/check.py``, within the sharded cell's limits), and
to the readback's contract: the image on rank 0, ``None`` elsewhere,
the ``gather`` span and counters, the ranks' totals in the report, and
the refusal of what needs the whole state in one process.
"""

from torch_threads import children  # first: torch's threads a worker

import json
import os

import numpy as np
import pytest
import torch

from elevenrender_tpu_torch.core import spans
from elevenrender_tpu_torch.parallel import dryrun
from elevenrender_tpu_torch.parallel import mesh as pm
from elevenrender_tpu_torch.render import dispatch
from elevenrender_tpu_torch.render.integrator import PASSES_COUNT
from elevenrender_tpu_torch.render.renderer import Renderer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "config5_textured_1m_4card.sharded"
SEED = 2**31 + 11
SAMPLES = 3
JOIN_S = 120.0


def _cfg() -> dict:
    with open(os.path.join(REPO, "renderbench", "configs",
                           "config5_textured_1m.json")) as f:
        cfg = json.load(f)
    cfg["heightfield"] = dict(cfg["heightfield"], grid=10)
    cfg["resolution"] = [16, 16]
    return cfg


def _scene(device):
    from renderbench import port, scene
    raw = scene.make(_cfg(), SEED)
    config, ir = port.build(raw, device)
    return raw, config.replace(count_rays=True), ir


def _numpy(d):
    return None if d is None else {k: v.cpu().numpy() for k, v in d.items()}


def _render(renderer, task) -> dict:
    """Samples, then every readback, with tracing on; what each gave."""
    spans.reset()
    spans.enable(True)
    try:
        renderer.step(task["samples"])
        image = _numpy(renderer.read_image())
        beauty = renderer.get_pass("beauty")
        normal = renderer.get_pass("normal")
        info = renderer.get_render_info()
        report = spans.report()
    finally:
        spans.enable(False)
        spans.reset()
    return {"image": image, "beauty": beauty, "normal": normal,
            "info": info, "report": report}


def _refusals(renderer, path) -> dict:
    """The message of each call refused on a mesh (None if it ran)."""
    got = {}
    for what, call in (("start", renderer.start),
                       ("save_checkpoint",
                        lambda: renderer.save_checkpoint(path)),
                       ("load_checkpoint",
                        lambda: renderer.load_checkpoint(path)),
                       ("profile", lambda: renderer.profile(path, 1))):
        try:
            call()
            got[what] = None
        except NotImplementedError as e:
            got[what] = str(e)
    return got


def _readback_order(renderer) -> list:
    """The spans opened and the all-reduces run by one ``read_image``,
    in order: "ready" for the readiness mark, "reduce" for any other."""
    from elevenrender_tpu_torch.render import renderer as rmod
    log = []
    reduce, span = rmod.all_reduce_sum, spans.span

    def logged_reduce(t, mesh):
        log.append("ready" if t is renderer._ready else "reduce")
        return reduce(t, mesh)

    def logged_span(name, *a):
        log.append(name)
        return span(name, *a)

    rmod.all_reduce_sum, spans.span = logged_reduce, logged_span
    try:
        renderer.read_image()
    finally:
        rmod.all_reduce_sum, spans.span = reduce, span
    return log


def rank_work(mesh, task) -> dict:
    """One rank: the scene, a ``Renderer`` on its mesh, ``_render``;
    then a renderer without a mesh, after which the last rank reports
    alone."""
    _, config, ir = _scene(mesh.device)
    renderer = Renderer(config, ir, mesh=mesh)
    out = _render(renderer, task)
    out["readback_order"] = _readback_order(renderer)
    out["refused"] = _refusals(
        renderer, os.path.join(task["dir"], f"rank{mesh.rank}.npz"))
    out["files"] = sorted(os.listdir(task["dir"]))
    Renderer(config, ir, mesh.device)
    if mesh.rank == mesh.world - 1:
        out["alone"] = sorted(spans.report())
    return out


@pytest.fixture(scope="module")
def one_process():
    raw, config, ir = _scene("cpu")
    out = _render(Renderer(config, ir, "cpu"), {"samples": SAMPLES})
    return raw, out


def _spawn(world, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"sharded{world}")
    task = {"samples": SAMPLES, "dir": str(tmp / "out")}
    os.makedirs(task["dir"])
    with children():
        return world, dryrun.run_ranks(
            task, world, "cpu", init_method=f"file://{tmp / 'store'}",
            timeout=JOIN_S, work=rank_work)


@pytest.fixture(scope="module")
def sharded2(tmp_path_factory):
    return _spawn(2, tmp_path_factory)


@pytest.fixture(scope="module")
def sharded4(tmp_path_factory):
    return _spawn(4, tmp_path_factory)


@pytest.fixture(params=[2, 4])
def sharded(request):
    return request.getfixturevalue(f"sharded{request.param}")


def test_a_mesh_renders_the_one_process_image_bit_for_bit(sharded,
                                                          one_process):
    world, ranks = sharded
    _, want = one_process
    got = ranks[0]["image"]
    assert got["passes"].shape == (PASSES_COUNT, 16 * 16, 4)
    assert np.isfinite(got["passes"]).all()
    assert got["passes"][0, :, :3].max() > 0.0
    np.testing.assert_array_equal(got["passes"], want["image"]["passes"])
    np.testing.assert_array_equal(got["samples"], want["image"]["samples"])
    assert (got["samples"] == SAMPLES).all()
    np.testing.assert_array_equal(ranks[0]["beauty"], want["beauty"])
    np.testing.assert_array_equal(ranks[0]["normal"], want["normal"])
    assert ranks[0]["info"] == want["info"] == {"samples": SAMPLES}


def test_readback_is_the_image_on_rank_0_and_none_elsewhere(sharded):
    world, ranks = sharded
    assert len(ranks) == world
    for r in ranks[1:]:
        assert r["image"] is None and r["beauty"] is None
        assert r["normal"] is None and r["info"] is None
    assert ranks[0]["image"] is not None


def test_the_ray_count_sums_over_the_ranks(sharded, one_process):
    _, ranks = sharded
    _, want = one_process
    count = float(ranks[0]["image"]["ray_count"])
    assert count > 0
    assert count == float(want["image"]["ray_count"])


def test_the_gather_span_counters_and_the_ranks_report(sharded,
                                                       one_process):
    world, ranks = sharded
    _, alone = one_process
    npix, local = 16 * 16, 16 * 16 // world
    # read_image: five passes and the sample counts; then one pass twice.
    slice_bytes = local * (PASSES_COUNT * 16 + 8) + 2 * local * 16
    for r in ranks:
        rep = r["report"]
        assert rep["counters"]["gathers"] == 3
        assert rep["counters"]["ranks"] == world
        assert rep["spans"]["gather"]["device_count"] == 3
        assert rep["spans"]["gather"]["device_ms"] > 0
        every = rep["ranks"]
        assert [e["rank"] for e in every] == list(range(world))
        for e in every:
            assert e["sample"]["device_count"] == SAMPLES
            assert e["sample"]["device_ms"] > 0
            assert e["lanes"] == alone["report"]["counters"]["lanes"] // world
        assert sum(e["alive_lanes"] for e in every) == \
            alone["report"]["counters"]["alive_lanes"]
    assert ranks[0]["report"]["counters"]["gather_bytes"] == \
        (world - 1) * slice_bytes
    assert all("gather_bytes" not in r["report"]["counters"]
               for r in ranks[1:])
    assert npix == world * local
    # One process gathers nothing and reports no ranks.
    assert "gathers" not in alone["report"]["counters"]
    assert "ranks" not in alone["report"]


def test_the_gather_span_opens_after_every_rank_is_ready(sharded):
    """The span holds the transfer and the joining: the readiness
    all-reduce, which ends when every rank has reached it, runs just
    before it opens (after the ray count's sum)."""
    _, ranks = sharded
    for r in ranks:
        assert r["readback_order"] == ["readback", "reduce", "ready",
                                       "gather"]


def test_a_renderer_without_a_mesh_makes_the_report_local(sharded):
    world, ranks = sharded
    assert ranks[-1]["alone"] == ["counters", "errors", "spans"]
    assert all("alone" not in r for r in ranks[:-1])


def test_what_needs_the_whole_state_is_refused_on_a_mesh(sharded):
    world, ranks = sharded
    for r in ranks:
        assert set(r["refused"]) == {"start", "save_checkpoint",
                                     "load_checkpoint", "profile"}
        for what, msg in r["refused"].items():
            assert msg is not None and f"{world} ranks" in msg, what
        # No rank wrote its slice as if it were the image.
        assert r["files"] == []


@pytest.mark.parametrize("world", [2, 4])
def test_the_checked_pixels_agree_with_the_reference(world, one_process,
                                                     request):
    from renderbench import check
    with open(os.path.join(REPO, "renderbench", "limits",
                           f"{CELL}.json")) as f:
        limits = json.load(f)
    _, ranks = request.getfixturevalue(f"sharded{world}")
    raw, _ = one_process
    run = {"raw": raw, "seed": SEED, "mix": {"check_pixels": 64},
           "device": torch.device("cpu"), "limits": limits}
    image = ranks[0]["image"]
    pix = check.pixels(run)
    out = {"pix": pix, "n_samples": SAMPLES,
           "passes": torch.from_numpy(image["passes"])[:, pix, :3],
           "samples": torch.from_numpy(image["samples"])[pix]}
    correct, checks = check.progressive(run, out)
    assert correct, checks
    assert checks["pixels_off_share"]["value"] == 0.0


def test_a_one_process_mesh_is_the_renderer_without_one(one_process):
    raw, want = one_process
    _, config, ir = _scene("cpu")
    mesh = pm.make_mesh(device="cpu")
    assert mesh.group is None and mesh.world == 1
    got = _render(Renderer(config, ir, mesh=mesh), {"samples": SAMPLES})
    np.testing.assert_array_equal(got["image"]["passes"],
                                  want["image"]["passes"])
    assert got["info"] == want["info"]
    assert "ranks" not in got["report"]


def test_without_a_mesh_the_recorded_launches_are_unchanged(monkeypatch):
    """``Renderer.step`` without a mesh runs the very sample it ran
    before meshes: the capture keyed on the whole image at offset 0, and
    the same ops in the same order as the dispatch's own call."""
    from torch.profiler import ProfilerActivity, profile

    _, config, ir = _scene("cpu")
    keys = []
    real = dispatch.sample_graph

    def spy(config, ir, npix, pixel_offset=0, *a, **k):
        keys.append((npix, pixel_offset))
        return real(config, ir, npix, pixel_offset, *a, **k)

    monkeypatch.setattr(dispatch, "sample_graph", spy)

    def ops(fn):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        return [e.name for e in prof.events() if e.name.startswith("aten::")]

    renderer = Renderer(config, ir, "cpu")
    renderer.step(1)  # the cache entry's first run: its buffers made
    before = renderer.state
    via_renderer = ops(lambda: renderer.step(1))
    direct = ops(lambda: dispatch.render_samples_jit_safe(
        config, ir, before, 1, device="cpu"))
    assert keys == [(16 * 16, 0)] * 3
    assert len(direct) > 100 and via_renderer == direct
