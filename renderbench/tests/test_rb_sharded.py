"""The sharded cell on the CPU: its configuration against its cell, the
driver's fast failures (a port whose ``Renderer`` takes no mesh, a rank
lost in the window), the link's byte count, the pixel mesh's readers on
a report and the program's traced run over gloo ranks."""

import multiprocessing as mp
import threading
import time

import pytest
import torch

from renderbench import linkcount, manifest, port, program, scene
from renderbench.drivers import sharded as drv

CELL = "config5_textured_1m_4card.sharded"
SEED = 2**31 + 77


def _run(tiny) -> dict:
    """A run of the cell on the CPU up to the driver's set-up, as
    ``run.execute`` makes it."""
    cell = manifest.cell(manifest.load(), CELL)
    run = {"seed": SEED, "cfg": cell["config"], "mix": cell["mix"],
           "limits": cell["limits"], "device": torch.device("cpu")}
    tiny(run)
    run["raw"] = scene.make(run["cfg"], SEED)
    run["config"], run["ir"] = port.build(run["raw"], run["device"])
    return run


def test_the_configurations_ranks_are_the_cells_chips():
    bench = manifest.load()
    cell = manifest.cell(bench, CELL)
    assert cell["config"]["ranks"] == cell["workload"]["chips"] == 4
    assert cell["mix"]["driver"] == "sharded"
    npix = cell["config"]["resolution"][0] * cell["config"]["resolution"][1]
    assert npix % cell["config"]["ranks"] == 0
    one = manifest.cell(bench, "config5_textured_1m.progressive")
    assert cell["limits"] == one["limits"]
    for key, value in one["config"].items():
        if key not in ("name", "source", "deployment", "changed",
                       "assumed"):
            assert cell["config"][key] == value, key


def test_a_port_without_a_mesh_fails_at_once(tiny, monkeypatch):
    from elevenrender_tpu_torch.render import renderer

    class Renderer:
        def __init__(self, config, ir, device=None):
            raise AssertionError("built")

    run = _run(tiny)
    monkeypatch.setattr(renderer, "Renderer", Renderer)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="takes no mesh"):
        drv.setup(run)
    assert time.monotonic() - t < 10.0
    assert mp.active_children() == []


def test_a_rank_killed_in_the_window_fails_the_run(tiny):
    run = _run(tiny)
    st = drv.setup(run)
    victim = st["procs"][-1]
    killer = threading.Timer(1.0, victim.kill)
    killer.start()
    t = time.monotonic()
    try:
        with pytest.raises(Exception):
            drv.window(st, run, 60.0)
        assert time.monotonic() - t < drv._timeout()
    finally:
        killer.cancel()
        drv.release(st)
    assert mp.active_children() == []


@pytest.mark.parametrize("ranks,passes,pixels,want", [
    (4, 5, 1024 * 1024, 3 * 262144 * (5 * 16 + 8)),
    (2, 5, 16 * 16, 128 * 88),
    (1, 5, 64, 0),
])
def test_linkcount_bytes_match_a_hand_count(ranks, passes, pixels, want):
    assert linkcount.gather_bytes(ranks, passes, pixels) == want
    assert linkcount.least_seconds(ranks, passes, pixels) == \
        pytest.approx(want / 450e9)


def test_linkcount_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        linkcount.gather_bytes(3, 5, 1024)


FAKE = {"setup": {"spans": {}, "counters": {}, "errors": 0},
        "window": {
            "spans": {"sample": {"device_count": 8, "device_ms": 80.0,
                                 "self_ms": 1.0},
                      "gather": {"device_count": 2, "device_ms": 3.0,
                                 "self_ms": 3.0},
                      "bounce": {"device_count": 40, "device_ms": 72.0,
                                 "self_ms": 48.0},
                      "sort": {"device_count": 40, "device_ms": 12.0,
                               "self_ms": 12.0}},
            "counters": {"gathers": 2, "ranks": 4, "gather_bytes": 10},
            "errors": 0,
            "ranks": [{"rank": r, "sample": {"device_ms": ms,
                                             "device_count": 8},
                       "lanes": 100, "alive_lanes": alive}
                      for r, (ms, alive) in enumerate(
                          [(80.0, 20.0), (40.0, 50.0), (60.0, 70.0),
                           (100.0, 60.0)])]},
        "notes": {}, "metrics": {}, "sample_series_ms": [10.0] * 8}
RAW = {"x_res": 1024, "y_res": 1024}
READ = {"rank_balance": 70.0 / 100.0,
        "span.image_gather_ms": 1.5,
        "image_gather_link_pct": 100.0 * 3 * 262144 * 88 / 450e9 / 1.5e-3,
        "alive_lane_share.sharded": 200.0 / 400.0}
# Rank 0's own spans, which a report without a mesh has too.
READ_RANK0 = {"span.shade_ms_per_spp.sharded": 6.0,
              "span.sort_ms_per_spp.sharded": 1.5}
# Rank 0's traced unit (renderbench/trace.py summary).
SUMMARY = {"busy_s": 0.018, "window_s": 0.024, "launches": 7013}
READ_TRACE = {"kernels_per_spp.sharded": 7013.0,
              "idle_pct.sharded": 25.0}
MESH_LAYER = {"rank_balance", "span.image_gather_ms",
              "image_gather_link_pct"}


def _ctx(driver, device):
    return {"cell": CELL, "driver": driver, "units": 1, "device": device,
            "raw": RAW, "summary": SUMMARY}


def test_the_mesh_readers_are_declared_for_the_cell_alone():
    bench = manifest.load()
    every = {**READ, **READ_RANK0, **READ_TRACE}
    for m in bench["per_layer"]:
        if m["name"] in every:
            assert m["workloads"] == [CELL]
            assert (m["layer"] == "pixel mesh") == (m["name"] in MESH_LAYER)
    assert set(every) <= {m["name"] for m in manifest.cell(
        bench, CELL)["per_layer"]}


@pytest.mark.parametrize("metric", sorted({**READ, **READ_RANK0}))
def test_a_mesh_reader_reads_the_report(metric, monkeypatch):
    monkeypatch.setattr(program, "_reports", {CELL: FAKE})
    ctx = _ctx("sharded", torch.device("cuda", 0))
    want = {**READ, **READ_RANK0}[metric]
    assert manifest.reader(metric)(ctx) == pytest.approx(want)
    assert manifest.reader(metric)(_ctx("progressive", ctx["device"])) \
        is None
    assert manifest.reader(metric)(_ctx("sharded", torch.device("cpu"))) \
        is None


@pytest.mark.parametrize("metric", sorted(READ))
def test_a_mesh_reader_finds_nothing_in_a_report_without_a_mesh(
        metric, monkeypatch):
    window = {k: v for k, v in FAKE["window"].items() if k != "ranks"}
    window["counters"] = {}
    monkeypatch.setattr(program, "_reports",
                        {CELL: {**FAKE, "window": window}})
    assert manifest.reader(metric)(
        _ctx("sharded", torch.device("cuda", 0))) is None


@pytest.mark.parametrize("metric", sorted(READ_TRACE))
def test_a_trace_reader_reads_rank_0s_unit(metric):
    ctx = _ctx("sharded", torch.device("cuda", 0))
    assert manifest.reader(metric)(ctx) == pytest.approx(READ_TRACE[metric])
    assert manifest.reader(metric)(_ctx("progressive", ctx["device"])) \
        is None
    ctx["summary"] = {"busy_s": 0.0, "window_s": 0.0, "launches": 0}
    assert manifest.reader(metric)(ctx) is None


def test_the_programs_traced_run_of_the_mesh_on_the_cpu(tiny):
    got = program.collect(CELL, SEED, 0.3, torch.device("cpu"), adjust=tiny)
    win = got["window"]
    assert win["counters"]["ranks"] == 4
    assert [r["rank"] for r in win["ranks"]] == [0, 1, 2, 3]
    assert all(r["sample"]["device_count"] == win["spans"]["sample"][
        "device_count"] for r in win["ranks"])
    n = win["counters"]["gathers"]
    assert n == got["notes"]["samples"] // 4 >= 1
    assert win["counters"]["gather_bytes"] == n * linkcount.gather_bytes(
        4, 5, 16 * 16)
    assert win["spans"]["gather"]["device_count"] == n
    assert got["setup"]["ranks"] and win["errors"] == 0
