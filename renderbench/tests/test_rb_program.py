"""The readers of the program's own spans and counters
(``renderbench/program.py``): their numbers from a report, None off the
card or with a port that has no span registry, and the traced run of the
program's own on the CPU at a small size."""

import importlib.util

import pytest
import torch

from renderbench import manifest, program

PROGRESSIVE = "heightfield_hdri_65k.progressive"
INVERSE = "heightfield_hdri_65k.inverse"
SEED = 2**31 + 77

FAKE = {
    "setup": {"spans": {"kernels.build": {"count": 1, "host_s": 0.5},
                        "kernels.load": {"count": 3, "host_s": 0.25},
                        "scene.build": {"count": 1, "host_s": 1.0}},
              "counters": {}, "errors": 0},
    "window": {"spans": {
        "sample": {"count": 0, "host_s": 0.0, "device_count": 4,
                   "device_ms": 200.0, "self_ms": 1.0},
        "sort": {"device_count": 20, "device_ms": 8.0, "self_ms": 8.0},
        "hitdata": {"device_count": 20, "device_ms": 20.0, "self_ms": 2.0},
        "hitdata.texture": {"device_count": 40, "device_ms": 12.0,
                            "self_ms": 12.0},
        "bounce": {"device_count": 20, "device_ms": 180.0,
                   "self_ms": 140.0},
        "grad.pass1": {"device_count": 1, "device_ms": 400.0,
                       "self_ms": 0.0},
        "grad.pass2": {"device_count": 1, "device_ms": 480.0,
                       "self_ms": 480.0}},
        "counters": {"lanes": 1000, "alive_lanes": 600.0,
                     "shadow_lanes": 300.0},
        "errors": 0},
    "notes": {}, "metrics": {}, "sample_series_ms": [50.0] * 4}

READ = {  # metric -> (driver, its reading of FAKE)
    "span.sort_ms_per_spp": ("progressive", 2.0),
    "span.hitdata_ms_per_spp": ("progressive", 5.0),
    "span.texture_ms_per_spp": ("progressive", 3.0),
    "span.shade_ms_per_spp": ("progressive", 35.0),
    "alive_lane_share": ("progressive", 0.6),
    "span.grad_pass1_ms_per_spp": ("inverse", 100.0),
    "span.grad_pass2_ms_per_spp": ("inverse", 120.0),
    "setup.kernels_s": ("inverse", 0.75),
}


def _ctx(driver, device):
    return {"cell": PROGRESSIVE if driver == "progressive" else INVERSE,
            "driver": driver, "units": 1, "device": device}


def test_every_reader_is_declared():
    names = {m["name"] for m in manifest.load()["per_layer"]}
    assert set(READ) <= names


@pytest.mark.parametrize("metric", sorted(READ))
def test_a_reader_reads_the_report(metric, monkeypatch):
    driver, want = READ[metric]
    ctx = _ctx(driver, torch.device("cuda", 0))
    monkeypatch.setattr(program, "_reports", {ctx["cell"]: FAKE})
    assert manifest.reader(metric)(ctx) == pytest.approx(want)
    other = "inverse" if driver == "progressive" else "progressive"
    if metric != "setup.kernels_s":
        assert manifest.reader(metric)(_ctx(other, ctx["device"])) is None


@pytest.mark.parametrize("metric", sorted(READ))
def test_a_reader_finds_nothing_off_the_card(metric, monkeypatch):
    driver, _ = READ[metric]
    ctx = _ctx(driver, torch.device("cpu"))
    monkeypatch.setattr(program, "_reports", {ctx["cell"]: FAKE})
    assert manifest.reader(metric)(ctx) is None


def test_a_port_without_the_registry_gives_nothing(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name.endswith("core.spans")
        else real(name, *a))
    monkeypatch.setattr(program, "_child", lambda *a: pytest.fail("ran"))
    assert program.report(_ctx("progressive",
                               torch.device("cuda", 0))) is None


@pytest.mark.parametrize("cell", [PROGRESSIVE, INVERSE])
def test_the_programs_traced_run_on_the_cpu(cell, tiny):
    from elevenrender_tpu_torch.core import spans

    got = program.collect(cell, SEED, 0.3, torch.device("cpu"),
                          adjust=tiny)
    assert not spans.enabled()
    assert {"scene.build", "scene.bvh", "scene.upload"} <= set(
        got["setup"]["spans"])
    win = got["window"]
    n = win["spans"]["sample"]["device_count"]
    assert n >= 1 and win["errors"] == 0
    assert len(got["sample_series_ms"]) == n
    summary = program.summary(got)
    assert summary["samples_in_series"] == n
    if cell == INVERSE:
        assert {"grad.pass1", "grad.loss", "grad.pass2", "adam"} <= set(
            win["spans"])
    else:
        assert 0 < win["counters"]["alive_lanes"] <= win["counters"]["lanes"]
        assert win["spans"]["bounce"]["self_ms"] > 0
