"""BENCHMARK.json loads, keeps to the contract's shape, and every file a
cell needs is found by name."""

import json
import os
import re

import pytest

from renderbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_top_level_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["renderbench"]
    assert bench["command"] == ["python3", "renderbench/run.py"]
    size = os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json"))
    assert size <= 64 * 1024


def test_names_units_and_entries(bench):
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in bench[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in names
        names.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in bench["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0 < e["bound"] <= 0.25
    assert any(e["name"] == "setup_s" for e in bench["end_to_end"])
    e2e = {e["name"] for e in bench["end_to_end"]}
    for e in bench["per_layer"]:
        assert e["moves"] in e2e and "\n" not in e["layer"]


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        assert w["chips"] == 1
        cell = manifest.cell(bench, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert hasattr(cell["driver"], "window")
        assert set(cell["limits"]) >= {"pixels_off_share"} or \
            set(cell["limits"]) >= {"loss_gap"}
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(manifest.reader(m["name"]))


def test_configs_list_what_they_change(bench):
    for c in bench["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["changed"]) == set(c["reduced"])
        assert cfg["precision"] == "float32" and cfg["tf32"] is False
