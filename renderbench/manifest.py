"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads``) names a configuration and a traffic mix:

- ``renderbench/configs/<config>.json``: the configuration (its
  ``file`` in ``BENCHMARK.json``);
- ``renderbench/mixes/<traffic>.json``: the mix's parameters, whose
  ``driver`` key names ``renderbench/drivers/<driver>.py``;
- ``renderbench/limits/<cell>.json``: the limits of the cell's
  comparison with the reference;
- ``renderbench/metrics/<metric>.py``: the reader of each per-layer
  metric (``read(ctx)``, None when it finds nothing to read).

A later change adds a cell, a mix or a metric by adding files and
entries; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """Everything one run of cell ``name`` reads: the cell, its
    configuration, mix, driver module, limits and the metrics it
    reports (end-to-end and per-layer, as ``BENCHMARK.json`` lists
    them for it)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    mix = _json(HERE, "mixes", f"{w['traffic']}.json")

    def mine(metric):
        return name in metric.get("workloads", [name])

    return {
        "workload": w,
        "config": _json(root, cfg_entry["file"]),
        "mix": mix,
        "driver": importlib.import_module(f"renderbench.drivers.{mix['driver']}"),
        "limits": _json(HERE, "limits", f"{name}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def reader(metric: str):
    """The ``read`` function of ``renderbench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"renderbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
