"""PyTorch port, the scaling harness (``elevenrender_tpu_torch/
multichip_bench.py``, the port of ``scripts/multichip_bench.py``) on the
CPU.

The JAX script is not run (it imports jax at module level); its row and
summary keys are read from its source.  The harness runs on spawned
gloo ranks at N = 1 and 2 (RES 16, GRID 8, SPP 2): each row carries the
JAX script's keys and its arithmetic (``rays_per_sample = 2 *
max_bounces * RES^2``, rays/s per device, efficiency against N = 1); a
count that does not divide the pixels, or exceeds the devices, is
skipped as the JAX script skips it.  The sharded image itself is held to
one process and to JAX in ``test_torch_parallel.py``.
"""

from torch_threads import children  # first: torch's threads a worker

import ast
import json
import os

import pytest
import torch

from elevenrender_tpu_torch import multichip_bench as mb
from elevenrender_tpu_torch.scene.demo import heightfield_scene

from test_torch_bench import _dumped_keys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "multichip_bench.py")


def _row_keys():
    """The keys of the JAX script's ``row = {...}``."""
    tree = ast.parse(open(SCRIPT).read(), SCRIPT)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["row"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("no row literal in the JAX script")


@pytest.fixture(scope="module")
def run():
    """(rows, the printed lines) of the harness on 2 gloo ranks."""
    import contextlib
    import io
    out = io.StringIO()
    with children(), pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        for k, v in (("RES", "16"), ("GRID", "8"), ("SPP", "2")):
            mp.setenv(k, v)
        rows = mb.main(["--device", "cpu", "--devices", "2"])
    return rows, [json.loads(line) for line in out.getvalue().splitlines()]


def test_the_rows_carry_the_jax_keys_and_arithmetic(run):
    rows, lines = run
    assert lines[:-1] == rows
    assert [r["devices"] for r in rows] == [1, 2]
    _, config, _ = heightfield_scene(grid=8, res=16, compat=False,
                                     device="cpu")
    rays = 2.0 * config.max_bounces * 16 * 16
    for r in rows:
        assert set(r) == _row_keys()
        n, ms = r["devices"], r["ms_per_sample"]
        assert ms > 0
        # Each rounded number from the same s/sample within its rounding.
        assert r["rays_per_sec"] == pytest.approx(rays / ms * 1e3,
                                                  rel=0.06 / ms)
        assert r["rays_per_sec_per_device"] == pytest.approx(
            r["rays_per_sec"] / n, abs=0.1)
    assert rows[0]["scaling_efficiency_vs_1"] == 1.0
    assert rows[1]["scaling_efficiency_vs_1"] == pytest.approx(
        rows[1]["rays_per_sec"] / (2 * rows[0]["rays_per_sec"]), abs=1e-3)


def test_the_summary_line_has_the_jax_keys(run):
    rows, lines = run
    summary = lines[-1]
    assert _dumped_keys(SCRIPT)[""] | {"launches_rank0"} == set(summary)
    assert summary["platform"] == "cpu" and summary["max_devices"] == 2
    assert summary["efficiency_at_max"] == rows[-1]["scaling_efficiency_vs_1"]
    assert summary["launches_rank0"] == {"1": [0, 0], "2": [0, 0]}


def test_the_row_arithmetic_is_the_jax_scripts():
    row, rate = mb.scaling_row(1, 0.5, 1000.0, None)
    assert rate == 2000.0 and row == {
        "devices": 1, "ms_per_sample": 500.0, "rays_per_sec": 2000.0,
        "rays_per_sec_per_device": 2000.0, "scaling_efficiency_vs_1": 1.0}
    row, _ = mb.scaling_row(4, 0.2, 1000.0, 2000.0)
    assert row == {"devices": 4, "ms_per_sample": 200.0,
                   "rays_per_sec": 5000.0, "rays_per_sec_per_device": 1250.0,
                   "scaling_efficiency_vs_1": 0.625}


def test_counts_that_do_not_divide_the_pixels_are_skipped():
    assert mb.device_counts(16 * 16, 8) == [1, 2, 4, 8]
    assert mb.device_counts(15 * 15, 8) == [1]
    assert mb.device_counts(6 * 6, 8) == [1, 2, 4]
    assert mb.device_counts(16 * 16, 3) == [1, 2]


def test_more_devices_than_cards_are_refused():
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="no scaling"):
            mb.main(["--devices", str(torch.cuda.device_count() + 1)])
        return
    with pytest.raises(RuntimeError, match="cuda"):
        mb.main([])
