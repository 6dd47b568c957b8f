"""PyTorch port, the bench (``elevenrender_tpu_torch/bench.py``) and its
config-5 stage (``bench_config5.py``) on the CPU at a small shape.

The line each prints is held to the JAX repo's programs: its keys are
those of the ``json.dumps`` literal in ``bench.py`` and in
``scripts/bench_config5.py`` (read from their sources with ``ast``, never
run), plus the port's own: ``device`` and ``spread`` in ``extra``,
``config5_spread`` in the stage's line.  Every number is finite and
positive.  On the card ``chip_smoke.py`` runs the bench at its full
shape.
"""

import ast
import json
import math
import os

import pytest
import torch

from elevenrender_tpu_torch import bench, bench_config5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = {"BENCH_RES": "16", "BENCH_GRID": "8", "BENCH_SPP": "2",
         "BENCH_GRID5": "20"}


def _dumped_keys(path):
    """The keys of the dict literal that ``path`` passes to
    ``json.dumps``: {"": top-level keys, key: the keys of a nested dict
    literal}; a ``**`` entry is left out."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            lit = node.args[0]
            out = {"": {k.value for k in lit.keys if k is not None}}
            for k, v in zip(lit.keys, lit.values):
                if k is not None and isinstance(v, ast.Dict):
                    out[k.value] = {kk.value for kk in v.keys
                                    if kk is not None}
            return out
    raise AssertionError(f"no json.dumps of a dict literal in {path}")


def _numbers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


def _last_line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def small(monkeypatch, tmp_path):
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, "BASELINE", str(tmp_path / "absent.json"))
    return tmp_path


def test_the_bench_line_has_bench_py_keys(small, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_CONFIG5", "0")
    line = bench.main(device="cpu")
    assert _last_line(capsys) == line
    want = _dumped_keys(os.path.join(REPO, "bench.py"))
    assert set(line) == want[""]
    assert set(line["extra"]) == want["extra"] | {"device", "spread"}
    assert set(line["extra"]["spread"]) == {
        "value", "fwd_rays_per_sec", "fwd_bwd_1spp_rays_per_sec"}
    assert line["unit"] == "rays/s" and line["vs_baseline"] == 1.0
    assert line["extra"]["device"] == "cpu"
    assert line["extra"]["fwd_samples_per_dispatch"] == 8
    assert 0 < line["extra"]["alive_fraction"] <= 1
    for x in _numbers(line):
        assert math.isfinite(x) and x > 0
    for lo, hi in line["extra"]["spread"].values():
        assert lo <= hi


def test_the_config5_line_has_the_jax_stage_keys(small, capsys):
    line = bench_config5.main(device="cpu")
    assert _last_line(capsys) == line
    want = _dumped_keys(os.path.join(REPO, "scripts", "bench_config5.py"))
    assert set(line) == want[""] | {"config5_spread"}
    assert set(line["config5_spread"]) == {
        "config5_rays_per_sec", "config5_fwd_bwd_rays_per_sec"}
    assert line["config5_tris"] == 2 * 19 * 19
    assert line["config5_trace_mode"] == "bvh"
    assert 0 < line["config5_alive_fraction"] <= 1
    for x in _numbers(line):
        assert math.isfinite(x) and x > 0


def test_the_bench_folds_the_config5_subprocess_in(small, monkeypatch,
                                                    capsys):
    """The stage runs as a subprocess on the bench's device and its keys
    land in ``extra``; ``vs_baseline`` is the headline over the baseline
    file's ``fwd_bwd_rays_per_sec``."""
    base = small / "baseline.json"
    base.write_text(json.dumps({"fwd_bwd_rays_per_sec": 1000.0}))
    monkeypatch.setattr(bench, "BASELINE", str(base))
    line = bench.main(device="cpu")
    assert _last_line(capsys) == line
    extra = line["extra"]
    assert "config5_error" not in extra, extra.get("config5_error")
    stage = _dumped_keys(os.path.join(REPO, "scripts", "bench_config5.py"))
    assert stage[""] | {"config5_spread"} <= set(extra)
    assert extra["config5_tris"] == 2 * 19 * 19
    assert line["vs_baseline"] == pytest.approx(line["value"] / 1000.0,
                                                abs=1e-3)


class _FirstSample(Exception):
    pass


@pytest.mark.parametrize("stage", ["main", "config5"])
def test_only_the_main_scene_reads_the_ab_knobs(small, monkeypatch, stage):
    """BENCH_ORDER, BENCH_DIRMAJOR and BENCH_SHADOW_SUB set the main
    scene's config, as ``bench.py`` sets its own; the config-5 stage
    reads none of them, as ``scripts/bench_config5.py`` reads none.  The
    config is taken at each stage's first sample, which ends it."""
    from elevenrender_tpu_torch.render import dispatch
    seen = []

    def first_sample(config, *args, **kwargs):
        seen.append(config)
        raise _FirstSample

    monkeypatch.setattr(dispatch, "render_samples_jit", first_sample)
    monkeypatch.setenv("BENCH_ORDER", "sign")
    monkeypatch.setenv("BENCH_DIRMAJOR", "1")
    monkeypatch.setenv("BENCH_SHADOW_SUB", "2")
    with pytest.raises(_FirstSample):
        if stage == "main":
            bench.main_scene(torch.device("cpu"), 16, 2, 8)
        else:
            bench_config5.main(device="cpu")
    got = (seen[0].trace_order, seen[0].sort_dir_major,
           seen[0].shadow_pallas_sub)
    if stage == "main":
        assert got == ("sign", True, 2)
    else:
        default = type(seen[0])()
        assert got == (default.trace_order, default.sort_dir_major,
                       default.shadow_pallas_sub) != ("sign", True, 2)


def test_a_failed_config5_stage_is_reported(small, monkeypatch):
    """A stage that exits non-zero comes back as ``config5_error``, with
    no number: nothing falls back."""
    monkeypatch.setenv("BENCH_GRID5", "not a number")
    got = bench.config5_stage(torch.device("cpu"))
    assert list(got) == ["config5_error"]
    assert got["config5_error"].startswith("exit 1")


def test_the_bench_needs_a_card_unless_told_cpu(small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main()
    with pytest.raises(RuntimeError, match="cuda"):
        bench_config5.main()
