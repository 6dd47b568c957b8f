"""Tiny runs of every cell's mix through the harness on the CPU: the
result line's keys, the reference's agreement with the port, and
``correct`` coming out false with the timed path broken underneath."""

import argparse
import json
import sys
import types

import pytest
import torch

from renderbench import manifest, run

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2**31 + 77


def execute(cell, tiny, seconds=0.3, trace=0):
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=seconds,
                              trace=trace)
    return run.execute(args, torch.device("cpu"), 1, adjust=tiny)


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contracts_keys(cell, tiny, capsys):
    assert run.emit(execute(cell, tiny)) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(line)
    assert list(result) == KEYS
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    bench = manifest.cell(manifest.load(), cell)
    assert set(result["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}


def test_a_traced_run_reads_the_span_metrics(tiny):
    result = execute(CELLS[0], tiny, trace=1)
    assert list(result)[-2:] == ["breakdown", "checks"]
    # No device here: the device-trace readers find nothing and are
    # left out; the harness's spans are read.
    assert set(result["metrics"]) == {"setup.scene_s", "setup.warmup_s"}
    assert {"busy_s", "window_s"} <= set(result["device"])


def test_a_forbidden_module_refuses_the_run(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert run.forbidden_modules() == ["jax"]
    assert run.emit({"checks": {}}) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_port(cell, tiny):
    checks = execute(cell, tiny)["checks"]
    if "pixels_off_share" in checks:
        assert checks["pixels_off_share"]["value"] == 0.0
        assert checks["gap_p90"]["value"] == 0.0
    else:
        assert all(c["value"] < 1e-5 for c in checks.values())


def _progressive_faults(monkeypatch, fault):
    from elevenrender_tpu_torch.render import dispatch, integrator
    render_sample = dispatch.render_sample
    if fault == "unchanged":
        monkeypatch.setattr(dispatch, "render_sample",
                            lambda config, ir, st, *a, **k: dict(st))
    elif fault == "half":
        def half(config, ir, st, *a, **k):
            new = render_sample(config, ir, st, *a, **k)
            n = st["samples"].shape[0] // 2
            out = {k2: v.clone() for k2, v in new.items()}
            out["passes"][:, n:] = st["passes"][:, n:]
            out["samples"][n:] = st["samples"][n:]
            return out
        monkeypatch.setattr(dispatch, "render_sample", half)
    else:
        sample_radiance = integrator.sample_radiance

        def altered(*a, **k):
            out, rng = sample_radiance(*a, **k)
            return {**out, "light": out["light"] * 1.001}, rng
        monkeypatch.setattr(integrator, "sample_radiance", altered)


def _inverse_faults(monkeypatch, fault):
    from elevenrender_tpu_torch import inverse_demo
    from elevenrender_tpu_torch.render import grad, integrator
    if fault == "unchanged":
        monkeypatch.setattr(inverse_demo.Adam, "step",
                            lambda self, params, grads: params)
    elif fault == "half":
        loss_and_seed = grad._loss_and_seed

        def half(state, target):
            n = target.shape[0] // 2
            st = {k: v[..., :n, :] if k == "passes" else v[:n]
                  for k, v in state.items() if k in ("passes", "samples")}
            loss, seed = loss_and_seed(st, target[:n])
            return loss, torch.cat([seed, torch.zeros_like(seed)])
        monkeypatch.setattr(grad, "_loss_and_seed", half)
    else:
        sample_radiance = integrator.sample_radiance

        def altered(*a, **k):
            out, rng = sample_radiance(*a, **k)
            return {**out, "light": out["light"] * 1.01}, rng
        monkeypatch.setattr(integrator, "sample_radiance", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny, monkeypatch):
    if "inverse" in cell:
        _inverse_faults(monkeypatch, fault)
    else:
        _progressive_faults(monkeypatch, fault)
    assert execute(cell, tiny)["correct"] is False


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_fault_in_the_window_alone_is_not_correct(fault, tiny,
                                                    monkeypatch):
    """The inverse cell's set-up steps run sound and only the window's
    steps break: the reference's following of the window's last steps
    finds it."""
    from elevenrender_tpu_torch import inverse_demo
    from elevenrender_tpu_torch.render import integrator
    from renderbench.drivers import inverse as drv

    live = {"on": False}
    window = drv.window

    def broken_window(st, run, seconds):
        live["on"] = True
        return window(st, run, seconds)

    monkeypatch.setattr(drv, "window", broken_window)
    if fault == "unchanged":
        adam_step = inverse_demo.Adam.step
        monkeypatch.setattr(
            inverse_demo.Adam, "step",
            lambda self, p, g: p if live["on"] else adam_step(self, p, g))
    else:
        sample_radiance = integrator.sample_radiance

        def altered(*a, **k):
            out, rng = sample_radiance(*a, **k)
            if live["on"]:
                out = {**out, "light": out["light"] * 1.01}
            return out, rng
        monkeypatch.setattr(integrator, "sample_radiance", altered)
    cell = next(c for c in CELLS if "inverse" in c)
    result = execute(cell, tiny)
    assert result["attempted"] >= 2
    assert result["correct"] is False
