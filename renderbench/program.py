"""The program's own spans and counters, for the per-layer metrics that
read them (``span.*``, ``alive_lane_share``, ``setup.kernels_s``).

    python3 -m renderbench.program --workload <cell> --seed <n>
        --seconds <s>

The port keeps spans and counters in one registry
(``elevenrender_tpu_torch/core/spans.py``), off unless turned on.  A
traced run (``run.py --trace 1``) reads its metrics after its window
and its profiler sessions, with tracing off all along: the window and
the sessions see the very graphs the untraced runs replay.  So the
program's spans come from a run of their own, a child process on the
same cell and seed, with the port's tracing on from its first line:
it makes the raw scene, has the port build it and lets the driver set
up, as a run does (the set-up's report: the kernel libraries' builds
and loads, the scene build, the captures), then runs the driver's
window for ``seconds`` with the stamps in the graphs (the window's
report: device time by span, the counters), under no profiler.  It
prints one JSON line: both reports, the window's notes and end-to-end
numbers with tracing on, and the ``sample`` span's series.

``report(ctx)`` runs that child once per process and cell, prints what
it read on standard error and returns it; None where there is nothing
to read: off the card, or with a port that has no span registry.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# The child's window, and the most its whole run may take.
WINDOW_S = 4.0
CHILD_TIMEOUT_S = 600

_reports: dict = {}


def collect(workload: str, seed: int, seconds: float, device,
            adjust=None) -> dict:
    """The traced run of ``workload`` on ``device`` (the child's work;
    the harness's tests call it on the CPU at a small size, ``adjust``
    as ``run.execute`` takes it)."""
    import torch

    from elevenrender_tpu_torch.core import spans

    from renderbench import manifest, port, scene

    spans.enable(True)
    try:
        cell = manifest.cell(manifest.load(), workload)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        driver = cell["driver"]
        run = {"seed": seed, "cfg": cell["config"], "mix": cell["mix"],
               "limits": cell["limits"], "device": device}
        if adjust is not None:
            adjust(run)
        run["raw"] = scene.make(run["cfg"], seed)
        run["config"], run["ir"] = port.build(run["raw"], device)
        st = driver.setup(run)
        setup = spans.report()
        spans.reset()
        win = driver.window(st, run, seconds)
        window = spans.report()
        series = spans.series("sample")
        driver.release(st)
    finally:
        spans.enable(False)
        spans.reset()
    return {"workload": workload, "seed": seed, "setup": setup,
            "window": window, "notes": win["notes"],
            "metrics": win["metrics"], "sample_series_ms": series}


def _seed() -> int:
    """The seed of the harness's own command line (``run.py``'s
    ``--seed``), which the readers' context does not carry."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def report(ctx) -> dict | None:
    """The child's report of ``ctx["cell"]`` (module docstring)."""
    if ctx["device"].type != "cuda":
        return None
    if importlib.util.find_spec("elevenrender_tpu_torch.core.spans") is None:
        return None
    cell = ctx["cell"]
    if cell not in _reports:
        _reports[cell] = _child(cell, _seed())
    return _reports[cell]


def _child(cell: str, seed: int) -> dict | None:
    t0 = time.perf_counter()
    try:
        done = subprocess.run(
            [sys.executable, "-m", "renderbench.program", "--workload", cell,
             "--seed", str(seed), "--seconds", str(WINDOW_S)],
            cwd=ROOT, capture_output=True, text=True,
            timeout=CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"program: the traced child ran over {CHILD_TIMEOUT_S} s",
              file=sys.stderr)
        return None
    wall = time.perf_counter() - t0
    lines = done.stdout.strip().splitlines()
    if done.returncode != 0 or not lines:
        print(f"program: the traced child failed (exit {done.returncode}) "
              f"after {wall:.1f} s:\n{done.stderr[-4000:]}", file=sys.stderr)
        return None
    got = json.loads(lines[-1])
    print(f"program: {json.dumps(summary(got))}; child {wall:.1f} s",
          file=sys.stderr)
    return got


def summary(got: dict) -> dict:
    """What the run's standard error shows of a report: device ms a
    sample by span, the counters, set-up host seconds by span, the
    traced window's notes and numbers, the sample series' quartiles."""
    import statistics

    win = got["window"]
    n = win["spans"].get("sample", {}).get("device_count") or 1
    series = got["sample_series_ms"]
    quart = (statistics.quantiles(series, n=4) if len(series) > 1
             else series)
    return {
        "device_ms_per_sample": {
            k: [round(v["device_ms"] / n, 4), round(v["self_ms"] / n, 4)]
            for k, v in win["spans"].items() if "device_ms" in v},
        "host_s": {k: round(v["host_s"], 4)
                   for k, v in win["spans"].items() if v["host_s"]},
        "counters": win["counters"], "errors": win["errors"],
        "setup_host_s": {k: round(v["host_s"], 4)
                         for k, v in got["setup"]["spans"].items()},
        "setup_counters": got["setup"]["counters"],
        "traced_window": {**got["notes"], **got["metrics"]},
        "sample_ms_quartiles": quart, "samples_in_series": len(series)}


def per_sample(ctx, span: str, key: str = "device_ms") -> float | None:
    """Device ms of ``span`` in the child's window per ``sample`` span
    (``key``: "device_ms" inclusive, "self_ms" self)."""
    got = report(ctx)
    if got is None:
        return None
    spans = got["window"]["spans"]
    n = spans.get("sample", {}).get("device_count")
    rec = spans.get(span, {})
    if not n or key not in rec:
        return None
    return rec[key] / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=WINDOW_S)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("renderbench.program needs a CUDA card", file=sys.stderr)
        return 1
    got = collect(args.workload, args.seed, args.seconds,
                  torch.device("cuda", 0))
    print(json.dumps(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
