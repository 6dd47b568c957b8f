"""One run of one cell of the port's benchmark.

    python3 renderbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration and
a traffic mix; ``renderbench/manifest.py`` finds their files.  A run:

1. makes the raw scene from the configuration and the seed
   (``renderbench/scene.py``) and hands it to the port, which builds
   its scene IR on the card (span ``setup.scene_s``, the port's build
   alone);
2. lets the mix's driver set up (span ``setup.warmup_s``): every shape
   the window uses is warmed up and captured here; ``setup_s`` runs from
   the harness's first line to the window's first queued unit;
3. runs the driver's window for ``--seconds``;
4. reads the peak device memory and takes the outputs that the check
   compares;
5. with ``--trace 1``, profiles units of the driver's work, one a
   session, and reads every per-layer metric of the cell with its reader
   (``renderbench/metrics/<metric>.py``);
6. frees the port's state and runs the plain reference
   (``renderbench/reference``), which decides ``correct``
   (``renderbench/check.py``);
7. prints each number compared beside its limit as the last lines of
   standard error, and the result as the last line of standard output.

It needs CUDA cards, as many as the cell asks for: without them it
exits 1 and prints no result.  So it does if ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded in this process at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "elevenrender_tpu")
# Build and kernel caches at fixed paths inside the checkout.
CACHES = {"TORCH_EXTENSIONS_DIR": "build/renderbench/torch_extensions",
          "TRITON_CACHE_DIR": "build/renderbench/triton"}


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port may not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device, chips: int, root: str = ROOT, adjust=None) -> dict:
    """The run on ``device``; returns the result line's object.
    ``adjust(run)``, if given, may change the run's configuration and mix
    before anything is built (the harness's CPU tests shrink them so)."""
    import torch

    from renderbench import manifest, port, scene, trace

    bench = manifest.load(root)
    cell = manifest.cell(bench, args.workload, root)
    # The configurations state float32 products without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = cell["driver"]
    run = {"seed": args.seed, "cfg": cell["config"], "mix": cell["mix"],
           "limits": cell["limits"], "device": device}
    if adjust is not None:
        adjust(run)
    spans = {}

    run["raw"] = scene.make(run["cfg"], args.seed)
    t = time.perf_counter()
    run["config"], run["ir"] = port.build(run["raw"], device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    spans["setup.scene_s"] = time.perf_counter() - t

    t = time.perf_counter()
    st = driver.setup(run)
    spans["setup.warmup_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START

    win = driver.window(st, run, args.seconds)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    out = driver.outputs(st, run)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": chips, "memory_peak_bytes": int(peak)}

    metrics, breakdown = {}, None
    if args.trace:
        fn, units = driver.unit(st, run)
        summ = trace.summary(trace.profile_units(fn, device))
        info["busy_s"] = summ["busy_s"]
        info["window_s"] = summ["window_s"]
        breakdown = summ["breakdown"]
        ctx = {"cell": args.workload, "driver": run["mix"]["driver"],
               "units": units, "summary": summ, "spans": spans,
               "raw": run["raw"], "cfg": run["cfg"], "device": device}
        for m in cell["per_layer"]:
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        found = {"setup_s": setup_s, **win["metrics"]}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": found[m["name"]],
                                  "unit": m["unit"]}

    driver.release(st)
    for k in ("ir", "config"):
        run.pop(k, None)
    del st
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    correct, checks = driver.judge(run, out)
    spans["check_s"] = time.perf_counter() - t
    print(f"window: {json.dumps(win['notes'])}; spans: {json.dumps(spans)}",
          file=sys.stderr)
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = _args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = os.path.join(ROOT, rel)
    import torch

    from renderbench import manifest
    bench = manifest.load()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(
        args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    return emit(execute(args, torch.device("cuda", 0), chips))


def emit(result: dict) -> int:
    """Refuses a process that holds a forbidden module (exit 3, no
    result); otherwise prints each compared number beside its limit on
    standard error and the result as the last line of standard output."""
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
