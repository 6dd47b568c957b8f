"""The readings that the limits of ``correct`` are set from, beside the
program's own: the control and the planted faults, at a cell's size.

    python3 renderbench/control.py --workload <cell> --seeds 1,2,3
        [--samples N]

The control is the plain reference put in the program's place and
computed in TF32 (``reference/quant.py``), the precision below the
float32 that the configurations state; the faults are planted in the
reference put in the program's place.  Each is judged as a run judges
the program (``renderbench/check.py``), against the float32 reference
on the same seed:

- progressive cells: the control after ``--samples`` samples (a run's
  count), and the faults: a state left unchanged (no sample
  accumulated), half the pixels never rendered, every sample's radiance
  altered by one part in a thousand where it is produced;
- inverse cells: the control, half the pixels left out of the loss (the
  mean taken over the rest), every sample's radiance altered by one part
  in a hundred; a state left unchanged reads 1 in ``update_norm_gap``
  by definition and needs no run.

Prints one JSON line per (seed, reading) and the time each took.  It
needs a CUDA card; the harness's tests call ``readings`` on the CPU at a
small size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from renderbench import check, manifest, scene  # noqa: E402
from renderbench.reference import grad, quant  # noqa: E402


def progressive(run, n_samples: int) -> dict:
    pix = check.pixels(run)
    ref_p, ref_s = check.reference_pixels(run, pix, n_samples)
    half = pix.shape[0] // 2
    out = {}

    def judge(name, p, s):
        out[name] = check.pixel_readings(p, s, ref_p, ref_s)

    judge("control", *check.reference_pixels(run, pix, n_samples,
                                             q=quant.tf32))
    judge("unchanged", torch.zeros_like(ref_p), torch.zeros_like(ref_s))
    p, s = ref_p.clone(), ref_s.clone()
    p[:, half:] = 0.0
    s[half:] = 0
    judge("half", p, s)
    judge("altered", *check.reference_pixels(
        run, pix, n_samples, fault=lambda light: light * 1.001))
    return out


def inverse(run) -> dict:
    steps = run["mix"]["checked_steps"]
    ref = grad.descend(run, steps)
    npix = run["target"].shape[0]
    out = {"control": check.training_readings(
        grad.descend(run, steps, q=quant.tf32), ref)}

    def keep_half(start, light):
        return light if start < npix // 2 else None

    out["half"] = check.training_readings(
        grad.descend(run, steps, fault=keep_half), ref)
    out["altered"] = check.training_readings(
        grad.descend(run, steps, fault=lambda s, light: light * 1.01), ref)
    return out


def readings(workload: str, seed: int, device, n_samples=None,
             adjust=None) -> dict:
    """{reading: {number: value}} of one seed."""
    cell = manifest.cell(manifest.load(), workload)
    run = {"seed": seed, "cfg": cell["config"], "mix": cell["mix"],
           "device": device}
    if adjust is not None:
        adjust(run)
    run["raw"] = scene.make(run["cfg"], seed)
    if run["mix"]["driver"] == "inverse":
        from renderbench.drivers import inverse as drv
        run["target"] = drv.target(run)
        return inverse(run)
    return progressive(run, n_samples)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--samples", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        got = readings(args.workload, seed, dev, args.samples)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "samples": args.samples, "readings": got,
                          "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
