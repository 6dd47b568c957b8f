"""Render the demo scenes to PNG: the framework's showcase script.

    python3 -m elevenrender_tpu_torch.demo [outdir] [res] [spp] [--device cpu]

Port of ``scripts/demo.py`` (defaults ``out``, 256 and 32): the Cornell
box (``scene/demo.cornell_scene``) and the grid-96 heightfield
(``heightfield_scene``), native mode, each through
``Renderer.step(spp)`` (on the card one eager warm-up sample, the
capture, then replays) and ``save_pass`` of the beauty, normal and
denoise passes: ``NAME.png``, ``NAME_normal.png`` and
``NAME_denoised.png``.  The JAX script renders on the CPU unless
``ELEVENRT_DEVICE`` names another device; this one renders on the card
unless asked for the CPU.

After the JAX script's line a scene, one JSON line: each scene's s, its
closest-hit and any-hit traversal launches (the launch accounting; the
Cornell box's 12 tris take the brute-force test and launch none), and
whether the three passes it saved were finite before the PNG's
clipping.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .core.device import resolve_device
from .ops import traverse as traverse_ops
from .render.renderer import Renderer
from .scene.demo import cornell_scene, heightfield_scene

# The passes saved for each scene, and their file names' suffixes.
PASSES = (("beauty", ""), ("normal", "_normal"), ("denoise", "_denoised"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?", default="out")
    ap.add_argument("res", nargs="?", type=int, default=256)
    ap.add_argument("spp", nargs="?", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res, spp, outdir = args.res, args.spp, args.outdir
    dev = resolve_device(args.device)
    os.makedirs(outdir, exist_ok=True)
    scenes = {}
    for name, build in (
            ("cornell", lambda: cornell_scene(res=res, spp=spp, compat=False,
                                              device=dev)),
            ("heightfield", lambda: heightfield_scene(
                grid=96, res=res, spp=spp, compat=False, device=dev))):
        t0 = time.perf_counter()
        traverse_ops.reset_counts()
        _, config, ir = build()
        r = Renderer(config, ir, dev)
        r.step(spp)
        for pass_name, suffix in PASSES:
            r.save_pass(pass_name, os.path.join(outdir, f"{name}{suffix}.png"))
        seconds = time.perf_counter() - t0
        print(f"{name}: {res}x{res} {spp}spp in {seconds:.1f}s", flush=True)
        scenes[name] = {
            "s": seconds,
            "launches": [traverse_ops.launches - traverse_ops.any_hit_launches,
                         traverse_ops.any_hit_launches],
            "finite": all(bool(np.isfinite(r.get_pass(p)).all())
                          for p, _ in PASSES)}
    print(json.dumps({"demo": scenes}), flush=True)
    return scenes


if __name__ == "__main__":
    main()
