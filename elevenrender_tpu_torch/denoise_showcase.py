"""Denoised beauty PNG from a render checkpoint.

    CKPT=.runlogs/config5.npz OUT=.runlogs/config5_denoised.png \\
        python3 -m elevenrender_tpu_torch.denoise_showcase [--device cpu] [--raw IMAGE.npy]

Port of ``scripts/denoise_showcase.py``: the reference's showcase image
is "1000 samples and denoised"; this one goes through the multi-scale
guided NL-means (``render/denoise.nlm_denoise_ms``).  ``CKPT`` (default
``.runlogs/config5.npz``, a checkpoint of ``render_config5`` or of the
JAX script) gives beauty (pass 0), the first-hit albedo (pass 1, the
DENOISE slot) and the normal (pass 2); ``OUT`` (default ``CKPT`` with
``_denoised.png``) receives |denoised| to the power 1/2.2, clipped,
alpha 1.  ``--raw`` also saves the denoised float32 image [H, W, 3].

The JAX script forces the CPU; this one runs on the card unless asked
for the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .core.device import resolve_device
from .render.denoise import nlm_denoise_ms
from .utils.image import gamma_png, write_png


def load_planes(path: str, device="cuda"):
    """(beauty, albedo, normal) [res, res, 3] on ``device``, res and the
    samples done, from the checkpoint at ``path``."""
    dev = resolve_device(device)
    data = np.load(path)
    passes = data["passes"]
    res = int(round(passes.shape[1] ** 0.5))

    def plane(i):
        return torch.tensor(passes[i, :, :3].reshape(res, res, 3),
                            device=dev)

    return plane(0), plane(1), plane(2), res, int(data["samples"].max())


def denoise_planes(beauty, albedo, normal) -> np.ndarray:
    """The denoised beauty, float32 [res, res, 3] on the host."""
    with torch.no_grad():
        return nlm_denoise_ms(beauty, normal, albedo).cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--raw", default=None,
                    help="also save the denoised float32 image (.npy)")
    args = ap.parse_args(argv)
    ckpt = os.environ.get("CKPT", ".runlogs/config5.npz")
    out = os.environ.get("OUT", ckpt.replace(".npz", "_denoised.png"))
    t0 = time.perf_counter()
    beauty, albedo, normal, res, spp = load_planes(ckpt, args.device)
    t1 = time.perf_counter()
    img = denoise_planes(beauty, albedo, normal)
    t2 = time.perf_counter()
    write_png(out, gamma_png(img))
    if args.raw:
        np.save(args.raw, img)
    print(f"{out}: {res}x{res} at {spp} spp, denoised (multi-scale guided "
          f"NL-means); loaded in {t1 - t0:.3f} s, denoised in "
          f"{t2 - t1:.3f} s, written in {time.perf_counter() - t2:.3f} s",
          flush=True)


if __name__ == "__main__":
    main()
