"""Progressive rendering over a built scene IR.

Port of the synchronous part of ``elevenrender_tpu/render/renderer.py``:
``step``, ``get_pass`` (beauty, normal, tangent, bitangent) and
``get_render_info``.  The background render thread, checkpoints,
profiling and the denoiser come with later slices; the ``"denoise"``
pass and ``config.denoise`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import ir_to
from ..core.device import resolve_device
from .integrator import (BEAUTY, BITANGENT, DENOISE, NORMAL, TANGENT,
                         init_state, render_sample)

_PASS_NAMES = {"beauty": BEAUTY, "denoise": DENOISE, "normal": NORMAL,
               "tangent": TANGENT, "bitangent": BITANGENT}


def parse_pass(name: str) -> int:
    """Case-insensitive pass name; unknown names mean beauty."""
    return _PASS_NAMES.get(name.lower(), BEAUTY)


class Renderer:
    """Progressive path tracer: ``step(n)`` adds n samples per pixel."""

    def __init__(self, config, ir, device="cuda"):
        self.device = resolve_device(device)
        if config.denoise:
            raise NotImplementedError("config.denoise: the denoiser is not "
                                      "ported yet")
        self.config = config
        self.ir = ir_to(ir, self.device)
        self.state = init_state(config, self.device)

    def step(self, n: int = 1) -> None:
        """Run n progressive samples.  No autograd graph is built, even
        if a scene tensor requires grad: the accumulators would otherwise
        hold the graph of every sample (gradients are ``render/grad.py``'s
        entry points)."""
        with torch.no_grad():
            for _ in range(n):
                self.state = render_sample(self.config, self.ir, self.state,
                                           device=self.device)

    def get_pass(self, name: str, apply_denoise: bool | None = None
                 ) -> np.ndarray:
        """One pass as float32 [H*W*4] (RGBA per pixel) on the host."""
        pid = parse_pass(name)
        if pid == DENOISE or apply_denoise:
            raise NotImplementedError("the denoised pass is not ported yet")
        return (self.state["passes"][pid].detach().to("cpu")
                .numpy().astype(np.float32).reshape(-1))

    def get_render_info(self) -> dict:
        """Progress as the first pixel's sample count."""
        samples = int(self.state["samples"][0])
        if self.config.compat:
            samples -= 1  # compat counts start at 1
        return {"samples": samples}
