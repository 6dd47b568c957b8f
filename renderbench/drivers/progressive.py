"""The progressive driver: an artist's render, one full-frame sample
after another.

Set-up makes the port's ``Renderer`` and runs ``warmup_samples`` of its
``step(1)`` (the eager warm-up sample and the capture of the sample's
CUDA graph, then replays), so that nothing compiles or captures inside
the window.  The window calls ``Renderer.step(1)`` back to back, with
at most ``in_flight`` samples queued on the card: before it queues one
more, the host waits for the event recorded after the sample that many
steps back.  Each sample's completion is a timing event recorded after
it; the window closes at the first completion seen after ``seconds``.

- ``spp_per_s``: samples completed in the window over the window's
  host-clock seconds, from the first sample's queueing to the last
  one's completion;
- ``sample_p95_ms``: the 95th percentile, over every sample of the
  window, of the device-clock time from the previous completion (the
  window's start for the first) to its own.

What is compared with the reference: every pass (beauty, albedo,
normal, tangent, bitangent) and the sample count of ``check_pixels``
pixels drawn from the seed, after all the samples the renderer ran.
"""

from __future__ import annotations

import time

import numpy as np

from .. import check
from ..clock import Mark, sync


def setup(run) -> dict:
    from elevenrender_tpu_torch.render.renderer import Renderer
    renderer = Renderer(run["config"], run["ir"], run["device"])
    for _ in range(run["mix"]["warmup_samples"]):
        renderer.step(1)
    sync(run["device"])
    return {"renderer": renderer, "samples": run["mix"]["warmup_samples"]}


def window(st, run, seconds: float) -> dict:
    renderer = st["renderer"]
    depth = run["mix"]["in_flight"]
    dev = run["device"]
    done = []
    sync(dev)
    t0 = time.perf_counter()
    start = Mark(dev).record()
    while True:
        if len(done) >= depth:
            done[-depth].synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        renderer.step(1)
        done.append(Mark(dev).record())
    sync(dev)
    elapsed = time.perf_counter() - t0
    st["samples"] += len(done)
    marks = [start] + done
    gaps = [a.elapsed_ms(b) for a, b in zip(marks, marks[1:])]
    return {"attempted": len(done), "failed": 0,
            "metrics": {"spp_per_s": len(done) / elapsed,
                        "sample_p95_ms": float(np.percentile(gaps, 95))},
            "notes": {"samples": len(done), "window_s": elapsed,
                      "sample_p50_ms": float(np.percentile(gaps, 50))}}


def outputs(st, run) -> dict:
    pix = check.pixels(run)
    state = st["renderer"].state
    idx = pix.to(state["passes"].device)
    return {"pix": pix, "n_samples": st["samples"],
            "passes": state["passes"][:, idx, :3].cpu(),
            "samples": state["samples"][idx].cpu()}


def unit(st, run):
    """One traced unit: one sample."""
    return (lambda: st["renderer"].step(1)), 1


def release(st) -> None:
    st.clear()


def judge(run, out) -> tuple:
    return check.progressive(run, out)
