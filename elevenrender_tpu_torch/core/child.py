"""Profiling sessions in a fresh child process.

``torch.profiler`` traces the card through CUPTI.  In a process that has
run the gradient path's CUDA graphs at full width, a later profiling
session that replays a render graph faulted inside CUPTI, at the graph
launch (ROADMAP.md, faults, and PERF.md).  So the port's tracing entry
points (``Renderer.profile``, ``profile_step.profile_forward`` and
``profile_step.profile_grad``) never open a session on a card in the
caller's process: ``call_in_child`` runs the traced function in a new
interpreter, which rebuilds the renderer, the IR and the state from
CPU copies of them, captures its own graphs and traces them, and sends
back what the function returns (and writes what it writes).  This is a
mitigation: the fault stopped reproducing before it went in, so no run
shows that it prevents it.  On the CPU there is no graph and no CUPTI,
and the session opens in the caller's process.

    python -m elevenrender_tpu_torch.core.child JOB OUT

is the child's side: JOB holds the pickled (function, arguments), OUT
receives (True, the result) or (False, the traceback).  Both files are
written and read by this module only.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import traceback

import torch

# The directory that holds the package, for the child's import path.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def traces_in_child(device) -> bool:
    """Whether a profiling session over work on ``device`` opens in a
    child process: on a card, always."""
    return torch.device(device).type == "cuda"


def to_cpu(tree):
    """A dict tree of tensors with every tensor copied to the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def call_in_child(fn, *args):
    """``fn(*args)`` in a new Python process (this interpreter, this
    package on its import path, the environment of this process, its
    standard output and error), waited for.  ``fn`` is a module-level
    function; the arguments and the result are pickled, tensors on the
    CPU.  Returns the result; raises ``RuntimeError`` with the child's
    traceback if ``fn`` raised, or with its exit code if it died."""
    with tempfile.TemporaryDirectory() as tmp:
        job, out = os.path.join(tmp, "job.pkl"), os.path.join(tmp, "out.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, args), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        sys.stdout.flush()
        sys.stderr.flush()
        proc = subprocess.run(
            [sys.executable, "-m", "elevenrender_tpu_torch.core.child", job,
             out], env=env)
        if not os.path.exists(out):
            raise RuntimeError(f"{fn.__qualname__} in a child process: it "
                               f"exited {proc.returncode} with no result")
        with open(out, "rb") as f:
            ok, value = pickle.load(f)
    if not ok:
        raise RuntimeError(f"{fn.__qualname__} in a child process "
                           f"raised:\n{value}")
    return value


def _main(job: str, out: str) -> int:
    with open(job, "rb") as f:
        fn, args = pickle.load(f)
    try:
        result = (True, fn(*args))
    except Exception:
        result = (False, traceback.format_exc())
    with open(out, "wb") as f:
        pickle.dump(result, f)
    return 0 if result[0] else 1


if __name__ == "__main__":
    sys.exit(_main(*sys.argv[1:3]))
