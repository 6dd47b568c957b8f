"""Build and load the port's CUDA kernels and its host library.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface and loaded
with ``ctypes``.  The host runtime (``csrc/elevenrt.cpp``: the SAH build
and the OBJ tokenizer) is built the same way by the host compiler
(``c++``); it is kept in a table of its own, ``HOST_LIBRARIES``, since
it has no kernel and no ptxas report.  The stamp kernels of the span
registry (``csrc/spans.cu``, ``core/spans.py``) are an instrument, not a
render kernel: they are in ``INSTRUMENT_LIBRARIES``, built by ``nvcc``
like the rest, and only when tracing is turned on.  Nothing is built at
import time: a library is built at its first use (or by ``build_all``,
which starts one compiler per library at once) into ``build/kernels/``
beside the package, keyed by a hash of its sources, the headers they
share and its flags, so a changed source or header rebuilds and an
unchanged one loads at once.  A failed build raises with the compiler's
output.  Building is the span ``kernels.build`` and counts one
``kernel_build`` a library compiled; loading a library is the span
``kernels.load``.  A library's build log (for a CUDA library, ptxas's
resource report) is kept beside it, so a library found built reports the
same ``build_info``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from .core import spans

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# name -> (sources, extra nvcc flags, headers).  The sources go to nvcc;
# the headers they include do not, but are hashed with them, so an edited
# header rebuilds every library that shares it.  --fmad=false keeps every
# float op of the traversals and of the hit data separately rounded, as
# their PyTorch versions are.
_TRAVERSAL = (("--fmad=false",), ("bvh_common.cuh",))
LIBRARIES = {
    "bvh_traverse": (("bvh_traverse.cu",), *_TRAVERSAL),
    "bvh_traverse_v1": (("bvh_traverse_v1.cu",), *_TRAVERSAL),
    "bvh_frontier": (("bvh_frontier.cu",), *_TRAVERSAL),
    "bvh_wide": (("bvh_wide.cu",), *_TRAVERSAL),
    "hitdata": (("hitdata.cu",), ("--fmad=false",), ()),
}
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# Host C++ libraries, name -> (sources, extra flags, headers), built by
# the host compiler with HOST_FLAGS.  -ffp-contract=off: GCC fuses a*b+c
# into one FMA by default wherever the target has FMA units, and that
# would round the SAH cost (elevenrt.cpp bounds_area) otherwise than the
# numpy build does and split a near tie the other way; every op is
# rounded on its own instead.  No -march=native: the library must build
# the same tree on whichever host runs it, and the card's host is another
# CPU than the one the tests run on.
HOST_LIBRARIES = {
    "elevenrt": (("elevenrt.cpp",), (), ()),
}
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
# CUDA libraries of instruments, built with BASE_FLAGS: the span stamps.
INSTRUMENT_LIBRARIES = {
    "spans": (("spans.cu",), (), ()),
}

_loaded: dict[Path, ctypes.CDLL] = {}
# name -> {"seconds": build time or 0.0 when cached, "log": compiler output}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build CUDA kernels")


def _cxx() -> str:
    for name in ("c++", "g++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (c++ or g++ on PATH): cannot "
                       "build the host runtime")


def _target(name: str) -> tuple[Path, list[str]]:
    """(the library's path, its compiler's arguments without ``-o``)."""
    host = name in HOST_LIBRARIES
    sources, flags, headers = (HOST_LIBRARIES if host else
                               INSTRUMENT_LIBRARIES
                               if name in INSTRUMENT_LIBRARIES
                               else LIBRARIES)[name]
    base = HOST_FLAGS if host else BASE_FLAGS
    paths = [CSRC / s for s in sources]
    h = hashlib.sha256()
    for p in paths + [CSRC / s for s in headers]:
        h.update(p.read_bytes())
    h.update(" ".join(base + flags).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    cmd = [*base, *flags, *map(str, paths)]
    return out, cmd


def build_all(names=None) -> None:
    """Build every library of ``names`` (default: every CUDA library) that
    is not built yet, one compiler process per library, all started
    together."""
    with spans.span("kernels.build"):
        _build(list(LIBRARIES) if names is None else list(names))


def _build(names: list) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out, cmd = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            build_info.setdefault(name, {
                "seconds": 0.0,
                "log": log.read_text() if log.exists() else "cached"})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        compiler = _cxx() if name in HOST_LIBRARIES else _nvcc()
        procs[name] = (subprocess.Popen(
            [compiler, *cmd, "-o", str(tmp)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out, time.time())
        spans.count("kernel_build")
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.time() - t0, "log": log}
        if proc.returncode != 0:
            errors.append(f"{Path(proc.args[0]).name} failed for {name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)  # read again when cached
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` as its sources stand now, built first
    if needed."""
    out, _ = _target(name)
    lib = _loaded.get(out)
    if lib is None:
        if not out.exists():
            build_all([name])
        with spans.span("kernels.load"):
            lib = ctypes.CDLL(str(out))
        _loaded[out] = lib
    return lib
