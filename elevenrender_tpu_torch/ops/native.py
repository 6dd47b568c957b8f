"""ctypes binding to the port's host runtime (``csrc/elevenrt.cpp``).

The port's copy of the JAX package's ``ops/native.py``, with the same
signatures and outputs: the C++ SAH build (``build_bvh_native``, bit for
bit the numpy build of ``ops/bvh.py``) and the C++ two-pass OBJ
tokenizer (``parse_obj_native``).  The library is host code, built by
``kernels.py`` with the host compiler into ``build/kernels/`` at first
use.

Unlike the JAX package's binding, ``load_library`` raises where the
library cannot be built or loaded: it never returns ``None`` for numpy
or the Python tokenizer to take over unseen.  ``build_bvh(...,
use_native=False)`` or ``ELEVENRT_NATIVE=0`` asks for the numpy build
openly.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import kernels

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
# Capacity of each NUL-separated name pool (material and shape names).
NAME_POOL_BYTES = 1 << 16


class ObjCounts(ctypes.Structure):
    _fields_ = [("n_pos", ctypes.c_int64), ("n_nrm", ctypes.c_int64),
                ("n_uv", ctypes.c_int64), ("n_tri", ctypes.c_int64),
                ("n_shape", ctypes.c_int64)]


def load_library() -> ctypes.CDLL:
    """The host runtime, built first if needed, with its C signatures
    declared.  Raises (with the compiler's output) if it cannot be
    built."""
    lib = kernels.load("elevenrt")
    lib.er_build_bvh.restype = ctypes.c_int
    lib.er_build_bvh.argtypes = [_F32P, ctypes.c_int, ctypes.c_int,
                                 _F32P, _F32P, _I32P, _I32P, _I32P]
    lib.er_obj_count.restype = ctypes.c_int
    lib.er_obj_count.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                 ctypes.POINTER(ObjCounts)]
    lib.er_obj_fill.restype = ctypes.c_int
    lib.er_obj_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                _F32P, _F32P, _F32P, _I32P, _I32P,
                                ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_char_p, ctypes.c_int64]
    return lib


def build_bvh_native(tri_verts: np.ndarray, depth: int) -> dict:
    """The C++ SAH build: the outputs of ``ops.bvh.build_bvh``."""
    verts = np.ascontiguousarray(tri_verts, np.float32)
    T = verts.shape[0]
    if verts.size != 9 * T or not 0 <= depth <= 30:
        raise ValueError(f"tri_verts {verts.shape} is not [T, 3, 3], or "
                         f"depth {depth} is outside [0, 30]")
    lib = load_library()
    NN = (1 << (depth + 1)) - 1
    node_bmin = np.zeros((NN, 3), np.float32)
    node_bmax = np.zeros((NN, 3), np.float32)
    node_from = np.zeros(NN, np.int32)
    node_to = np.zeros(NN, np.int32)
    perm = np.zeros(max(T, 1), np.int32)
    max_leaf = lib.er_build_bvh(
        verts.ctypes.data_as(_F32P), T, depth,
        node_bmin.ctypes.data_as(_F32P), node_bmax.ctypes.data_as(_F32P),
        node_from.ctypes.data_as(_I32P), node_to.ctypes.data_as(_I32P),
        perm.ctypes.data_as(_I32P))
    return dict(node_bmin=node_bmin, node_bmax=node_bmax,
                node_from=node_from, node_to=node_to,
                perm=perm[:T], depth=depth, max_leaf=max(int(max_leaf), 1))


def parse_obj_native(text: str | bytes):
    """The C++ two-pass OBJ tokenizer (``er_obj_count``, ``er_obj_fill``).

    Returns (tri_pos [T,3,3], tri_nrm [T,3,3] (NaN rows where the face
    had no normal index), tri_uv [T,3,2], tri_shape [T] i32, tri_mat [T]
    i32 (-1 before any ``usemtl``), mat_names list[str], shape_names
    list[str]).

    Unlike the Python tokenizer, shapes are keyed by NAME: two ``o``
    blocks with the same name are one shape.
    """
    lib = load_library()
    raw = text.encode("utf-8", "replace") if isinstance(text, str) else text
    counts = ObjCounts()
    lib.er_obj_count(raw, len(raw), ctypes.byref(counts))
    T = int(counts.n_tri)
    tri_pos = np.zeros((max(T, 1), 9), np.float32)
    tri_nrm = np.zeros((max(T, 1), 9), np.float32)
    tri_uv = np.zeros((max(T, 1), 6), np.float32)
    tri_shape = np.zeros(max(T, 1), np.int32)
    tri_mat = np.zeros(max(T, 1), np.int32)
    mat_pool = ctypes.create_string_buffer(NAME_POOL_BYTES)
    shape_pool = ctypes.create_string_buffer(NAME_POOL_BYTES)
    T = int(lib.er_obj_fill(raw, len(raw),
                            tri_pos.ctypes.data_as(_F32P),
                            tri_nrm.ctypes.data_as(_F32P),
                            tri_uv.ctypes.data_as(_F32P),
                            tri_shape.ctypes.data_as(_I32P),
                            tri_mat.ctypes.data_as(_I32P),
                            mat_pool, len(mat_pool),
                            shape_pool, len(shape_pool)))

    def pool_names(buf, n_names):
        # Entries are NUL-separated in order; empty names are valid (the
        # default shape), so take exactly n_names split pieces.
        pieces = buf.raw.split(b"\x00")
        return [p.decode("utf-8", "replace") for p in pieces[:n_names]]

    n_mats = int(tri_mat[:T].max()) + 1 if T and tri_mat[:T].max() >= 0 else 0
    n_shapes = int(tri_shape[:T].max()) + 1 if T else 0
    return (tri_pos[:T].reshape(T, 3, 3), tri_nrm[:T].reshape(T, 3, 3),
            tri_uv[:T].reshape(T, 3, 2), tri_shape[:T], tri_mat[:T],
            pool_names(mat_pool, n_mats), pool_names(shape_pool, n_shapes))
