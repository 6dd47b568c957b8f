"""A bounce's hit data by two hand CUDA kernels (``csrc/hitdata.cu``).

The hit data of a bounce are the hit's triangle rows and attributes
(``ops/intersect.py`` ``gather_tri``, ``full_hit``) and its material
rows, texture taps, normal map and the ^2.2 of roughness and metallic
(``render/integrator.py`` ``_generate_hitdata``).  As PyTorch ops they
are several hundred kernels a bounce; here they are two launches:
``tri`` (the triangle rows at the clamped hit ids and the hit) and
``material`` (the material rows and the texture taps of every bound
slot, each texture by its own filter, the normal map and the ^2.2).
Each kernel does the PyTorch ops' float arithmetic op for op, each op
rounded on its own, so both paths give the same float32 bits on every
lane, dead lanes and NaNs included.

``serves`` is the rule that picks the kernels, from what the inputs
show: every input on a card, and none that can carry a gradient (grad
mode off or no input requiring grad, and no input a forward-mode dual
tensor).  The PyTorch ops run everywhere else: on the CPU, and wherever
autograd, reverse or forward, differentiates through the hit data.

Each launch counts one on a host counter of the span registry
(``core/spans.py``), ``LAUNCHES``: ``hitdata_tri_launches`` and
``hitdata_material_launches``, counted where the wrapper launches, so a
CUDA graph's replay adds what its capture counted, as the traversal's
``launches`` do.
"""

from __future__ import annotations

import ctypes

import torch
import torch.autograd.forward_ad as fwAD

from ..core import spans

# The material row's scalars, in the order of the packed material table
# that render/integrator.py builds (its _SCALAR_FIELDS); csrc/hitdata.cu
# kScalars.
SCALARS = ("roughness", "metallic", "opacity", "transmission", "clearcoat",
           "anisotropic", "eta", "specular", "subsurface", "sheen",
           "clearcoat_gloss", "specular_tint", "sheen_tint")
SLOTS = 7          # scene/material.py MAP_SLOTS; csrc/hitdata.cu kSlots
NORMAL_SLOT = 4
THREADS = 256      # a block of either kernel (hitdata_threads)
_ATLAS = ("off", "w", "h", "ch", "filter")
# Launches since the last reset, by kernel: host counters of the span
# registry.
LAUNCHES = {"tri": "hitdata_tri_launches",
            "material": "hitdata_material_launches"}


def inputs(ir: dict, ray_o, ray_d) -> list:
    """The float tensors a bounce's hit data reads: the rays, the packed
    triangle rows, the material columns and the texel rows."""
    mats = ir["materials"]
    return [ray_o, ray_d, ir["tris"]["packed"], mats["albedo"],
            mats["emission"], *(mats[s] for s in SCALARS),
            ir["atlas"]["data"]]


def on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def serves(tensors) -> bool:
    """Whether the kernels compute the hit data of these inputs: all on a
    card, and none able to carry a gradient, reverse or forward.  (The
    kernels take float32 alone; ``tri`` and ``material`` refuse any other
    dtype.)"""
    if not all(on_card(t.device) for t in tensors):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return all(fwAD.unpack_dual(t).tangent is None for t in tensors)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from .. import kernels
        lib = kernels.load("hitdata")
        p = ctypes.c_void_p
        i = ctypes.c_int
        ll = ctypes.c_longlong
        lib.hitdata_tri.argtypes = [p, ll, ll, p, p, p, i, p, p, p, p]
        lib.hitdata_tri.restype = i
        lib.hitdata_material.argtypes = ([p] * 6 + [i] + [p] * 4
                                         + [ll, p, ll] + [p] * 5 + [i] * 3
                                         + [p] * 3)
        lib.hitdata_material.restype = i
        lib.hitdata_error_string.argtypes = [i]
        lib.hitdata_error_string.restype = ctypes.c_char_p
        for fn, want in ((lib.hitdata_threads, THREADS),
                         (lib.hitdata_scalars, len(SCALARS)),
                         (lib.hitdata_slots, SLOTS)):
            fn.argtypes = []
            fn.restype = i
            if fn() != want:
                raise RuntimeError(f"csrc/hitdata.cu {fn.__name__} is "
                                   f"{fn()}, ops/hitdata.py expects {want}")
        _lib = lib
    return _lib


def _check(name, x, dtype, shape, device, aligned=False):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def _run(fn, dev, *args):
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: "
                           + _library().hitdata_error_string(rc).decode())


def tri(tris: dict, hit_idx, ray_o, ray_d) -> dict:
    """``full_hit(ray_o, ray_d, gather_tri(tris, clamp(hit_idx, min=0)))``
    in one launch, without its ``valid`` and ``t``: position, normal,
    gnormal, tangent, bitangent [N, 3], tu, tv [N] float32 and mat [N]
    int64, views of three fresh buffers."""
    dev = hit_idx.device
    n = hit_idx.shape[0]
    packed = tris["packed"].contiguous()
    hit_idx, ray_o, ray_d = (x.contiguous() for x in (hit_idx, ray_o, ray_d))
    _check("hit_idx", hit_idx, torch.int64, (n,), dev)
    _check("ray_o", ray_o, torch.float32, (n, 3), dev)
    _check("ray_d", ray_d, torch.float32, (n, 3), dev)
    _check("packed", packed, torch.float32, (packed.shape[0], 40), dev,
           aligned=True)
    vec = torch.empty((5, n, 3), dtype=torch.float32, device=dev)
    uv = torch.empty((2, n), dtype=torch.float32, device=dev)
    mat = torch.empty((n,), dtype=torch.int64, device=dev)
    if n:
        _run(_library().hitdata_tri, dev, packed.data_ptr(),
             tris["verts"].shape[0], packed.shape[0], hit_idx.data_ptr(),
             ray_o.data_ptr(), ray_d.data_ptr(), n, vec.data_ptr(),
             uv.data_ptr(), mat.data_ptr())
        spans.count(LAUNCHES["tri"])
    return {"position": vec[0], "normal": vec[1], "gnormal": vec[2],
            "tangent": vec[3], "bitangent": vec[4], "tu": uv[0],
            "tv": uv[1], "mat": mat}


def material(mats: dict, atlas: dict, hit: dict, used: tuple,
             uniform_filter: int) -> dict:
    """The material row at ``hit["mat"]`` with the texture taps of every
    slot that ``used`` (``RenderConfig.tex_slots_used``) marks in place of
    the constants they bind, the normal map and the ^2.2, in one launch:
    albedo, emission [N, 3], the 13 ``SCALARS`` [N], and with a normal
    map the mapped normal [N, 3] ("normal"; else absent), views of two
    fresh buffers.  ``uniform_filter`` is ``tex_uniform_filter``: the one
    filter every texture shares, or -1 for a mixed atlas."""
    hit = {k: hit[k].contiguous() for k in ("mat", "tu", "tv", "normal",
                                            "tangent", "bitangent")}
    mats = {k: mats[k].contiguous() for k in ("albedo", "emission", "tex",
                                              *SCALARS)}
    atlas = {k: atlas[k].contiguous() for k in ("data", *_ATLAS)}
    m = hit["mat"]
    dev = m.device
    n = m.shape[0]
    rows = mats["albedo"].shape[0]
    _check("mat", m, torch.int64, (n,), dev)
    for k in ("tu", "tv"):
        _check(k, hit[k], torch.float32, (n,), dev)
    frame = [hit[k] for k in ("normal", "tangent", "bitangent")]
    for k, x in zip(("normal", "tangent", "bitangent"), frame):
        _check(k, x, torch.float32, (n, 3), dev)
    _check("albedo", mats["albedo"], torch.float32, (rows, 3), dev)
    _check("emission", mats["emission"], torch.float32, (rows, 3), dev)
    for s in SCALARS:
        _check(s, mats[s], torch.float32, (rows,), dev)
    _check("tex", mats["tex"], torch.int32, (rows, SLOTS), dev)
    data = atlas["data"]
    count = atlas["off"].shape[0]
    _check("atlas data", data, torch.float32, (data.shape[0], 4), dev,
           aligned=True)
    for k in _ATLAS:
        _check(f"atlas {k}", atlas[k], torch.int32, (count,), dev)
    used_bits = sum(1 << s for s, u in enumerate(used) if u)
    mapped = bool(used[NORMAL_SLOT])
    vec = torch.empty((3 if mapped else 2, n, 3), dtype=torch.float32,
                      device=dev)
    out = torch.empty((len(SCALARS), n), dtype=torch.float32, device=dev)
    if n:
        scalars = (ctypes.c_void_p * len(SCALARS))(
            *(mats[s].data_ptr() for s in SCALARS))
        _run(_library().hitdata_material, dev, m.data_ptr(),
             hit["tu"].data_ptr(), hit["tv"].data_ptr(),
             *(x.data_ptr() for x in frame), n, mats["albedo"].data_ptr(),
             mats["emission"].data_ptr(), ctypes.addressof(scalars),
             mats["tex"].data_ptr(),
             rows, data.data_ptr(), data.shape[0],
             *(atlas[k].data_ptr() for k in _ATLAS), count, used_bits,
             uniform_filter, vec.data_ptr(), out.data_ptr())
        spans.count(LAUNCHES["material"])
    hd = {"albedo": vec[0], "emission": vec[1]}
    hd.update(zip(SCALARS, out))
    if mapped:
        hd["normal"] = vec[2]
    return hd
