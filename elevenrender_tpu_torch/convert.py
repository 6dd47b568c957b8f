"""Carry a scene across from the JAX package to the port.

``ir_from_numpy(config_fields, ir_np, device)`` takes the JAX package's
``(config, ir)`` as plain data, ``dataclasses.asdict(config)`` and
``jax.tree.map(np.asarray, ir)``, and returns the port's
``(RenderConfig, ir)``, with the CUDA traversal's tables built from
``ir["bvh"]`` and the leaf-ordered ``ir["tris"]["verts"]``; with
``wide=True`` also the 8-wide tables (``ir["wide"]``, built from the same
flat BVH by ``experiments/bvh_wide.pack_bvh_wide``: the JAX IR holds
none).  It is how the tests hand both packages the same scene.  ``ir_to`` moves an IR
between devices.  ``params_from_numpy`` and ``params_to_numpy`` carry a
tree of gradient parameters or gradients (the JAX package's
``jax.tree.map(np.asarray, params)``) to the port's dict of tensors and
back, under the same names, so the two compare leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .experiments.bvh_wide import pack_bvh_wide
from .ops.intersect import pack_tri_attributes
from .ops.traverse import pack_tables
from .scene.ir import RenderConfig, ir_to_torch

_TRI_KEYS = ("verts", "normals", "uvs", "tangents", "sign", "mat")
_BVH_KEYS = ("node_bmin", "node_bmax", "node_from", "node_to")
_ENV_KEYS = ("img", "cdf", "rsum", "alias_prob", "alias_idx")
_ATLAS_KEYS = ("data", "off", "w", "h", "ch", "filter")


def ir_from_numpy(config_fields: dict, ir_np: dict, device="cuda",
                  wide: bool = False):
    dev = resolve_device(device)
    config = RenderConfig(**config_fields)
    tris = {k: np.asarray(ir_np["tris"][k]) for k in _TRI_KEYS}
    tris["packed"] = (np.asarray(ir_np["tris"]["packed"])
                      if "packed" in ir_np["tris"]
                      else pack_tri_attributes(*(tris[k] for k in _TRI_KEYS)))
    bvh = {k: np.asarray(ir_np["bvh"][k]) for k in _BVH_KEYS}
    port = {
        "tris": tris,
        "bvh": bvh,
        "kernel": pack_tables(bvh["node_bmin"], bvh["node_bmax"],
                              bvh["node_from"], bvh["node_to"],
                              tris["verts"], config.bvh_depth),
        "materials": dict(ir_np["materials"]),
        "atlas": {k: np.asarray(ir_np["atlas"][k]) for k in _ATLAS_KEYS},
        "env": {k: ir_np["env"][k] for k in _ENV_KEYS if k in ir_np["env"]},
        "camera": dict(ir_np["camera"]),
        "lights": dict(ir_np["lights"]),
    }
    if wide:
        port["wide"] = pack_bvh_wide({**bvh, "depth": config.bvh_depth})
    return config, ir_to_torch(port, dev)


def ir_to(ir: dict, device) -> dict:
    """The same IR with every tensor on ``device``."""
    dev = resolve_device(device)
    return {grp: {k: v.to(dev) for k, v in leaves.items()}
            for grp, leaves in ir.items()}


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """A tree of numpy leaves (a ``params`` or ``grads`` tree of the JAX
    package, as numpy) as the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return {k: (params_from_numpy(v, dev) if isinstance(v, dict)
                else torch.tensor(np.asarray(v), device=dev))
            for k, v in tree.items()}


def params_to_numpy(tree: dict) -> dict:
    """The port's ``params`` or ``grads`` tree as numpy leaves."""
    return {k: (params_to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy())
            for k, v in tree.items()}
