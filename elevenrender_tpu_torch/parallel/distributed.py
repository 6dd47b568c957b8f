"""Multi-process rendering glue over ``torch.distributed``.

Port of ``elevenrender_tpu/parallel/distributed.py``.  The JAX package
follows the multi-controller recipe (every host runs the same program,
``jax.distributed.initialize`` joins them).  Here every rank is one
process on one device, every rank runs the same program, and
``initialize`` joins them into one process group: NCCL for ranks on
CUDA cards, gloo for ranks on the CPU (or, asked for by name, for ranks
that share one card, which NCCL refuses).  The scene is built
identically on every rank; each rank holds only its slice of the image.

Usage on each rank (torchrun sets the environment ``initialize``
reads)::

    from elevenrender_tpu_torch.parallel import distributed, mesh as pm
    distributed.initialize()
    mesh = distributed.global_mesh()
    ir = pm.replicate_ir(ir, mesh)        # the scene built on every rank
    state = pm.shard_render_state(init_state(config, mesh.device), mesh)
    step = pm.sharded_render_step(config, mesh)
    state = step(ir, state)
    passes = distributed.gather_image(state["passes"])   # rank 0 only

``parallel/dryrun.py`` spawns such ranks on one machine.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..core.device import resolve_device
from .mesh import PixelMesh, _staged, make_mesh

# A collective that waits longer than this fails instead of hanging on a
# rank that is gone.
COLLECTIVE_TIMEOUT_S = 120


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None, device="cuda") -> None:
    """Join this process to the process group; a no-op if a group is up.

    Arguments left out are read from the environment as torchrun sets
    it (``MASTER_ADDR``/``MASTER_PORT`` give ``init_method="env://"``,
    ``WORLD_SIZE``, ``RANK``).  ``backend`` defaults by ``device``: NCCL
    for ``"cuda"`` (which raises without a card), gloo for ``"cpu"``.
    Nothing swaps one backend for the other when it fails."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            raise ValueError("initialize: no init_method and no MASTER_ADDR "
                             "in the environment")
        init_method = "env://"
    if world_size is None:
        world_size = _env_int("WORLD_SIZE")
    if rank is None:
        rank = _env_int("RANK")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))


def _env_int(name: str) -> int:
    if name not in os.environ:
        raise ValueError(f"initialize: {name} neither given nor in the "
                         f"environment")
    return int(os.environ[name])


def global_mesh(device="cuda") -> PixelMesh:
    """The pixel mesh over every rank of the process group."""
    return make_mesh(device=device)


def gather_image(passes: torch.Tensor, mesh: PixelMesh | None = None):
    """The whole pass stack [P, npix, 4] on rank 0, on ``passes``'s
    device, and ``None`` on every other rank: the forward path's only
    collective, once per readback.  On a mesh without a process group,
    ``passes`` as it is."""
    if mesh is None:
        mesh = make_mesh(device=passes.device)
    if mesh.group is None:
        return passes
    staged = _staged(passes, mesh)
    if mesh.rank != 0:
        dist.gather(staged, None, dst=0, group=mesh.group)
        return None
    parts = [torch.empty_like(staged) for _ in range(mesh.world)]
    dist.gather(staged, parts, dst=0, group=mesh.group)
    return torch.cat(parts, dim=1).to(passes.device)
