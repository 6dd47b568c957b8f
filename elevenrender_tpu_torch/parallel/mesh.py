"""Multi-device rendering: the pixel axis split over processes.

Port of ``elevenrender_tpu/parallel/mesh.py``.  The JAX package lays a
1-D device mesh over the pixel axis: the scene IR replicated on every
device, the per-pixel accumulator state sharded.  In PyTorch's idiom
that is one process per device under ``torch.distributed``: rank r of
``world`` renders the contiguous pixels ``[r * local, (r + 1) * local)``,
``local = npix / world``, with their global indices (``render_sample``'s
``pixel_offset``), so each pixel gets its camera ray and its RNG stream
exactly as in one process.

The forward render needs no collective: no op of a sample sums across
rays.  The image is gathered once per readback
(``distributed.gather_image``).  Gradients of a pixel loss with respect
to the replicated scene tables are all-reduced (``sharded_loss_and_grad``),
the ``psum`` that GSPMD inserts for the JAX package.

A ``PixelMesh`` is one rank's view: its rank, the world, its device and
the process group.  Without an initialized process group it is the
one-process mesh (rank 0 of 1, no group), on which every function here
is the unsharded one and runs no collective.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..convert import ir_to
from ..core.device import resolve_device
from ..render import grad as grad_mod
from ..render.integrator import init_state, render_sample

# The mesh's one axis, as the JAX package names it.
PIXEL_AXIS = "pixels"


@dataclasses.dataclass(frozen=True)
class PixelMesh:
    rank: int
    world: int
    device: torch.device
    group: object = None  # the process group; None for one process

    def local_pixels(self, npix: int) -> int:
        if npix % self.world != 0:
            raise ValueError(f"{npix} pixels not divisible by {self.world} "
                             f"devices")
        return npix // self.world

    def pixel_offset(self, npix: int) -> int:
        """The global index of this rank's first pixel."""
        return self.rank * self.local_pixels(npix)


def make_mesh(n_devices: int | None = None, device="cuda") -> PixelMesh:
    """This process's view of the pixel mesh: the process group's rank
    and world (rank 0 of 1 without one).  ``device="cuda"`` takes
    ``cuda:{local rank % cards}`` (``LOCAL_RANK`` as torchrun sets it,
    else the rank) and raises without a card.  ``n_devices``, if given,
    must be the world's size: a rank renders on one device."""
    if dist.is_available() and dist.is_initialized():
        rank, world, group = dist.get_rank(), dist.get_world_size(), \
            dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices asked for in a "
                         f"world of {world} processes")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return PixelMesh(rank, world, dev, group)


def replicate_ir(ir: dict, mesh: PixelMesh) -> dict:
    """The scene tables on this rank's device.  Every rank builds the
    scene itself, from the same inputs, so every replica is the same."""
    return ir_to(ir, mesh.device)


def shard_render_state(state: dict, mesh: PixelMesh) -> dict:
    """This rank's slice of a whole image's state, on its device: passes
    [P, local, 4], samples and rng [local].  ``ray_count`` stays with
    rank 0 (the others start at 0), so the ranks' counts sum to the
    whole image's: ``all_reduce_sum(state["ray_count"], mesh)``."""
    npix = state["samples"].shape[0]
    lo = mesh.pixel_offset(npix)
    hi = lo + mesh.local_pixels(npix)
    out = {"passes": state["passes"][:, lo:hi].to(mesh.device, copy=True)
           .contiguous(),
           "samples": state["samples"][lo:hi].to(mesh.device, copy=True),
           "rng": state["rng"][lo:hi].to(mesh.device, copy=True)}
    if "ray_count" in state:
        count = state["ray_count"].to(mesh.device, copy=True)
        out["ray_count"] = count if mesh.rank == 0 else torch.zeros_like(
            count)
    return out


def _staged(t: torch.Tensor, mesh: PixelMesh) -> torch.Tensor:
    """A copy of ``t`` that the group's backend takes: gloo's collectives
    are run on host copies of CUDA tensors (two ranks that share one card
    cannot use NCCL, and gloo's CUDA support is partial)."""
    if t.is_cuda and dist.get_backend(mesh.group) == "gloo":
        return t.detach().to("cpu", copy=True)
    return t.detach().clone().contiguous()


def all_reduce_sum(t: torch.Tensor, mesh: PixelMesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on ``t``'s device (``t`` itself
    on a mesh without a process group)."""
    if mesh.group is None:
        return t
    staged = _staged(t, mesh)
    dist.all_reduce(staged, op=dist.ReduceOp.SUM, group=mesh.group)
    return staged.to(t.device)


def sharded_render_step(config, mesh: PixelMesh):
    """A one-sample step for this rank's slice of the image:
    ``step(ir, state) -> state``, ``render_sample`` at the slice's
    global pixel offset.  Raises ``ValueError`` if the image's pixels do
    not split evenly over the ranks."""
    npix = config.x_res * config.y_res
    offset = mesh.pixel_offset(npix)

    def step(ir, state):
        return render_sample(config, ir, state, pixel_offset=offset,
                             device=mesh.device)

    return step


def shard_map_render_step(config, mesh: PixelMesh):
    """The same step as ``sharded_render_step``.  The JAX package needs
    two step builders: GSPMD partitions the jnp program over the mesh but
    cannot partition a Pallas kernel, so the TPU traversal runs inside
    ``shard_map``, one explicit step per device.  With one process per
    device there is only that explicit per-rank step, which launches the
    CUDA traversal kernel on its own card; the name is kept so both
    packages offer the same calls."""
    return sharded_render_step(config, mesh)


def sharded_loss_and_grad(config, ir, params, target_local, n_samples: int,
                          mesh: PixelMesh):
    """(loss, gradients as a tree like ``params``) of the whole image's
    MSE, from this rank's slice: the slice's squared error over 3 x the
    whole image's pixels, differentiated by autograd straight through the
    n samples, then the loss and every gradient leaf summed over the
    ranks.  ``target_local`` is the slice of the target [local, 3].
    Every rank returns the same numbers."""
    npix = config.x_res * config.y_res
    state = shard_render_state(init_state(config, mesh.device), mesh)
    tree, flat = grad_mod._as_parameters(params)
    with torch.enable_grad():
        loss = grad_mod.loss_fn(config, ir, tree, target_local, n_samples,
                                mesh.device, state, mesh.pixel_offset(npix),
                                npix)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [all_reduce_sum(torch.zeros_like(p) if g is None else g, mesh)
             for p, g in zip(flat, grads)]
    return (all_reduce_sum(loss.detach(), mesh),
            grad_mod._rebuild(params, iter(grads)))
