"""The process mesh (port of dmvsnet_tpu.parallel.mesh).

The JAX package expresses distribution as shardings over a logical device
mesh and lets XLA insert the collectives.  Here every rank is one process
with one device, and the collectives are explicit, over one process group
per mesh axis:

* ``dp``, data parallel: each rank holds its share of the global batch.
  Train-mode batch-norm statistics (models/blocks.py) and the loss's
  masked means (losses/) are reductions over the dp group, so they are
  those of the global batch, as under jit over a dp-sharded batch; the
  gradients are averaged over all ranks by DDP (engine/train.py).
* ``vp``, view parallel: each rank correlates the reference view with its
  share of the source views and one all_reduce over the vp group sums the
  cost volume (ops/warp_correlate.aggregate_cost_volume_view_sharded).
* ``sp``, spatial parallel: not ported yet.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo offers no
more on CUDA tensors, and gloo is what ranks sharing one card use.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

AXIS_DATA = "dp"
AXIS_VIEW = "vp"
AXIS_SPATIAL = "sp"


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a process group.

    Raises RuntimeError when the environment says WORLD_SIZE > 1 and no
    process group exists (``parallel.init_multihost`` was not called): the
    port never carries on as a single process then."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE") or os.environ.get("NUM_PROCESSES") or 1)
    if world > 1:
        raise RuntimeError(f"WORLD_SIZE={world} but no process group exists: call "
                           "dmvsnet_tpu_torch.parallel.init_multihost() first")
    return 0, 1


class _PSum(torch.autograd.Function):
    """Sum over a process group whose backward is the same sum of the
    cotangents, as psum's transpose is in JAX.  With it, DDP's mean over the
    ranks gives every parameter its gradient: vp identical copies downstream
    of the sum are averaged, and the vp-fold cotangent upstream of it is
    divided back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, cot):
        cot = cot.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(cot, group=ctx.group)
        return cot, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (``x`` itself
    for None)."""
    return x if group is None else _PSum.apply(x, group)


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (dp, vp, sp) grid of ranks.

    ``shape`` and ``coords`` map each axis to its size and to this rank's
    index along it; ``groups`` maps each axis of size > 1 to the process
    group of the ranks that differ from this one along that axis alone;
    ``device`` is the device this rank computes on."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, Any]
    device: torch.device

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def group(self, axis: str):
        """The process group of ``axis``; None where the axis has size 1."""
        return self.groups.get(axis)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Differentiable sum of ``x`` over ``axis`` (``x`` itself where the
        axis has size 1)."""
        return psum(x, self.group(axis))

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over ``axis``, without a gradient (a new tensor)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        group = self.group(axis)
        if group is not None:
            dist.all_reduce(out, group=group)
        return out

    def mean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Mean of ``x`` over ``axis``, without a gradient."""
        return self.all_reduce(x, axis) / self.size(axis)


def make_mesh(n_data: int | None = None, n_spatial: int = 1, n_view: int = 1,
              device: str | torch.device = "cpu") -> Mesh:
    """The (dp, vp, sp) mesh over every rank of the process group (one rank,
    without one).

    Args:
      n_data: size of the data axis; defaults to the ranks left over by the
        other two axes.
      n_spatial: size of the spatial axis; only 1 is ported.
      n_view: size of the source-view axis (the cost volume's sum over the
        V-1 source views is sharded over it).
      device: the device this rank computes on.

    Ranks are laid out as the JAX package lays out devices: rank =
    (d * n_view + v) * n_spatial + s.  Every rank must hold one place:
    raises ValueError unless n_data * n_view * n_spatial is the world size.
    """
    if n_spatial > 1:
        raise NotImplementedError(
            f"n_spatial={n_spatial}: the spatial mesh axis is not ported yet "
            "(ROADMAP.md, open items §1: sp, the spatial axis)")
    rank, world = rank_and_world()
    if n_data is None:
        n_data = world // (n_spatial * n_view)
    shape = {AXIS_DATA: n_data, AXIS_VIEW: n_view, AXIS_SPATIAL: n_spatial}
    if n_data < 1 or n_data * n_view * n_spatial != world:
        raise ValueError(f"mesh {n_data}x{n_view}x{n_spatial} (dp x vp x sp) must hold "
                         f"each of the {world} ranks once")
    coords = {AXIS_DATA: rank // (n_view * n_spatial),
              AXIS_VIEW: rank // n_spatial % n_view, AXIS_SPATIAL: rank % n_spatial}
    groups = {}
    for axis, other in ((AXIS_DATA, n_view), (AXIS_VIEW, n_data)):
        if shape[axis] == 1:
            continue
        if other == 1:
            groups[axis] = dist.group.WORLD
            continue
        # new_group is collective: every rank creates every group, in order
        for j in range(other):
            ranks = ([d * n_view + j for d in range(n_data)] if axis == AXIS_DATA
                     else [j * n_view + v for v in range(n_view)])
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(shape, coords, groups, torch.device(device))


def shard_batch(tree, mesh: Mesh):
    """A host-local batch (nested dicts of numpy arrays) as tensors on this
    rank's device.  The loader already yields this rank's share of the
    global batch (``data/loader.py``: ``num_hosts`` / ``host_id``)."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    return torch.from_numpy(tree).to(mesh.device)


@torch.no_grad()
def replicate_tree(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place; a
    no-op without a process group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
