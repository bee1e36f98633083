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
* ``sp``, spatial parallel: every rank of an sp group computes each cost
  volume on the whole image, then regularises its own band of rows; the
  cost U-Nets exchange one halo row with their neighbours at every 3x3
  convolution and take their train-mode batch-norm statistics over the
  ``("dp", "sp")`` group, and the heads' outputs are gathered back to the
  whole image (parallel/spatial.py, models/mvsnet.py).

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo offers no
more on CUDA tensors, and gloo is what ranks sharing one card use.  Every
all_reduce of the port is issued here and counted by label
(``all_reduces``); DDP's gradient all_reduce runs in its C++ reducer and is
not among them.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from dmvsnet_tpu_torch.utils.trace import span

AXIS_DATA = "dp"
AXIS_VIEW = "vp"
AXIS_SPATIAL = "sp"
# the ranks that share a vp coordinate: the banded cost U-Nets' batch norm
AXIS_DATA_SPATIAL = (AXIS_DATA, AXIS_SPATIAL)

# all_reduce calls and bytes issued by this module since the last
# reset_all_reduces, by label: the ``psum`` labels ("halo", "gather",
# "batch_norm", "view_sum"), forward and backward, and "other" for
# ``Mesh.all_reduce`` (the loss's and the metrics' sums)
ALL_REDUCES: dict[str, dict[str, int]] = {}


def all_reduces() -> dict[str, dict[str, int]]:
    """{label: {"calls", "bytes"}} of every all_reduce counted so far."""
    return {k: dict(v) for k, v in ALL_REDUCES.items()}


def reset_all_reduces() -> None:
    """Forgets every count, to count a run."""
    ALL_REDUCES.clear()


def _all_reduce(x: torch.Tensor, group, label: str | None) -> None:
    """Sums ``x`` over ``group`` in place, counted under ``label``."""
    counts = ALL_REDUCES.setdefault(label or "other", {"calls": 0, "bytes": 0})
    counts["calls"] += 1
    counts["bytes"] += x.numel() * x.element_size()
    dist.all_reduce(x, group=group)


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
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        out = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(out, group, label)
        return out

    @staticmethod
    def backward(ctx, cot):
        cot = cot.clone(memory_format=torch.contiguous_format)
        _all_reduce(cot, ctx.group, ctx.label)
        return cot, None, None


def psum(x: torch.Tensor, group, label: str | None = None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group`` (``x`` itself
    for None).  ``label`` names what the sum is for ("halo", "gather",
    "batch_norm", "view_sum"); it changes nothing but the key under which
    ``all_reduces`` counts the sum's forward and backward all_reduce."""
    return x if group is None else _PSum.apply(x, group, label)


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (dp, vp, sp) grid of ranks.

    ``shape`` and ``coords`` map each axis to its size and to this rank's
    index along it; ``groups`` maps each axis of size > 1 to the process
    group of the ranks that differ from this one along that axis alone;
    ``device`` is the device this rank computes on."""

    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[Any, Any]
    device: torch.device

    def size(self, axis) -> int:
        """The size of ``axis``, or the product of the sizes of a tuple of
        axes (``AXIS_DATA_SPATIAL``)."""
        return math.prod(self.shape[a] for a in axis) if isinstance(axis, tuple) \
            else self.shape[axis]

    def group(self, axis):
        """The process group of ``axis`` (or of a tuple of axes); None where
        it holds one rank."""
        return self.groups.get(axis)

    def psum(self, x: torch.Tensor, axis, label: str | None = None) -> torch.Tensor:
        """Differentiable sum of ``x`` over ``axis`` (``x`` itself where the
        axis has size 1); ``label`` as in ``psum``."""
        return psum(x, self.group(axis), label)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``x`` over ``axis``, without a gradient (a new tensor)."""
        out = x.detach().clone(memory_format=torch.contiguous_format)
        group = self.group(axis)
        if group is not None:
            _all_reduce(out, group, None)
        return out

    def mean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Mean of ``x`` over ``axis``, without a gradient."""
        return self.all_reduce(x, axis) / self.size(axis)


def mesh_layout(world: int, n_data: int, n_view: int, n_spatial: int) -> dict:
    """Where each rank sits on a (dp, vp, sp) grid, as the JAX package lays
    out devices: ``np.arange(world).reshape(n_data, n_view, n_spatial)``,
    so rank = (d * n_view + v) * n_spatial + s.

    Returns {"coords": [{"dp", "vp", "sp"} of each rank], "groups": {axis:
    [rank lists]}}: for each of dp, vp and sp the ranks that differ along
    that axis alone, and for ``AXIS_DATA_SPATIAL`` the ranks that share a
    vp coordinate.  Raises ValueError unless the grid holds each rank once.
    """
    if min(n_data, n_view, n_spatial) < 1 or n_data * n_view * n_spatial != world:
        raise ValueError(f"mesh {n_data}x{n_view}x{n_spatial} (dp x vp x sp) must hold "
                         f"each of the {world} ranks once")
    grid = np.arange(world).reshape(n_data, n_view, n_spatial)
    coords = [dict(zip((AXIS_DATA, AXIS_VIEW, AXIS_SPATIAL), map(int, np.argwhere(grid == r)[0])))
              for r in range(world)]
    lists = {AXIS_DATA: grid.transpose(1, 2, 0).reshape(-1, n_data),
             AXIS_VIEW: grid.transpose(0, 2, 1).reshape(-1, n_view),
             AXIS_SPATIAL: grid.reshape(-1, n_spatial),
             AXIS_DATA_SPATIAL: grid.transpose(1, 0, 2).reshape(n_view, -1)}
    return {"coords": coords,
            "groups": {axis: [[int(r) for r in row] for row in rows]
                       for axis, rows in lists.items()}}


def make_mesh(n_data: int | None = None, n_spatial: int = 1, n_view: int = 1,
              device: str | torch.device = "cpu") -> Mesh:
    """The (dp, vp, sp) mesh over every rank of the process group (one rank,
    without one).

    Args:
      n_data: size of the data axis; defaults to the ranks left over by the
        other two axes.
      n_spatial: size of the spatial axis (the rows of each cost U-Net are
        split over it).
      n_view: size of the source-view axis (the cost volume's sum over the
        V-1 source views is sharded over it).
      device: the device this rank computes on.

    Ranks are laid out as ``mesh_layout`` says.  Every rank must hold one
    place: raises ValueError unless n_data * n_view * n_spatial is the
    world size.  Each axis of more than one rank gets a process group, and
    so does ``AXIS_DATA_SPATIAL``; axes with the same ranks share one.
    """
    rank, world = rank_and_world()
    if n_data is None:
        n_data = world // (n_spatial * n_view)
    layout = mesh_layout(world, n_data, n_view, n_spatial)
    shape = {AXIS_DATA: n_data, AXIS_VIEW: n_view, AXIS_SPATIAL: n_spatial}
    groups, made = {}, {}
    for axis, rank_lists in layout["groups"].items():
        for ranks in rank_lists:
            if len(ranks) == 1:
                continue
            if tuple(ranks) not in made:
                # new_group is collective: every rank creates every group, in order
                made[tuple(ranks)] = (dist.group.WORLD if len(ranks) == world
                                      else dist.new_group(ranks))
            if rank in ranks:
                groups[axis] = made[tuple(ranks)]
    return Mesh(shape, layout["coords"][rank], groups, torch.device(device))


def shard_batch(tree, mesh: Mesh):
    """A host-local batch (nested dicts of numpy arrays) as tensors on this
    rank's device, inside the span ``train.h2d``.  The loader already yields
    this rank's share of the global batch (``data/loader.py``: ``num_hosts``
    / ``host_id``)."""
    with span("train.h2d"):
        return _to_device(tree, mesh.device)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.from_numpy(tree).to(device)


@torch.no_grad()
def replicate_tree(module: torch.nn.Module) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place; a
    no-op without a process group."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, src=0)
    return module
