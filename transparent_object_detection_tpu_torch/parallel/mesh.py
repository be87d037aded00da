"""Rank layouts and the collectives over them (counterpart of
transparent_object_detection_tpu/parallel/mesh.py).

JAX runs one controller over a device mesh, and jit's global semantics put
the collectives in. The port runs one process per rank (parallel/
distributed.py), so a `Mesh` here is a layout of ranks on named axes
("data", and "model" for tensor parallelism, parallel/tp.py) together with
this process's process group along each axis, and the code that needs a
collective calls one:

  * serving (inference.Predictor): every rank is handed the global batch,
    runs the rows of its data index (`shard_batch`) and all-gathers the
    fixed-shape result over the data axis;
  * training (train/trainer.py): the step on a rank's rows equals the step
    on the global batch: BatchNorm statistics, the loss's normaliser and the
    gradients are summed over the data axis;
  * `replicate_state` broadcasts the first rank's weights, the counterpart
    of placing one replicated array.

Without a process group a mesh is a world of one rank and every collective
is the identity. With one, the collectives run even along axes of size 1,
so a world of one rank still goes through its backend. Gathers on NCCL
gather into one tensor (`all_gather_into_tensor`); gloo, which also runs on
CUDA tensors, takes the list form of `all_gather`. The values are the same.

A mesh is `capturable` when a CUDA graph can record its collectives: every
group it holds is NCCL's (one card a rank), or it has no process group.
gloo stages its transfers through the host, which a capture cannot record,
so a mesh with a gloo group runs its programs eagerly (inference.py,
train/trainer.py).

Tensor-parallel training differentiates through the model axis's
collectives (Megatron's regions), as `torch.autograd.Function`s:

  copy_to_model      identity forward; the gradient all-reduced backward
                     (the input of a column-parallel layer);
  reduce_from_model  all-reduce forward; identity backward (the output of a
                     row-parallel layer);
  gather_from_model  all-gather forward; this rank's slice of the gradient
                     backward (the outputs of a column-parallel layer, used
                     alike on every rank after it);
  scatter_to_model   this rank's slice forward; the gradients all-gathered
                     backward (a replicated value split for row-parallel
                     use).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from transparent_object_detection_tpu_torch.parallel.distributed import (
    process_count,
    process_index,
)

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _nccl(group) -> bool:
    """Whether `group`'s collectives go through NCCL."""
    return dist.get_backend(group) == dist.Backend.NCCL


class Mesh:
    """Ranks laid out row-major on named axes, with this process's group
    along each axis and over the whole mesh. Made by `make_mesh` or
    `parallel.tp.make_2d_mesh`; with a process group, every rank of the
    world must make the same meshes in the same order (process groups are
    made collectively)."""

    def __init__(self, ranks: Sequence[int], shape: Sequence[int], axis_names: Sequence[str]):
        ranks = [int(r) for r in ranks]
        if math.prod(shape) != len(ranks):
            raise ValueError(f"{len(ranks)} ranks do not fill a mesh of shape {tuple(shape)}")
        self.ranks = tuple(ranks)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.distributed = _distributed()
        world = process_count()
        if any(r < 0 or r >= world for r in ranks) or len(set(ranks)) != len(ranks):
            raise ValueError(f"ranks {ranks} are not distinct ranks of a world of {world}")
        me = process_index()
        grid = np.asarray(ranks).reshape(tuple(shape))
        self.coords: Optional[Dict[str, int]] = None
        if me in ranks:
            at = np.unravel_index(ranks.index(me), grid.shape)
            self.coords = dict(zip(self.axis_names, (int(i) for i in at)))
        self._groups: Dict[str, Any] = {}
        self.group_all = None
        if not self.distributed:
            return
        # one group along each axis for every line of the grid, made by all
        # ranks in the same order; this rank keeps the lines through it
        self.group_all = self._new_group(ranks, me)
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
            for line in lines:
                group = self._new_group([int(r) for r in line], me)
                if group is not None:
                    self._groups[name] = group

    @staticmethod
    def _new_group(ranks: List[int], me: int):
        group = dist.new_group(ranks)
        return group if me in ranks else None

    @property
    def member(self) -> bool:
        """Whether this process is one of the mesh's ranks."""
        return self.coords is not None

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (0 along an axis the mesh
        lacks)."""
        if self.coords is None:
            raise ValueError(f"rank {process_index()} is not in the mesh of ranks {self.ranks}")
        return self.coords.get(axis, 0)

    def first_rank(self, axis: str) -> int:
        """The rank at index 0 along `axis` on this rank's line of the grid."""
        grid = np.asarray(self.ranks).reshape(tuple(self.shape.values()))
        at = [self.coords[name] for name in self.axis_names]
        at[self.axis_names.index(axis)] = 0
        return int(grid[tuple(at)])

    def group(self, axis: str):
        """This rank's process group along `axis`; None without a process
        group, or along an axis the mesh lacks."""
        return self._groups.get(axis)

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture the mesh's collectives: true
        without a process group (each collective the identity) and when the
        whole mesh's group and every axis's group are NCCL's; false when any
        is gloo's."""
        if not self.distributed:
            return True
        return all(_nccl(g) for g in (self.group_all, *self._groups.values()))

    @property
    def layout(self) -> tuple:
        """The ranks and the named axes' sizes: what a compiled program of
        the mesh is keyed on (JAX keys its jitted programs on the mesh)."""
        return self.ranks, tuple(self.shape.items())

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, ranks={self.ranks})"


def make_mesh(devices: Optional[Sequence[int]] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over every rank of the world (or the ranks
    named in `devices`)."""
    ranks = list(devices) if devices is not None else list(range(process_count()))
    return Mesh(ranks, (len(ranks),), (axis_name,))


def local_batch_slice(global_batch: int, mesh: Mesh, axis_name: str = DATA_AXIS) -> int:
    """Rows a rank holds of a global batch; raises where the batch does not
    divide the data axis."""
    n = mesh.size(axis_name)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by mesh size {n}")
    return global_batch // n


def rows_of(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    """This rank's contiguous rows of a global batch (tensor or array)."""
    per = local_batch_slice(x.shape[0], mesh, axis_name)
    d = mesh.index(axis_name)
    return x[d * per:(d + 1) * per]


def shard_batch(batch: Dict[str, Any], mesh: Mesh, axis_name: str = DATA_AXIS) -> Dict[str, Any]:
    """This rank's rows of every array of a global batch dict."""
    return {k: rows_of(v, mesh, axis_name) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# collectives (the identity without a process group)
# ---------------------------------------------------------------------------


def all_reduce_sum(t: torch.Tensor, mesh: Optional[Mesh], axis: str = DATA_AXIS) -> torch.Tensor:
    """Sum `t` in place over `axis`; returns it."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return t


def broadcast_first(t: torch.Tensor, mesh: Optional[Mesh], axis: str) -> torch.Tensor:
    """`t` of the first rank along `axis` on every rank of this rank's line,
    in place; returns it."""
    if mesh is not None and mesh.distributed:
        dist.broadcast(t, src=mesh.first_rank(axis), group=mesh.group(axis))
    return t


def all_gather_list(t: torch.Tensor, mesh: Optional[Mesh], axis: str) -> List[torch.Tensor]:
    """Every rank's `t` along `axis`, in the axis's order."""
    if mesh is None or not mesh.distributed:
        return [t]
    return list(_gathered(t, mesh, axis).unbind(0))


def _gathered(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Every rank's `t` along `axis`, stacked on a new first dimension: on
    NCCL gathered into that tensor, on gloo through the list form."""
    t = t.contiguous()
    group = mesh.group(axis)
    out = torch.empty((mesh.size(axis), *t.shape), dtype=t.dtype, device=t.device)
    if _nccl(group):
        dist.all_gather_into_tensor(out, t, group=group)
    else:
        dist.all_gather(list(out.unbind(0)), t, group=group)
    return out


def all_gather_cat(t: torch.Tensor, mesh: Optional[Mesh], axis: str, dim: int) -> torch.Tensor:
    """Every rank's `t` along `axis`, concatenated on `dim`. A tensor laid
    out with `dim` innermost (a channels_last map gathered on its channels)
    is sent in its own memory and comes back in the same layout."""
    if mesh is None or not mesh.distributed:
        return t
    dim = dim % t.dim()
    moved = t.movedim(dim, -1)
    if moved.is_contiguous() and not t.is_contiguous():
        return _cat_gathered(_gathered(moved, mesh, axis), -1).movedim(-1, dim)
    return _cat_gathered(_gathered(t, mesh, axis), dim)


def _cat_gathered(stacked: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' tensors stacked on the first dimension, concatenated on
    `dim` of each (torch.cat of the list, in rank order)."""
    dim = dim % (stacked.dim() - 1)
    return stacked.movedim(0, dim).flatten(dim, dim + 1)


def _buckets(tensors: Sequence[torch.Tensor], max_bytes: int) -> Iterator[List[torch.Tensor]]:
    """Consecutive runs of tensors of one dtype and device, each at most
    `max_bytes` (a larger tensor is a run of its own)."""
    run: List[torch.Tensor] = []
    size = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or size + nbytes > max_bytes):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


COALESCE_BYTES = 256 << 20


def coalesced(tensors: Sequence[torch.Tensor], collective, max_bytes: int = COALESCE_BYTES) -> None:
    """Apply an in-place collective to `tensors` through flat buffers of at
    most `max_bytes`, copying the results back: far fewer calls than one a
    tensor, and the same values."""
    for run in _buckets(tensors, max_bytes):
        if len(run) == 1 and run[0].is_contiguous():
            collective(run[0])
            continue
        flat = torch.cat([t.reshape(-1) for t in run])
        collective(flat)
        offset = 0
        for t in run:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _state_tensors(state: Any) -> Iterator[torch.Tensor]:
    """The tensors of a module (parameters, then buffers), a dict, a list or
    a dataclass (a TrainState), in a fixed order."""
    if isinstance(state, torch.Tensor):
        yield state
    elif isinstance(state, nn.Module):
        yield from (p.detach() for p in state.parameters())  # shares the version counter
        yield from state.buffers()
    elif isinstance(state, dict):
        for key in state:
            yield from _state_tensors(state[key])
    elif isinstance(state, (list, tuple)):
        for item in state:
            yield from _state_tensors(item)
    elif dataclasses.is_dataclass(state):
        for field in dataclasses.fields(state):
            yield from _state_tensors(getattr(state, field.name))


@torch.no_grad()
def replicate_state(state: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor of `state` (a module, a TrainState, dicts of
    tensors) from the mesh's first rank to all of its ranks, in place, so
    that each holds the same weights; returns `state`."""
    if mesh.distributed:
        src = mesh.ranks[0]
        coalesced(list(_state_tensors(state)),
                  lambda t: dist.broadcast(t, src=src, group=mesh.group_all))
    return state


# ---------------------------------------------------------------------------
# the model axis's collectives with their gradients (tensor-parallel training)
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return all_reduce_sum(x.contiguous().clone(), mesh, MODEL_AXIS)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _own_slice(t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    tp = mesh.size(MODEL_AXIS)
    width = t.shape[dim] // tp
    return t.narrow(dim, mesh.index(MODEL_AXIS) * width, width)


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather_cat(x, mesh, MODEL_AXIS, dim)

    @staticmethod
    def backward(ctx, grad):
        return _own_slice(grad, ctx.mesh, ctx.dim), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _own_slice(x, mesh, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather_cat(grad.contiguous(), ctx.mesh, MODEL_AXIS, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x`; its gradient summed over the model axis."""
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` summed over the model axis (a new tensor); the gradient passes."""
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """Every rank's `x` along the model axis, concatenated on `dim`; the
    gradient's slice of this rank passes back."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def scatter_to_model(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's slice of `x` on `dim` (tp equal parts); the ranks'
    gradients are all-gathered back."""
    return _ScatterToModel.apply(x, mesh, dim % x.dim())
