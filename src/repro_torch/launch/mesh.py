"""Process-group set-up: the model axis of the DLRM path, and the (data,
model) grid of the LM path.

Nothing tells a program of a cluster, so the caller gives the rendezvous
address (``tcp://localhost:<port>``, ``file://<path>`` or ``env://`` under
torchrun), the world size and the rank.  NCCL on the card, gloo on the CPU
(and, for two members on one card, gloo with CUDA tensors).

The DLRM path takes every rank of the default group as one table-parallel
member of the ``model`` axis (:func:`init_model_group`,
:func:`current_group`).  The LM path runs over a :class:`Mesh`, the port's
counterpart of the reference's ``jax.sharding.Mesh``: a (data, model) grid
of global ranks with one process group per row (the ``model`` axis) and one
per column (the ``data`` axis).  :func:`make_host_mesh` builds it over the
default group's world, as the reference's builds it over every device.
:func:`make_production_mesh` gives the reference's production grids, (data
16, model 16) over ranks 0-255 and (pod 2, data 16, model 16) over ranks
0-511; the ``pod`` axis carries only the batch (the "batch" rule's
``("pod", "data")``), as in the reference.
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
# whether this torch's new_group can keep its ranks in the order given
# (older ones always sort them)
_KEEPS_ORDER = "sort_ranks" in inspect.signature(dist.new_group).parameters


def init_model_group(backend: str, world_size: int, rank: int,
                     init_method: str):
    """Join the model axis as member ``rank`` of ``world_size``; NCCL ranks
    take card ``rank`` modulo the cards visible.  Returns the group."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.group.WORLD


def current_group():
    """The model-axis group, or None when no process group is set up (the
    forward then runs single-device)."""
    return dist.group.WORLD if dist.is_initialized() else None


def destroy_model_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass
class Mesh:
    """A grid of global ranks over the axes of ``shape`` (``(data, model)``,
    or ``(pod, data, model)`` for the multi-pod production grid),
    row-major: on a (data, model) grid rank ``ranks[i * model + j]`` sits
    at data ``i``, model ``j``.

    ``shape`` and ``coords`` are dicts by axis name (``coords`` is None on a
    process the grid leaves out); ``groups[axis]`` is this process's group
    along ``axis`` (its row for ``model``, its column for ``data``), and
    ``groups["all"]`` the whole grid's; each is None where it has one
    member or the process is no member: a collective over one member is
    the identity, and the port skips it."""
    shape: dict
    ranks: tuple
    coords: Optional[dict]
    groups: dict
    axis_names: tuple = AXES

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def is_member(self) -> bool:
        return self.coords is not None

    def group(self, axis: str):
        return self.groups.get(axis)

    def index(self, axis: str) -> int:
        return self.coords[axis] if self.coords is not None else 0


def _new_group(line):
    """A process group over the global ranks of ``line`` whose group ranks
    follow the line's order.  Collective over the default group."""
    line = list(line)
    if line == sorted(line):
        return dist.new_group(ranks=line)
    if not _KEEPS_ORDER:
        raise NotImplementedError(
            f"a group over ranks {line} (not ascending) needs a torch whose "
            f"new_group takes sort_ranks; this one sorts them")
    return dist.new_group(ranks=line, sort_ranks=False)


def _grid(ranks, shape: dict) -> Mesh:
    """A mesh over the global ``ranks`` in a grid of ``shape`` (axis name ->
    size, row-major).  Every process of the default group must call this,
    members or not, in the same order: ``dist.new_group`` is collective
    over the default group.

    Each group keeps its ranks in grid order (:func:`_new_group`), so a
    member's rank in its group along an axis is its coordinate there, as
    ``shard_leaf`` cuts and every gather joins; ``WORLD`` serves only the
    identity order."""
    ranks = tuple(int(r) for r in ranks)
    axes, sizes = tuple(shape), tuple(shape.values())
    if len(ranks) != math.prod(sizes):
        raise ValueError(f"{len(ranks)} ranks do not fill a {sizes} grid")
    shape = dict(shape)
    me = dist.get_rank() if dist.is_initialized() else ranks[0]
    coords = None
    if me in ranks:
        coords = {a: int(c) for a, c in
                  zip(axes, np.unravel_index(ranks.index(me), sizes))}
    groups = {**{a: None for a in axes}, "all": None}
    if not dist.is_initialized():
        return Mesh(shape, ranks, coords, groups, axes)
    if len(ranks) > 1:
        g = dist.group.WORLD if ranks == tuple(range(dist.get_world_size())) \
            else _new_group(ranks)
        if coords is not None:
            groups["all"] = g
    grid = np.array(ranks).reshape(sizes)
    # the model rows first, then the data columns, then the pod lines
    for i in reversed(range(len(axes))):
        if sizes[i] == 1:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, sizes[i]).tolist():
            g = _new_group(line)
            if me in line:
                groups[axes[i]] = g
    if coords is not None:
        at = {"all": ranks.index(me), **coords}
        for axis, g in groups.items():
            if g is not None and dist.get_rank(g) != at[axis]:
                raise RuntimeError(
                    f"rank {me} is {dist.get_rank(g)} in its {axis!r} group "
                    f"but at {at[axis]} on the mesh")
    return Mesh(shape, ranks, coords, groups, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """The (data, model) grid over every rank of the default group (one
    member without a process group): ``model`` is capped at the world size
    and the data axis takes the rest, as the reference's ``make_host_mesh``
    does over its devices."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = min(model, n)
    if n % model:
        raise ValueError(f"a model axis of {model} does not divide {n} ranks")
    return _grid(range(n), {"data": n // model, "model": model})


def make_mesh(ranks, data: int, model: int) -> Mesh:
    """A (data, model) grid over the given global ranks (collective over the
    default group; see :func:`_grid`)."""
    return _grid(ranks, {"data": data, "model": model})


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data 16, model 16) over ranks 0-255 of the default
    group.  Multi-pod: (pod 2, data 16, model 16) over ranks 0-511; the
    pod axis carries pure data parallelism (training) or replica serving
    (inference).  Collective over the default group (see :func:`_grid`),
    which must hold at least that many ranks: with fewer it raises
    ``ValueError``, as the reference fails without the devices."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    need = math.prod(shape.values())
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise ValueError(f"the production mesh {tuple(shape.values())} "
                         f"needs {need} processes; the process group has "
                         f"{have}")
    return _grid(range(need), shape)
