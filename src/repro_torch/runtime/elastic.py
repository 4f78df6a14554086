"""Elastic scaling and failure handling (the port of
``repro/runtime/elastic.py``).

On a real pod a node failure surfaces as a collective timeout or a missing
participant.  The recovery is: detect, rebuild the mesh from the surviving
ranks, reshard (or restore) the state onto it, continue.  ``NodeFailure``
names the survivors, :func:`pick_mesh_shape` the (data, model) grid a rank
count allows, :func:`make_mesh_from` builds that grid over the survivors
(:func:`make_group_from`: the DLRM path's model group), :func:`reshard`
moves a live tree from one layout to another, and :class:`ElasticRunner`
packages the training loop.

Every process of the default group enters a mesh or group built from
survivors (``dist.new_group`` is collective over it), the failed ones too
where they are still alive; a process the new mesh leaves out raises
:class:`Evicted` and takes no further step.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.sharding import partition


def pick_mesh_shape(n_devices: int, model: int = 0) -> tuple:
    """Largest (data, model) grid for n_devices.  model=0 -> widest power-of-
    two model axis <= n_devices (params sharded that way keep working)."""
    if model <= 0:
        model = 1
        while model * 2 <= min(n_devices, 16):
            model *= 2
    while n_devices % model:
        model //= 2
    return (n_devices // model, model)


def make_mesh_from(ranks, model: int = 0) -> mesh_mod.Mesh:
    """The (data, model) grid of :func:`pick_mesh_shape` over the first
    ranks of ``ranks`` (in the order given).  Collective over the default
    group when one is up."""
    ranks = [int(r) for r in ranks]
    data, model = pick_mesh_shape(len(ranks), model)
    return mesh_mod.make_mesh(ranks[:data * model], data, model)


def group_ranks(group) -> list:
    """The global ranks of ``group``'s members, in group-rank order."""
    return dist.get_process_group_ranks(group)


def make_group_from(ranks) -> object:
    """A model group over the global ``ranks`` (every one of them a
    member: the DLRM path has no data axis).  ``dist.new_group`` is
    collective over the default group, so every live process calls this,
    members or not; a process outside ``ranks`` gets a non-member handle and
    must stop serving."""
    ranks = sorted(int(r) for r in ranks)
    if not ranks:
        raise ValueError("make_group_from: no ranks")
    return dist.new_group(ranks=ranks)


def _holder_block(old, rank: int, entry) -> int:
    """The block of a dimension cut over ``entry`` that ``rank`` held on
    the ``old`` mesh."""
    at = old.ranks.index(rank)
    coords = {"data": at // old.shape["model"],
              "model": at % old.shape["model"]}
    i = 0
    for a in partition._axes(entry):
        i = i * old.shape[a] + coords[a]
    return i


def _reshard_leaf(x, spec_from, spec_to, old, new):
    """One leaf from its ``old`` layout to its ``new``: the full leaf
    joined from survivors holding every block (of each cut dimension: a
    leaf may be cut over ``model`` and ``data`` both), then cut anew."""
    dims = [d for d, e in enumerate(spec_from) if partition._axes(e)]
    if not dims:
        return partition.shard_leaf(x, spec_to, new)
    counts = [partition.block(old, spec_from[d])[0] for d in dims]
    holders = {}
    for r in new.ranks:
        if r in old.ranks:
            holders.setdefault(tuple(_holder_block(old, r, spec_from[d])
                                     for d in dims), r)
    missing = [i for i in itertools.product(*map(range, counts))
               if i not in holders]
    if missing:
        raise ValueError(f"reshard: no survivor holds block(s) {missing} of "
                         f"{tuple(counts)} of a leaf cut by {spec_from}")
    group = new.group("all")
    if group is None:          # the one survivor holds every block
        full = x
    else:
        parts = [torch.empty_like(x) for _ in range(new.size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        at = {r: parts[j] for j, r in enumerate(new.ranks)}

        def join(prefix):
            k = len(prefix)
            if k == len(dims):
                return at[holders[prefix]]
            return partition.join_blocks(
                [join(prefix + (i,)) for i in range(counts[k])],
                spec_from[dims[k]], dims[k])

        full = join(())
    return partition.shard_leaf(full, spec_to, new)


def reshard(tree, layout_from: Optional[partition.Layout],
            layout_to: Optional[partition.Layout]):
    """Move a live tree from ``layout_from`` onto ``layout_to``, among the
    survivors only (the old mesh may hold a member that is gone): a leaf
    whole on this member is cut for the new mesh; a cut leaf is rebuilt
    from the survivors' blocks (one ``all_gather`` over the new mesh) and
    raises where a block is held by no survivor.  Data-parallel replicas
    hold every block.  Without layouts (one device) the tree is returned as
    it is."""
    if layout_to is None:
        return tree
    if layout_from is None:
        return partition.shard_tree(tree, layout_to)
    return partition.map_specs(
        lambda _, s_from, s_to, x: _reshard_leaf(
            x, s_from, s_to, layout_from.mesh, layout_to.mesh),
        layout_from.specs, layout_to.specs, tree)


def _barrier(mesh) -> None:
    if mesh is not None and mesh.group("all") is not None:
        dist.barrier(group=mesh.group("all"))


@dataclasses.dataclass
class ElasticRunner:
    """Run a step function under simulated-failure recovery.

    step_fn(state, batch, mesh) -> state; on NodeFailure the runner rebuilds
    the mesh from the survivors, restores the last checkpoint AND rewinds
    the data stream to the step after it (deterministic per-(seed, step)
    data makes the replay exact), or else reshards the live state and
    retries the step.  No step is skipped.  ``make_shardings(mesh)`` gives
    the state's layout on a mesh (None: one device, nothing to cut).  A
    checkpoint of a laid-out state is gathered to full leaves and written
    by the mesh's first rank; restore cuts it for the new mesh.
    """

    make_shardings: Callable   # mesh -> Layout of the state (or None)
    ckpt_dir: Optional[str] = None
    max_recoveries: int = 8

    def run(self, state, make_batches, step_fn, mesh, *,
            fault: Optional[Callable[[int], None]] = None,
            ckpt_every: int = 0):
        """make_batches(start_step) -> iterator of batches from that step.
        Returns (state, mesh, recoveries); raises :class:`Evicted` on a
        process a recovery leaves out."""
        if not callable(make_batches):
            seq = list(make_batches)
            make_batches = lambda s: iter(seq[s:])  # noqa: E731
        recoveries = 0
        layout = self.make_shardings(mesh) if mesh is not None else None
        saver = (ckpt.AsyncCheckpointer(self.ckpt_dir)
                 if self.ckpt_dir else None)
        step = 0
        it = enumerate(make_batches(0))
        while True:
            try:
                try:
                    step, batch = next(it)
                except StopIteration:
                    break
                if fault is not None:
                    fault(step)  # may raise NodeFailure
                state = step_fn(state, batch, mesh)
                if saver and ckpt_every and step % ckpt_every == 0:
                    saver.wait()  # surface async errors promptly
                    saver.save(step, state, layout=layout)
            except NodeFailure as e:
                recoveries += 1
                if recoveries > self.max_recoveries:
                    raise
                new_mesh = make_mesh_from(e.surviving_ranks)
                if not new_mesh.is_member:
                    if saver:
                        saver.wait()
                    raise Evicted(f"left out of the mesh over "
                                  f"{list(new_mesh.ranks)}") from e
                new_layout = self.make_shardings(new_mesh)
                if self.ckpt_dir and \
                        ckpt.latest_step(self.ckpt_dir) is not None:
                    if saver:
                        saver.wait()
                    _barrier(new_mesh)   # the writer's files are committed
                    state, restored = ckpt.restore(self.ckpt_dir, state,
                                                   layout=new_layout)
                    resume = restored + 1  # replay everything after it
                else:
                    state = reshard(state, layout, new_layout)
                    resume = step  # live state is current; retry this step
                mesh, layout = new_mesh, new_layout
                it = enumerate(make_batches(resume), start=resume)
        if saver:
            saver.wait()
        return state, mesh, recoveries


class NodeFailure(RuntimeError):
    """Raised (by monitoring, or injected in tests) when members drop;
    ``surviving_ranks`` are the global ranks left."""

    def __init__(self, surviving_ranks):
        super().__init__(f"{len(surviving_ranks)} members survive")
        self.surviving_ranks = list(surviving_ranks)


class Evicted(RuntimeError):
    """Raised on a process that a recovery left out of the model group or
    the mesh: it serves and trains no further."""
