"""Failure handling for the model group (the port of the failure half of
``repro/runtime/elastic.py``).

On a real pod a node failure surfaces as a collective timeout or a missing
participant.  The recovery is: detect, rebuild the model group from the
surviving ranks, refit the state onto it, continue.  ``NodeFailure`` names
the survivors, ``pick_mesh_shape`` the (data, model) grid a rank count
allows, and :func:`make_group_from` is the counterpart of the reference's
``make_mesh_from``: a new process group over a list of global ranks.  The
training loop (``ElasticRunner``) waits for ROADMAP A14.
"""
from __future__ import annotations

import torch.distributed as dist


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


def group_ranks(group) -> list:
    """The global ranks of ``group``'s members, in group-rank order."""
    return dist.get_process_group_ranks(group)


def make_group_from(ranks) -> object:
    """A model group over the global ``ranks`` (every one of them a
    member: the port has no data axis).  ``dist.new_group`` is collective
    over the default group, so every live process calls this, members or
    not; a process outside ``ranks`` gets a non-member handle and must stop
    serving."""
    ranks = sorted(int(r) for r in ranks)
    if not ranks:
        raise ValueError("make_group_from: no ranks")
    return dist.new_group(ranks=ranks)


class NodeFailure(RuntimeError):
    """Raised (by monitoring, or injected in tests) when members drop;
    ``surviving_ranks`` are the global ranks left."""

    def __init__(self, surviving_ranks):
        super().__init__(f"{len(surviving_ranks)} members survive")
        self.surviving_ranks = list(surviving_ranks)


class Evicted(RuntimeError):
    """Raised on a process that a recovery left out of the model group: it
    serves no further batches."""
