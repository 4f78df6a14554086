"""Process-group set-up for the model axis.

Stands in for the reference's ambient mesh (``sharding/partition.py``):
every rank of the default process group is one table-parallel member of
the ``model`` axis.  NCCL on the card, gloo on the CPU.  Nothing tells a
program of a cluster, so the caller gives the rendezvous address
(``tcp://localhost:<port>`` or ``file://<path>``), the world size and the
rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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
