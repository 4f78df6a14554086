"""Multi-host utilities (the port of ``repro/launch/multihost.py``):
process-group bring-up, host-local data sharding, and coordinated-restart
bookkeeping.

The port runs one process a member, so a "host" of the reference is a
process here, with one device.  ``bringup()`` joins ``torch.distributed``
from the reference's environment variables; ``host_batch_slice`` and
``form_global_array`` implement the "every process loads only its rows"
input path; ``RestartBarrier`` agrees on the step to restore.  With one
process everything degrades to identity, so the code path is always
exercised.

A reference host holds several devices, so its rows by process index are
the rows of its devices.  Here a process is one member: on a mesh with a
model axis the members of one data row must load the same rows, so
``host_batch_slice`` takes the mesh and cuts by the data block.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.sharding import partition


def bringup(coordinator: Optional[str] = None,
            num_processes: Optional[int] = None,
            process_id: Optional[int] = None, *, device="cuda") -> dict:
    """Join ``torch.distributed`` from the arguments or the standard
    environment variables (``COORDINATOR_ADDRESS`` as ``host:port``,
    ``NUM_PROCESSES``, ``PROCESS_ID``): NCCL for a CUDA ``device``, gloo
    for the CPU; an NCCL process takes card ``process_id`` modulo the
    cards it sees.  With one process, or a group already set up, it
    initialises nothing."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", 1))
    process_id = process_id if process_id is not None else \
        int(os.environ.get("PROCESS_ID", 0))
    dev = resolve_device(device)
    if coordinator and num_processes > 1 and not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }


def _process() -> tuple[int, int]:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def host_batch_slice(global_batch: int, mesh=None) -> tuple:
    """[start, stop) rows of the global batch this process must load: with
    ``mesh``, its member's block along the axes of the "batch" rule (the
    members of one data row load the same rows); without, its share by
    process index (pure data parallelism, the reference's host)."""
    if mesh is None:
        n, i = _process()
        what = "processes"
    else:
        n, i = partition.block(mesh, partition.spec("batch", mesh=mesh)[0])
        what = "data blocks"
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} {what}")
    per = global_batch // n
    return i * per, (i + 1) * per


def form_global_array(host_local: np.ndarray, mesh, spec: tuple, *,
                      global_batch: Optional[int] = None,
                      device="cuda") -> torch.Tensor:
    """This process's rows (``host_local``, batch-major, every column) as
    its member's block of the global array laid out by ``spec`` (one
    mesh-axis entry a dimension, as ``partition.spec`` resolves them) on
    ``mesh``, on ``device``.  The port holds no global array: each member
    keeps its block.  The rows are the block ``spec`` gives this member
    along the first dimension (:func:`host_batch_slice` with the mesh);
    with ``global_batch`` their count is checked against it.  A later
    dimension that ``spec`` cuts is narrowed to this member's block."""
    x = torch.as_tensor(np.asarray(host_local))
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    if global_batch is not None:
        n_rows, _ = partition.block(mesh, spec[0])
        if global_batch % n_rows or x.shape[0] != global_batch // n_rows:
            raise ValueError(
                f"{x.shape[0]} host rows are not this member's block of a "
                f"{global_batch}-row global batch along {spec[0]!r} "
                f"({n_rows} blocks)")
    return partition.shard_leaf(x, (None,) + spec[1:], mesh).to(
        resolve_device(device))


@dataclasses.dataclass
class RestartBarrier:
    """Coordinated-restart bookkeeping: all processes agree on the restore
    step before resuming, the minimum of their latest committed steps,
    which prevents a torn restart.  The value travels through one
    ``all_reduce(MIN)`` over the mesh's whole group (None counts as -1):
    if any process has no committed step, every one raises."""

    def agree_on_step(self, local_latest: Optional[int], mesh) -> int:
        val = -1 if local_latest is None else int(local_latest)
        group = mesh.group("all")
        if group is None and dist.is_initialized() and \
                mesh.ranks == tuple(range(dist.get_world_size())):
            group = dist.group.WORLD    # a one-member mesh over the world
        if group is not None:
            dev = torch.device("cuda", torch.cuda.current_device()) \
                if dist.get_backend(group) == "nccl" else torch.device("cpu")
            t = torch.tensor([val], dtype=torch.int64, device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
            val = int(t.item())
        if val < 0:
            raise FileNotFoundError("a process has no committed checkpoint")
        return val
