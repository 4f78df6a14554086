"""One process of the port's multihost checks on gloo.

    python tests/_torch_multihost_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (``port``: the coordinator's port, ``latest``:
each process's latest committed step, -1 for none, ``rows``: the global
batch), joins a gloo group through ``bringup`` and writes
``<dir>/out_<rank>.npz``: ``bringup``'s keys, this process's
``host_batch_slice`` and ``form_global_array`` block on the (4, 1) mesh
and on the (2, 2) mesh (with its data index there), the step
``RestartBarrier`` agrees on, and whether the barrier raised when one
process has no step and ``form_global_array`` when the rows are not the
member's block.  Imports only the port (``src`` on PYTHONPATH).
"""
import sys
from pathlib import Path

import numpy as np
import torch


def main(rank: int, world: int, d: Path) -> None:
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.multihost import (RestartBarrier, bringup,
                                              form_global_array,
                                              host_batch_slice)

    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    info = bringup(f"localhost:{int(data['port'])}", world, rank,
                   device="cpu")
    mesh = make_host_mesh()
    out = {k: np.asarray(v) for k, v in info.items()}
    rows = data["rows"]
    n = rows.shape[0]
    lo, hi = host_batch_slice(n)
    if host_batch_slice(n, mesh) != (lo, hi):
        raise AssertionError("on the (4, 1) mesh the data block is the "
                             "process's share")
    out["slice"] = np.array([lo, hi])
    out["block"] = form_global_array(rows[lo:hi], mesh, ("data", None),
                                     global_batch=n, device="cpu").numpy()
    # (data 2, model 2): the two members of a data row load its rows
    mesh22 = make_host_mesh(model=2)
    lo2, hi2 = host_batch_slice(n, mesh22)
    out["data_index"] = np.asarray(mesh22.index("data"))
    out["slice22"] = np.array([lo2, hi2])
    out["block22"] = form_global_array(rows[lo2:hi2], mesh22,
                                       ("data", None), global_batch=n,
                                       device="cpu").numpy()
    try:    # rows by process index are not a member's block there
        form_global_array(rows[lo:hi], mesh22, ("data", None),
                          global_batch=n, device="cpu")
        out["mismatch_raised"] = np.asarray(False)
    except ValueError:
        out["mismatch_raised"] = np.asarray(True)
    barrier = RestartBarrier()
    out["agreed"] = np.asarray(barrier.agree_on_step(
        int(data["latest"][rank]), mesh))
    mine = None if rank == world - 1 else int(data["latest"][rank])
    try:
        barrier.agree_on_step(mine, mesh)
        out["raised"] = np.asarray(False)
    except FileNotFoundError:
        out["raised"] = np.asarray(True)
    np.savez(d / f"out_{rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
