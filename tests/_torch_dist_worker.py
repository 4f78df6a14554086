"""One member of the port's multi-member CPU runs (gloo).

    python tests/_torch_dist_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (reference parameters and batches, flattened by
:func:`flatten`), joins a gloo group through ``file://<dir>/store``, and
writes ``<dir>/out_<rank>.npz``: per config, ``forward_distributed``
logits at bound 0 and 2 (2 microbatches) and the CTRs of a
``DLRMEngine(bound=2, microbatches=2)`` on the same batch.  Imports only
the port (``src`` on PYTHONPATH).  :func:`run_members` starts the members
of any such worker from a test.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch


def flatten(prefix, params, out):
    """Reference parameter pytree -> flat ``{prefix/key: array}``."""
    out[f"{prefix}/tables"] = np.asarray(params["tables"])
    for part in ("bot", "top"):
        for i, lp in enumerate(params[part]):
            for k, v in lp.items():
                out[f"{prefix}/{part}/{i}/{k}"] = np.asarray(v)


def unflatten(prefix, data):
    params = {"tables": data[f"{prefix}/tables"], "bot": [], "top": []}
    for part in ("bot", "top"):
        i = 0
        while f"{prefix}/{part}/{i}/kernel" in data:
            params[part].append({k: data[f"{prefix}/{part}/{i}/{k}"]
                                 for k in ("kernel", "bias")})
            i += 1
    return params


def run_members(worker: Path, world: int, inputs: dict, d: Path,
                timeout: float = 300.0) -> list:
    """Write ``inputs`` to ``d/inputs.npz``, run ``world`` members of
    ``worker`` (each ``worker rank world d``) and return each member's
    ``out_<rank>.npz`` as a dict; a member that fails fails the caller
    with its log."""
    np.savez(d / "inputs.npz", **inputs)
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r),
                               str(world), str(d)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [dict(np.load(d / f"out_{r}.npz")) for r in range(world)]


def main(rank, world, d):
    from repro_torch.configs import dlrm_kaggle
    from repro_torch.launch import mesh
    from repro_torch.models import dlrm
    from repro_torch.serving.engine import DLRMEngine

    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    out = {}
    try:
        for name in data["configs"]:
            cfg = getattr(dlrm_kaggle, str(name))()
            params = dlrm.params_from_jax(unflatten(name, data), "cpu")
            dense, idx, mask = (torch.from_numpy(data[f"{name}/{k}"])
                                for k in ("dense", "idx", "mask"))
            for bound in (0, 2):
                out[f"{name}/logits_b{bound}"] = dlrm.forward_distributed(
                    params, cfg, dense, idx, mask, bound=bound,
                    microbatches=2).numpy()
            eng = DLRMEngine(params, cfg, batch_size=dense.shape[0],
                             bound=2, microbatches=2, device="cpu")
            for i in range(dense.shape[0]):
                ctr = eng.submit(dense[i].numpy(), idx[i].numpy(),
                                 mask[i].numpy())
            out[f"{name}/engine_ctr"] = ctr
    finally:
        mesh.destroy_model_group()
    np.savez(d / f"out_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
