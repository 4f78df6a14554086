"""One member of the port's DLRM train step over gloo on the CPU.

    python tests/_torch_dlrm_train_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (the reference's parameters flattened by
``_torch_dist_worker.flatten`` under "p", and the batch), joins a gloo
group of ``world_size`` members through ``file://<dir>/store``, holds its
own tables (its block of the padded stack) and writes
``<dir>/out_<rank>.npz``: ``models.dlrm.loss_and_grads`` at bound 0 with
one microbatch and at bound 2 with four (the loss and every leaf's
gradient), and which exchange options raise ``ValueError`` under
autograd.  Imports only the port (``src`` on PYTHONPATH).
"""
import sys
from pathlib import Path

import numpy as np
import torch

from _torch_dist_worker import unflatten

SCHEDULES = ((0, 1), (2, 4))
REFUSED = {"wire_dtype": "bfloat16", "exchange": "ragged",
           "exchange_pipeline": "ring"}


def main(rank, world, d):
    from repro_torch.configs import dlrm_kaggle
    from repro_torch.launch import mesh
    from repro_torch.models import dlrm

    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    cfg = dlrm_kaggle.smoke()
    out = {}
    try:
        params = dlrm.params_from_jax(unflatten("p", data), "cpu")
        t_loc = params["tables"].shape[0] // world
        params["tables"] = params["tables"][rank * t_loc:(rank + 1) * t_loc] \
            .clone()
        batch = {k: torch.from_numpy(data[k])
                 for k in ("dense", "idx", "mask", "labels")}
        for bound, mb in SCHEDULES:
            loss, grads = dlrm.loss_and_grads(params, cfg, batch,
                                              bound=bound, microbatches=mb)
            tag = f"b{bound}_mb{mb}"
            out[f"{tag}/loss"] = loss.numpy()
            out[f"{tag}/tables"] = grads["tables"].numpy()
            for part in ("bot", "top"):
                for i, lp in enumerate(grads[part]):
                    for k, v in lp.items():
                        out[f"{tag}/{part}/{i}/{k}"] = v.numpy()
        for name, value in REFUSED.items():
            try:
                with torch.enable_grad():
                    params["tables"].requires_grad_(True)
                    dlrm.forward_distributed(
                        params, cfg, batch["dense"], batch["idx"],
                        batch["mask"], **{name: value})
                out[f"refused/{name}"] = np.array(False)
            except ValueError as e:
                out[f"refused/{name}"] = np.array("autograd" in str(e))
            finally:
                params["tables"].requires_grad_(False)
    finally:
        mesh.destroy_model_group()
    np.savez(d / f"out_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
