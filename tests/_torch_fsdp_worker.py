"""One member of the port's FSDP train steps over gloo on the CPU.

    python tests/_torch_fsdp_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (each case's batch, ``<case>/<key>``), joins a
gloo group through ``file://<dir>/store`` and, on a (2, 1) mesh (world 2)
or a (2, 2) one (world 4) under each case's train ``arch_rules``, takes
one ``make_train_step`` step from ``api.init(0, cfg, dtype="float32")``'s
parameters cut by ``api.param_layout`` (the step takes this member's rows
of the global batch).  Writes ``<dir>/out_<rank>.npz``: per case the
loss and grad_norm (every backward run in a thread of its own, as on the
card), this member's blocks of the parameters and of AdamW's
m after the step (``<case>/params/<path>``, ``<case>/m/<path>``), which
leaves are cut over ``data`` (``<case>/data_cut``), and whether the state
saved as full leaves to ``<dir>/ckpt_<case>`` restores onto the mesh as
the same blocks (``<case>/ckpt_roundtrip``).  Imports only the port
(``src`` on PYTHONPATH).
"""
import sys
from pathlib import Path

import numpy as np
import torch

CASES = {"dense": "qwen3-14b", "moe": "qwen2-moe-a2.7b",
         "audio": "whisper-tiny"}
BATCH, SEQ = 4, 16


def config(case):
    from repro_torch.configs import base as cb
    return cb.get_arch(CASES[case]).smoke()


def backward_in_a_thread():
    """Run every ``Tensor.backward`` in a thread of its own, as autograd
    runs a CUDA graph's backward in its device thread: a remat region's
    recompute there sees no ambient mesh (``partition.axis_rules`` is
    thread-local), so what it gathers must be resolved in the forward."""
    import threading

    run_backward = torch.Tensor.backward

    def backward(self, *args, **kwargs):
        err = []

        def run():
            try:
                run_backward(self, *args, **kwargs)
            except BaseException as e:  # re-raised in the caller
                err.append(e)

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if err:
            raise err[0]

    torch.Tensor.backward = backward


def main(rank, world, d):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import specs
    from repro_torch.models import api
    from repro_torch.runtime import checkpoint as C
    from repro_torch.sharding import partition
    from repro_torch.train import optimizer as opt
    from repro_torch.train import steps as steps_mod

    torch.set_num_threads(1)
    backward_in_a_thread()
    data = dict(np.load(d / "inputs.npz"))
    mesh_mod.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    out = {}
    try:
        mesh = mesh_mod.make_mesh(range(world), 2, world // 2)
        for case in CASES:
            cfg = config(case)
            batch = {k[len(case) + 1:]: torch.from_numpy(v)
                     for k, v in data.items() if k.startswith(case + "/")}
            rules = specs.arch_rules(cfg, mesh, ShapeConfig(
                "t", "train", SEQ, BATCH))
            with partition.axis_rules(mesh, rules):
                lay = api.param_layout(cfg)
                params = api.init(0, cfg, "cpu", dtype="float32",
                                  layout=lay)
                state = opt.adamw_init(params)
                # this member's rows: the "batch" rule's block
                nd, i = partition.block(mesh, partition.spec("batch")[0])
                rows = {k: v[i * BATCH // nd:(i + 1) * BATCH // nd]
                        for k, v in batch.items()}
                step = steps_mod.make_train_step(cfg, global_batch=BATCH)
                params, state, m = step(params, state, rows)
                st_lay = partition.Layout(mesh, (
                    lay.specs, opt.adamw_layout(lay).specs))
                C.save(str(d / f"ckpt_{case}"), 0, (params, state),
                       layout=st_lay)
                torch.distributed.barrier()     # the first rank wrote it
                template = (opt._like(params, torch.zeros_like),
                            opt.adamw_init(params))
                (back, back_state), _ = C.restore(
                    str(d / f"ckpt_{case}"), template, layout=st_lay)
            out[f"{case}/loss"] = m["loss"].numpy()
            out[f"{case}/grad_norm"] = m["grad_norm"].numpy()
            for k, v in C._flatten(params).items():
                out[f"{case}/params/{k}"] = v.numpy()
            for k, v in C._flatten(state["m"]).items():
                out[f"{case}/m/{k}"] = v.numpy()
            cut = []
            partition.map_specs(lambda path, s: cut.append("/".join(path))
                                if "data" in s else None, lay.specs)
            out[f"{case}/data_cut"] = np.array(cut)
            out[f"{case}/ckpt_roundtrip"] = np.array(all(
                torch.equal(a, b) for a, b in zip(
                    opt.leaves((params, state)),
                    opt.leaves((back, back_state)))))
    finally:
        mesh_mod.destroy_model_group()
    np.savez(d / f"out_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
