"""One member of the port's multi-member exchange runs (gloo).

    python tests/_torch_exchange_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz``: per config (``configs``) the reference
parameters (flattened by ``_torch_dist_worker.flatten``; those of the bf16
config ``smoke_bf16`` as their 16-bit patterns), a batch and the cache
sizes to build from it; optionally (``engine``) a calibration batch
and the serving batches of the cap-autotuner run.  Joins a gloo group
through ``file://<dir>/store`` and writes ``<dir>/out_<rank>.npz``: per
config and grid point (cache rows, codec, exchange, pipeline, bound and
microbatches) the ``forward_distributed`` logits and the diagnostics'
``live_max`` and ``drops``; one ragged run at a tight ``ragged_cap`` per
config; and the engine runs' CTRs and autotuner state.  Imports only the
port (``src`` on PYTHONPATH).
"""
import itertools
import sys
from pathlib import Path

import numpy as np
import torch

from _torch_dist_worker import unflatten

CODECS = ("float32", "bfloat16", "int8")
EXCHANGES = ("dense", "ragged")
PIPES = ("mono", "ring")
# (bound, microbatches): bound 2 is held against bound 0 at 4 microbatches
SCHEDULES = ((0, 1), (0, 4), (2, 4))


def config(name):
    from repro_torch.configs import dlrm_kaggle
    from repro_torch.configs.base import DLRMConfig

    if name == "six":
        return DLRMConfig(name="t", table_sizes=(100, 50, 80, 60, 90, 40),
                          embed_dim=16, bottom_mlp=(32, 16),
                          top_mlp=(32, 1), max_hot=4)
    if name == "smoke_bf16":
        return dlrm_kaggle.smoke().replace(dtype="bfloat16")
    return getattr(dlrm_kaggle, name)()


def port_params(name, data):
    """The port's parameters of config ``name``; a bf16 config's leaves
    cross the npz as their 16-bit patterns."""
    from repro_torch.models import dlrm

    params = dlrm.params_from_jax(unflatten(name, data), "cpu")
    if config(name).dtype != "bfloat16":
        return params

    def bf16(t):
        return t.view(torch.bfloat16)

    return {"tables": bf16(params["tables"]),
            "bot": [{k: bf16(v) for k, v in lp.items()}
                    for lp in params["bot"]],
            "top": [{k: bf16(v) for k, v in lp.items()}
                    for lp in params["top"]]}


def key(name, rows, wire, ex, pipe, bound, mb):
    return f"{name}/c{rows}/{wire}/{ex}/{pipe}/b{bound}m{mb}"


def grid(name, cfg, params, data, out):
    from repro_torch.models import dlrm
    from repro_torch.serving import hot_cache

    dense, idx, mask = (torch.from_numpy(data[f"{name}/{k}"])
                        for k in ("dense", "idx", "mask"))
    for rows in data[f"{name}/cache_rows"]:
        cache = hot_cache.build_from_batch(params["tables"], idx, mask,
                                           int(rows))
        for wire, ex, pipe, (bound, mb) in itertools.product(
                CODECS, EXCHANGES, PIPES, SCHEDULES):
            logits, diag = dlrm.forward_distributed(
                params, cfg, dense, idx, mask, bound=bound,
                microbatches=mb, cache=cache, wire_dtype=wire, exchange=ex,
                exchange_pipeline=pipe, return_diag=True)
            k = key(name, int(rows), wire, ex, pipe, bound, mb)
            out[f"{k}/logits"] = logits.numpy()
            out[f"{k}/diag"] = np.array([int(diag.live_max),
                                         int(diag.drops)])
            out[f"{k}/exchange"] = np.array(diag.exchange)
    # a cap below the live tail: the drops are counted, never hidden
    cap = int(data[f"{name}/tight_cap"])
    _, diag = dlrm.forward_distributed(
        params, cfg, dense, idx, mask, bound=2, microbatches=4,
        cache=hot_cache.build_from_batch(params["tables"], idx, mask,
                                         int(data[f"{name}/cache_rows"][1])),
        exchange="ragged", ragged_cap=cap, exchange_pipeline="ring",
        return_diag=True)
    out[f"{name}/tight"] = np.array([int(diag.live_max), int(diag.drops),
                                     diag.cap])


def engine_runs(params, data, out):
    """Mirror of the reference's autotuner run: a dense and an 'auto'
    engine, each with a calibrated 16-row cache and a bf16 wire."""
    from repro_torch.serving.engine import DLRMEngine

    cfg = config("smoke")
    steps = data["engine/idx"].shape[0]
    bsz = data["engine/idx"].shape[1]
    for ex in ("dense", "auto"):
        eng = DLRMEngine(params, cfg, batch_size=bsz, bound=2,
                         microbatches=2, wire_dtype="bfloat16", exchange=ex,
                         retune_every=2, device="cpu")
        eng.calibrate_cache(data["engine/calib_idx"],
                            data["engine/calib_mask"], 16)
        got = []
        for step in range(steps):
            for i in range(bsz):
                r = eng.submit(*(data[f"engine/{k}"][step, i]
                                 for k in ("dense", "idx", "mask")))
                if r is not None:
                    got.append(r)
        out[f"engine/{ex}/ctr"] = np.concatenate(got)
        _, _, _, dense_rows = eng._exchange_geometry()
        out[f"engine/{ex}/state"] = np.array([
            eng.stats.retunes, eng.ragged_cap, dense_rows,
            eng.cap_tuner.total_drops, eng.slot_bytes()])


def main(rank, world, d):
    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    out = {}
    try:
        with torch.no_grad():
            for name in data["configs"]:
                name = str(name)
                grid(name, config(name), port_params(name, data), data,
                     out)
            if "engine/idx" in data:
                engine_runs(port_params("smoke", data), data, out)
    finally:
        mesh.destroy_model_group()
    np.savez(d / f"out_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
