"""One member of the port's multi-member runs of stream plans and chaos
(gloo).

    python tests/_torch_chaos_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz``: ``task`` ('plans' or 'faults'), the reference
parameters of each config (flattened by ``_torch_dist_worker.flatten``)
and its batches.  Joins a gloo group through ``file://<dir>/store`` and
writes ``<dir>/out_<rank>.npz``:

- 'plans': ``forward_distributed`` logits with and without
  ``build_forward_plans``' plans at (bound, microbatches) (0, 1) and
  (2, 4), with and without a cache, this member's plan leaves, whether a
  plan with the ragged exchange raised and which builds gave None, and
  the CTR streams of an inline and a ``plan_pipeline`` engine;
- 'faults': the degraded forward's logits and ``approx_rows`` per
  exchange, pipeline and fallback; the CTR streams of engines without and
  with a transient fault plan; an explicitly degraded engine's ledger; a
  deadline engine's response to a sustained straggler; last (it retires
  member 1), an engine that a planned crash makes evict and replay.

Imports only the port (``src`` on PYTHONPATH).
"""
import sys
from pathlib import Path

import numpy as np
import torch

from _torch_dist_worker import unflatten

PLAN_SCHEDULES = ((0, 1), (2, 4))
EXCHANGES = ("dense", "ragged")
PIPES = ("mono", "ring")
FALLBACKS = ("zero", "mean")


def config(name):
    from repro_torch.configs.base import DLRMConfig

    if name == "plans":
        return DLRMConfig(name="t", table_sizes=(100, 50, 80, 60, 90, 40),
                          embed_dim=16, bottom_mlp=(32, 16),
                          top_mlp=(32, 1), max_hot=4,
                          sparse_backend="interpret", row_block=32,
                          exchange="dense")
    return DLRMConfig(name="t", table_sizes=(40, 60, 30, 50, 20, 70),
                      embed_dim=8, n_dense_features=4, bottom_mlp=(16, 8),
                      top_mlp=(16, 1), sparse_backend="ref")


def serve(eng, batches, data, before=None):
    """Submit every request of ``batches`` (keys under ``data``); returns
    the concatenated CTRs, the drained tail included."""
    got = []
    for b in batches:
        dense, idx, mask = (data[f"{b}/{k}"] for k in ("dense", "idx",
                                                         "mask"))
        for r in range(dense.shape[0]):
            if before is not None:
                before(eng, b, r)
            o = eng.submit(dense[r], idx[r], mask[r])
            if o is not None:
                got.append(o)
    tail = eng.drain()
    if tail is not None:
        got.append(tail)
    return np.concatenate(got) if got else np.zeros(0, np.float32)


def plans(data, out):
    from repro_torch.models import dlrm
    from repro_torch.serving import hot_cache
    from repro_torch.serving.engine import DLRMEngine

    cfg = config("plans")
    params = dlrm.params_from_jax(unflatten("plans", data), "cpu")
    dense, idx, mask = (torch.from_numpy(data[f"fwd/{k}"])
                        for k in ("dense", "idx", "mask"))
    cache = hot_cache.build_from_batch(params["tables"], idx, mask, 40)
    for bound, mb in PLAN_SCHEDULES:
        for c, cname in ((None, "nocache"), (cache, "cache")):
            k = f"b{bound}m{mb}/{cname}"
            plan = dlrm.build_forward_plans(params, cfg, idx,
                                            microbatches=mb, cache=c)
            kw = dict(bound=bound, microbatches=mb, cache=c)
            out[f"{k}/inline"] = dlrm.forward_distributed(
                params, cfg, dense, idx, mask, **kw).numpy()
            out[f"{k}/planned"] = dlrm.forward_distributed(
                params, cfg, dense, idx, mask, plan=plan, **kw).numpy()
            for leaf in plan._fields[:8]:
                out[f"{k}/plan/{leaf}"] = getattr(plan, leaf).numpy()
            out[f"{k}/plan/geometry"] = np.array([plan.rb, plan.total_rows])
    try:
        dlrm.forward_distributed(params, cfg, dense, idx, mask, cache=cache,
                                 exchange="ragged", plan=plan)
        out["ragged_raised"] = np.array(False)
    except ValueError:
        out["ragged_raised"] = np.array(True)
    out["none_builds"] = np.array([
        dlrm.build_forward_plans(params, cfg, idx, cache=cache,
                                 exchange="ragged") is None,
        dlrm.build_forward_plans(params, cfg.replace(sparse_backend="ref"),
                                 idx) is None,
        dlrm.build_forward_plans(params, cfg.replace(row_block=0),
                                 idx) is None])
    steps = [f"step{s}" for s in range(4)]
    for name, pp in (("inline", False), ("pipelined", True)):
        eng = DLRMEngine(params, cfg, batch_size=32, bound=2,
                         microbatches=2, plan_pipeline=pp, device="cpu")

        def stage(e, b, r):
            # before batch step1's first request, stage its plans
            if pp and b == "step1" and r == 0:
                e.stage_plan(list(data["step1/idx"]))

        out[f"engine/{name}"] = serve(eng, steps, data, stage)
        out[f"engine/{name}/stats"] = np.array([eng.stats.batches,
                                                eng.plan_stage_hits])


def faults(data, out):
    from repro_torch.models import dlrm
    from repro_torch.runtime.elastic import Evicted
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.serving import hot_cache
    from repro_torch.serving.engine import DLRMEngine

    cfg = config("faults")
    world = int(data["world"])
    params = dlrm.params_from_jax(unflatten("faults", data), "cpu")

    # the degraded forward against the host oracle
    dense, idx, mask = (torch.from_numpy(data[f"deg/{k}"])
                        for k in ("dense", "idx", "mask"))
    cache = hot_cache.build_from_batch(params["tables"], idx, mask, 8)
    for ex in EXCHANGES:
        for pipe in PIPES:
            for fb in FALLBACKS:
                lg, dg = dlrm.forward_distributed(
                    params, cfg, dense, idx, mask, bound=1, microbatches=2,
                    cache=cache, exchange=ex, ragged_cap=0,
                    exchange_pipeline=pipe, degraded_members=(1,),
                    degraded_fallback=fb, return_diag=True)
                out[f"deg/{ex}/{pipe}/{fb}"] = lg.numpy()
                out[f"deg/{ex}/{pipe}/{fb}/approx"] = np.array(
                    int(dg.approx_rows))
    for pipe in PIPES:
        lg, dg = dlrm.forward_distributed(
            params, cfg, dense, idx, mask, exchange="dense",
            exchange_pipeline=pipe, degraded_members=(2,),
            degraded_fallback="zero", return_diag=True)
        out[f"deg/nocache/{pipe}"] = lg.numpy()
        out[f"deg/nocache/{pipe}/approx"] = np.array(int(dg.approx_rows))
    try:
        dlrm.forward_distributed(params, cfg, dense, idx, mask,
                                 degraded_members=(1,),
                                 degraded_fallback="mean")
        out["deg/mean_nocache_raised"] = np.array(False)
    except ValueError:
        out["deg/mean_nocache_raised"] = np.array(True)

    # gate (a): a transient plan leaves the CTRs bit-identical
    plan = FaultPlan.none(world, 8).with_spike(2, 1, 0.002)
    steps = [f"transient/step{s}" for s in range(3)]
    for tag, faulty in (("clean", False), ("chaos", True)):
        outs = []
        for ex in EXCHANGES:
            for pipe in PIPES:
                eng = DLRMEngine(params, cfg, batch_size=32, bound=2,
                                 microbatches=4, exchange=ex,
                                 exchange_pipeline=pipe, deadline_s=30.0,
                                 faults=FaultInjector(plan) if faulty
                                 else None, device="cpu")
                outs.append(serve(eng, steps, data))
        out[f"transient/{tag}"] = np.concatenate(outs)

    # gate (b): an explicit degrade ledgers exactly
    calib = (data["explicit/step0/idx"], data["explicit/step0/mask"])
    eng = DLRMEngine(params, cfg, batch_size=32, bound=1, microbatches=2,
                     exchange="dense", degraded_fallback="mean",
                     device="cpu")
    eng.calibrate_cache(*calib, 8)
    eng.degrade((1,))
    serve(eng, [f"explicit/step{s}" for s in range(3)], data)
    out["explicit/stats"] = np.array([eng.stats.degraded_batches,
                                      eng.stats.approx_rows])

    # the deadline policy degrades a sustained straggler
    inj = FaultInjector(FaultPlan.none(world, 16).with_straggler(1, 0.5))
    eng = DLRMEngine(params, cfg, batch_size=32, bound=1, microbatches=2,
                     exchange="dense", faults=inj, deadline_s=0.1,
                     on_deadline="degrade", confirm_after=1,
                     degraded_fallback="zero", device="cpu")
    serve(eng, [f"straggler/step{s}" for s in range(10)], data)
    out["straggler/stats"] = np.array([
        eng.stats.deadline_breaches, eng.stats.degraded_batches,
        eng.stats.approx_rows])
    out["straggler/degraded"] = np.array(eng.degraded_members)
    out["straggler/host_delay"] = np.array(
        inj.host_delay(9, exclude=eng.degraded_members))

    # gate (c), last: a crash of member 1 at flush 2 evicts and replays
    eng = DLRMEngine(params, cfg, batch_size=48, bound=1, microbatches=2,
                     exchange="dense",
                     faults=FaultInjector(FaultPlan.none(world, 8)
                                          .with_crash(1, at_step=2)),
                     deadline_s=30.0, on_deadline="evict",
                     retry_backoff_s=0.001, device="cpu")
    got = []
    try:
        for s in range(4):
            b = f"crash/step{s}"
            for r in range(48):
                o = eng.submit(data[f"{b}/dense"][r], data[f"{b}/idx"][r],
                               data[f"{b}/mask"][r])
                if o is not None:
                    got.append(o)
        out["crash/evicted"] = np.array(False)
    except Evicted:
        out["crash/evicted"] = np.array(True)
    out["crash/ctr"] = np.concatenate(got)
    out["crash/state"] = np.array([
        eng.stats.evictions, eng.stats.replays,
        int(eng.stats.recovery_s > 0), eng._exchange_geometry()[0],
        eng.params["tables"].shape[0]])


def main(rank, world, d):
    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    out = {}
    try:
        with torch.no_grad():
            {"plans": plans, "faults": faults}[str(data["task"])](data, out)
    finally:
        mesh.destroy_model_group()
    np.savez(d / f"out_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
