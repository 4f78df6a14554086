"""One member of the port's multi-member freshness runs (gloo).

    python tests/_torch_fresh_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz`` (the reference's parameters, flattened by
``_torch_dist_worker.flatten``, its 24 powerlaw batches, the oracle stack
of its 6 delta versions, and a delta wire for the collective count), joins
a gloo group through ``file://<dir>/store`` and writes
``<dir>/out_<rank>.npz`` with one entry group per scenario of the
reference's ``tests/test_freshness.py``: the clean stream on the float32,
bf16 and int8 wires, a corrupted delta, the burst x updater-straggler x
crash-mid-apply grid, a crash mid-apply, a degraded member, the hot cache,
stale serving, the collective count with and without deltas, and a
serving frontend over an engine that evicts a crashed member.  A member
that a crash evicts records it and joins the next scenario.  Imports only
the port (``src`` on PYTHONPATH).
"""
import itertools
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from _torch_dist_worker import unflatten

P_CFG = dict(table_sizes=(40, 60, 30, 50, 20, 70), embed_dim=8,
             n_dense_features=4, bottom_mlp=(16, 8), top_mlp=(16, 1),
             sparse_backend="ref")
B = 48                       # divides the geometry before and after evict
N_VER = 6
WIRES = ("float32", "bfloat16", "int8")
PIPES = ("mono", "ring")
COLLECTIVES = ("all_to_all_single", "batch_isend_irecv", "all_gather",
               "all_reduce")
STATE = ("fully_committed", "rows_applied", "delta_rejects", "rollbacks",
         "evictions", "replays", "requests", "answered", "versions_behind",
         "stats_rows_applied", "stats_delta_rejects", "apply_rollbacks",
         "layout_version", "members", "source_blocked", "cache_refreshed",
         "rows_stale_served", "applies")


def cfg():
    from repro_torch.configs.base import DLRMConfig
    return DLRMConfig("t", **P_CFG)


class Run:
    def __init__(self, data):
        from repro_torch.models import dlrm
        self.data = data
        self.base = dlrm.params_from_jax(unflatten("fresh", data), "cpu")
        self.oracle = torch.from_numpy(data["oracle"])
        self.batches = [tuple(data[f"b{s}/{k}"]
                              for k in ("dense", "idx", "mask"))
                        for s in range(24)]

    def params(self):
        # freshness writes the stack in place: every run gets a copy
        return dict(self.base, tables=self.base["tables"].clone())

    def source(self):
        from repro_torch.data import synthetic as S
        return itertools.islice(S.delta_stream(cfg(), rows_per_version=6,
                                               seed=3), N_VER)

    def engine(self, fm, **kw):
        from repro_torch.serving.engine import DLRMEngine
        return DLRMEngine(self.params(), cfg(), batch_size=B, bound=1,
                          microbatches=2, exchange="dense", freshness=fm,
                          retry_backoff_s=0.0, device="cpu", **kw)

    def submit(self, eng, s, outs):
        d, i, m = self.batches[s % len(self.batches)]
        for r in range(B):
            o = eng.submit(d[r], i[r], m[r])
            if o is not None:
                outs.append(o)

    def serve(self, fm, eng, n_flushes, outs, start=0):
        for s in range(start, n_flushes):
            self.submit(eng, s, outs)
            if fm.fully_committed and s >= 4:
                break

    def oracle_ok(self, eng):
        got = eng.params["tables"]
        return all(torch.equal(got[t, :n], self.oracle[t, :n])
                   for t, n in enumerate(P_CFG["table_sizes"]))

    def record(self, out, tag, fm, eng, outs):
        st = eng.stats
        out[f"{tag}/trace"] = np.array(fm.behind_trace, np.int64)
        out[f"{tag}/state"] = np.array([
            fm.fully_committed, fm.rows_applied, fm.delta_rejects,
            fm.rollbacks, st.evictions, st.replays, st.requests,
            len(outs) * B, st.versions_behind, st.rows_applied,
            st.delta_rejects, st.apply_rollbacks, eng.layout_version,
            eng._exchange_geometry()[0], fm.source_blocked,
            fm.cache_refreshed, st.rows_stale_served, fm.applies],
            np.int64)
        out[f"{tag}/oracle_ok"] = np.array(self.oracle_ok(eng))
        out[f"{tag}/finite"] = np.array(
            all(np.isfinite(o).all() for o in outs))
        out[f"{tag}/keys"] = np.array(sorted(st.to_dict()))

    def scenario(self, out, tag, faults=None, n_flushes=16, slice_cap=4,
                 **kw):
        """The reference's ``run_serve``; a member a crash evicts records
        ``evicted`` and stops."""
        from repro_torch.runtime.elastic import Evicted
        from repro_torch.runtime.freshness import FreshnessManager
        fm = FreshnessManager(self.source(), k_fresh=2, slice_cap=slice_cap,
                              versions_per_flush=1)
        eng = self.engine(fm, faults=faults, **kw)
        outs = []
        try:
            self.serve(fm, eng, n_flushes, outs)
        except Evicted:
            out[f"{tag}/evicted"] = np.array(True)
            return fm, eng, None
        out[f"{tag}/evicted"] = np.array(False)
        self.record(out, tag, fm, eng, outs)
        return fm, eng, outs


def stale_on_host(fm, r, idx, mask):
    """The reference's count: numpy ``isin`` over the batch's gids."""
    pend = set().union(*fm._remaining.values()) if fm._remaining else set()
    if not pend:
        return 0
    idx, mask = idx.cpu().numpy(), mask.cpu().numpy()
    t = np.arange(idx.shape[1], dtype=np.int64)[None, :, None]
    hit = np.isin(t * r + idx.astype(np.int64),
                  np.fromiter(pend, np.int64, len(pend))) & (mask > 0)
    return int(hit.any(axis=-1).sum())


def collectives(run, out):
    """Calls of each collective per forward, plain, with the diagnostics
    and with deltas (which return in the diagnostics), mono and ring; the
    logits must not move and the harvest is kept."""
    from repro_torch.models import dlrm
    counts = dict.fromkeys(COLLECTIVES, 0)
    orig = {k: getattr(dist, k) for k in COLLECTIVES}

    def counted(name):
        def call(*a, **kw):
            counts[name] += 1
            return orig[name](*a, **kw)
        return call

    d, i, m = (torch.from_numpy(x) for x in run.batches[0])
    deltas = {k: torch.from_numpy(run.data[f"wire/{k}"])
              for k in ("dcnt", "dcs", "dgid", "dvec", "dver")}
    params = run.params()
    for k in COLLECTIVES:
        setattr(dist, k, counted(k))
    try:
        for pipe in PIPES:
            for tag, dl, diag in (("plain", None, False),
                                  ("diag", None, True),
                                  ("deltas", deltas, True)):
                for k in counts:
                    counts[k] = 0
                res = dlrm.forward_distributed(
                    params, cfg(), d, i, m, bound=1, microbatches=2,
                    exchange="dense", exchange_pipeline=pipe, deltas=dl,
                    return_diag=diag)
                out[f"coll/{pipe}/{tag}/counts"] = np.array(
                    [counts[k] for k in COLLECTIVES])
                logits, dg = res if diag else (res, None)
                out[f"coll/{pipe}/{tag}/logits"] = logits.numpy()
                if dl is not None:
                    for k, v in dg.staged.items():
                        out[f"coll/{pipe}/staged/{k}"] = v.numpy()
                elif diag:
                    assert dg.staged is None
                    out[f"coll/{pipe}/{tag}/live_max"] = \
                        np.asarray(dg.live_max)
    finally:
        for k, f in orig.items():
            setattr(dist, k, f)


def frontend_crash(run, out):
    """A frontend over an engine whose member 1 crashes at flush 2: after
    the eviction ``layout_version`` is 1 and the frontend forgets its
    flush estimate on that flush."""
    from repro_torch.runtime.elastic import Evicted
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.serving.engine import DLRMEngine
    from repro_torch.serving.frontend import ServingFrontend
    eng = DLRMEngine(run.params(), cfg(), batch_size=B, bound=1,
                     microbatches=2, exchange="dense", device="cpu",
                     faults=FaultInjector(FaultPlan.none(4, 8)
                                          .with_crash(1, at_step=2)))
    fe = ServingFrontend(eng, slo_s=30.0, admission="none", shed=False,
                         lookahead=False, init_flush_s=0.01)
    ewma, versions = [], []
    try:
        for s in range(4):
            d, i, m = run.batches[s]
            for r in range(B):
                fe.try_submit(d[r], i[r], m[r])
                if fe.pump():
                    ewma.append(-1.0 if fe._ewma_flush is None
                                else fe._ewma_flush)
                    versions.append(eng.layout_version)
        fe.drain()
    except Evicted:
        out["fe/evicted"] = np.array(True)
        return
    out["fe/evicted"] = np.array(False)
    out["fe/ewma"] = np.array(ewma)
    out["fe/versions"] = np.array(versions)
    st = fe.stats
    out["fe/state"] = np.array([st.admitted, st.completed, st.evictions,
                                st.accounted, eng.layout_version])


def main(rank, world, d):
    from repro_torch.launch import mesh
    from repro_torch.runtime.elastic import NodeFailure
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.runtime.freshness import FreshnessManager

    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    run = Run(data)
    out = {}
    try:
        with torch.no_grad():
            collectives(run, out)
            for wire in WIRES:
                run.scenario(out, f"clean/{wire}", wire_dtype=wire)
            plan = FaultPlan.none(world, 32).with_delta_corruption(
                0, 1, n_rows=2).with_delta_corruption(2, 3, n_rows=1)
            run.scenario(out, "corrupt", FaultInjector(plan, time_scale=0.0),
                         n_flushes=20)
            for burst, straggle, crash in itertools.product([0, 1],
                                                            repeat=3):
                plan = FaultPlan.none(world, 32)
                if burst:
                    plan = plan.with_update_burst(2, 2, 3.0)
                if straggle:
                    plan = plan.with_updater_straggler(1, from_step=3,
                                                       n_steps=3)
                if crash:
                    plan = plan.with_apply_crash(2, at_step=4)
                run.scenario(out, f"grid/{burst}{straggle}{crash}",
                             FaultInjector(plan, time_scale=0.0),
                             n_flushes=20)

            # a crash mid-apply: the tables must be as before the apply
            fm = FreshnessManager(run.source(), k_fresh=2, slice_cap=4)
            snap = {}
            apply = fm.apply

            def guarded(engine, step):
                before = engine.params["tables"].clone()
                try:
                    apply(engine, step)
                except NodeFailure:
                    snap["same"] = torch.equal(engine.params["tables"],
                                               before)
                    raise

            fm.apply = guarded
            from repro_torch.runtime.elastic import Evicted
            eng = run.engine(fm, faults=FaultInjector(
                FaultPlan.none(world, 32).with_apply_crash(1, at_step=3),
                time_scale=0.0))
            outs = []
            try:
                run.serve(fm, eng, 20, outs)
                out["crash/evicted"] = np.array(False)
                run.record(out, "crash", fm, eng, outs)
            except Evicted:
                out["crash/evicted"] = np.array(True)
            out["crash/rollback_identical"] = np.array(snap.get("same",
                                                                False))

            # a degraded member keeps its last-good version
            fm = FreshnessManager(run.source(), k_fresh=2, slice_cap=4)
            eng = run.engine(fm)
            eng.degrade((2,))
            outs = []
            for s in range(6):
                run.submit(eng, s, outs)
            p, t_loc, r = fm._geometry(eng)
            owners = sorted({fm._owner(g, t_loc, r) for _, g in
                             fm._apply_buf})
            out["degraded/held_owners"] = np.array(owners, np.int64)
            out["degraded/held_trace"] = np.array(fm.behind_trace)
            eng.degrade(())
            run.serve(fm, eng, 20, outs, start=6)
            run.record(out, "degraded", fm, eng, outs)

            # cached rows are refreshed with the tables
            fm = FreshnessManager(run.source(), k_fresh=2, slice_cap=4)
            eng = run.engine(fm)
            b0 = run.batches[0]
            eng.calibrate_cache(b0[1], b0[2], cache_rows=16)
            outs = []
            run.serve(fm, eng, 20, outs)
            run.record(out, "cache", fm, eng, outs)
            ids = eng.cache.hot_ids.long()
            rows = eng.params["tables"][
                torch.arange(ids.shape[0])[:, None], ids.clamp(min=0)]
            out["cache/rows_match"] = np.array(bool(
                ((rows == eng.cache.hot_rows).all(-1) | (ids < 0)).all()))

            # stale serving: counted exactly, as the reference counts
            fm = FreshnessManager(run.source(), k_fresh=2, slice_cap=2)
            eng = run.engine(fm)
            both = []
            count = fm.count_stale_served

            def counted(engine, idx, mask):
                n = count(engine, idx, mask)
                both.append((n, stale_on_host(fm, fm._geometry(engine)[2],
                                              idx, mask)))
                return n

            fm.count_stale_served = counted
            outs = []
            run.serve(fm, eng, 20, outs)
            run.record(out, "stale", fm, eng, outs)
            out["stale/per_flush"] = np.array(both, np.int64)

            frontend_crash(run, out)
    finally:
        mesh.destroy_model_group()
    np.savez(d / f"out_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
