"""One member of the port's multi-member runs of placement, online
resharding and integrity scrubbing (gloo).

    python tests/_torch_resilience_worker.py <rank> <world_size> <dir>

Reads ``<dir>/inputs.npz``: ``task`` ('riders', 'reshard' or 'scrub'),
the reference's parameters (flattened by ``_torch_dist_worker.flatten``)
and the task's inputs; joins a gloo group through ``file://<dir>/store``
and writes ``<dir>/out_<rank>.npz``:

- 'riders': ``forward_distributed`` with each rider (``migration``,
  ``repair``, ``table_inv``, ``quarantine``, ``wire_check`` with and
  without a ``wire_flip``): logits, the harvested leaves and the wire
  flags, and the calls of each collective with every rider and without;
- 'reshard': the reference's ``tests/test_reshard.py`` engine gates: a
  rebalance cutover beside a static engine, a hand-started reshard across
  pipeline x codec, the migration crash grid, deltas across a cutover;
- 'scrub': the reference's ``tests/test_scrub.py`` engine gates: the
  clean path, the bit-flip grid, a wire corruption, a persistent one
  (degrade, then evict), the mirror off, a repair against a fresher
  delta, a cached copy after repair, and survival of an eviction; then a
  flip in ONE process's copy (the serving member's, another's) beside an
  engine that never saw it.  A fault plan's flip lands in the named
  member's copy only.

A member that an eviction drops records ``<scenario>/evicted`` and joins
the next scenario on the default group.  Imports only the port (``src``
on PYTHONPATH).
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
PIPES = ("mono", "ring")
COLLECTIVES = ("all_to_all_single", "batch_isend_irecv", "all_gather",
               "all_reduce")
RESHARD_CELLS = (("ship", "mono", 0, 0), ("bank", "ring", 1, 0),
                 ("verify", "mono", 0, 1), ("install", "ring", 1, 1),
                 ("commit", "mono", 0, 0))
MID_CELLS = (("mono", "float32"), ("ring", "float32"),
             ("mono", "bfloat16"), ("ring", "bfloat16"))
FLIP_CELLS = tuple(itertools.product(PIPES, ("float32", "bfloat16"),
                                     ("table", "cache")))
N_VER = 6


def cfg(max_hot=None):
    from repro_torch.configs.base import DLRMConfig
    kw = dict(P_CFG)
    if max_hot is not None:
        kw["max_hot"] = max_hot
    return DLRMConfig("t", **kw)


class Counted:
    """Counts the calls of each collective while the block runs."""

    def __enter__(self):
        self.n = dict.fromkeys(COLLECTIVES, 0)
        self.orig = {k: getattr(dist, k) for k in COLLECTIVES}

        def counted(name):
            def call(*a, **kw):
                self.n[name] += 1
                return self.orig[name](*a, **kw)
            return call

        for k in COLLECTIVES:
            setattr(dist, k, counted(k))
        return self

    def __exit__(self, *exc):
        for k, f in self.orig.items():
            setattr(dist, k, f)

    def counts(self):
        return np.array([self.n[k] for k in COLLECTIVES])


def tensors(data, prefix, keys):
    return {k: torch.from_numpy(data[f"{prefix}/{k}"]) for k in keys}


# ---------------------------------------------------------------------------
# 'riders': the forward with each rider
# ---------------------------------------------------------------------------


def audit_words(rank):
    """The audit words member ``rank`` puts on the all-gather."""
    return torch.arange(7, dtype=torch.int32) * 3 - 100 * rank


def riders(data, out):
    from repro_torch.models import dlrm

    c = cfg()
    params = dlrm.params_from_jax(unflatten("p", data), "cpu")
    d, i, m = (torch.from_numpy(data[k]) for k in ("dense", "idx", "mask"))
    mig = tensors(data, "mig", ("mcnt", "mdst", "mepoch", "mgid"))
    rep = tensors(data, "rep", ("rcnt", "rcs", "rgid", "rvec"))
    perm = torch.from_numpy(data["perm"].astype(np.int64))
    inv = data["inv"]
    quar = data["quar"]
    p = dist.get_world_size()
    kw = dict(bound=1, microbatches=2, exchange="dense", return_diag=True)
    for pipe in PIPES:
        tag = pipe
        with Counted() as plain:
            lg, _ = dlrm.forward_distributed(params, c, d, i, m,
                                             exchange_pipeline=pipe, **kw)
        out[f"{tag}/plain/logits"] = lg.numpy()
        out[f"{tag}/plain/counts"] = plain.counts()
        # every rider at once, a flip-free hook: the logits must not move
        with Counted() as armed:
            lg, dg = dlrm.forward_distributed(
                params, c, d, i, m, exchange_pipeline=pipe, migration=mig,
                repair=rep, wire_check=True,
                wire_flip=np.zeros((p, p), np.uint8),
                audit_words=audit_words(dist.get_rank()), **kw)
        out[f"{tag}/armed/logits"] = lg.numpy()
        out[f"{tag}/armed/counts"] = armed.counts()
        out[f"{tag}/armed/audit"] = dg.audit.numpy()
        for k, v in dg.staged_mig.items():
            out[f"{tag}/xmig/{k}"] = v.numpy()
        for k, v in dg.staged_rep.items():
            out[f"{tag}/xrep/{k}"] = v.numpy()
        out[f"{tag}/armed/wbad"] = dg.wbad.numpy()
        # a placement: physical columns and stack in perm order
        pp = dict(params, tables=params["tables"][perm])
        with Counted() as placed:
            lg, dg = dlrm.forward_distributed(
                pp, c, d, i[:, perm], m[:, perm], exchange_pipeline=pipe,
                table_inv=inv, migration=mig, **kw)
        out[f"{tag}/placed/logits"] = lg.numpy()
        out[f"{tag}/placed/counts"] = placed.counts()
        for k, v in dg.staged_mig.items():
            out[f"{tag}/placed_xmig/{k}"] = v.numpy()
        # quarantined rows leave their bags
        lg = dlrm.forward_distributed(params, c, d, i, m,
                                      exchange_pipeline=pipe,
                                      quarantine=quar, **kw)[0]
        out[f"{tag}/quar/logits"] = lg.numpy()
        # one corrupt segment, source 1 -> destination 0
        flip = np.zeros((p, p), np.uint8)
        flip[1, 0] = 1
        lg, dg = dlrm.forward_distributed(
            params, c, d, i, m, exchange_pipeline=pipe, wire_check=True,
            wire_flip=flip, **kw)
        out[f"{tag}/flip/logits"] = lg.numpy()
        out[f"{tag}/flip/wbad"] = dg.wbad.numpy()
        # the ragged exchange: the corrupt source's counts are zeroed too
        lg, dg = dlrm.forward_distributed(
            params, c, d, i, m, exchange_pipeline=pipe, wire_check=True,
            wire_flip=flip, **dict(kw, exchange="ragged"))
        out[f"{tag}/flip_ragged/logits"] = lg.numpy()
        out[f"{tag}/flip_ragged/wbad"] = dg.wbad.numpy()


# ---------------------------------------------------------------------------
# shared engine scaffolding
# ---------------------------------------------------------------------------


class Serve:
    def __init__(self, data, max_hot=None):
        from repro_torch.models import dlrm
        self.cfg = cfg(max_hot)
        self.base = dlrm.params_from_jax(unflatten("p", data), "cpu")
        self.data = data

    def params(self):
        # flips and repairs write the stack in place: a copy per engine
        return dict(self.base, tables=self.base["tables"].clone())

    def engine(self, **kw):
        from repro_torch.serving.engine import DLRMEngine
        kw.setdefault("bound", 1)
        kw.setdefault("microbatches", 2)
        return DLRMEngine(self.params(), self.cfg, batch_size=B,
                          retry_backoff_s=0.0, device="cpu", **kw)

    def real_rows_equal(self, a, b):
        return all(torch.equal(a[t, :n], b[t, :n])
                   for t, n in enumerate(P_CFG["table_sizes"]))


def canon_tables(eng):
    inv = torch.from_numpy(eng.pmap.inv_array().astype(np.int64))
    return eng.params["tables"][inv]


def drift(c, step, phase=0, seed=3):
    from repro_torch.data import synthetic as S
    b = S.make_batch(c, B, mode="drift", seed=seed, step=step, phase=phase)
    return b.dense, b.idx, b.mask


def submit(eng, batch, outs):
    d, i, m = batch
    for r in range(B):
        o = eng.submit(d[r], i[r], m[r])
        if o is not None:
            outs.append(o)


def stats_of(eng):
    st = eng.stats
    return np.array([st.reshards, st.reshard_aborts, st.migrated_rows,
                     st.evictions, st.replays, st.requests,
                     eng.layout_version, eng._exchange_geometry()[0],
                     st.blocks_scrubbed, st.detections, st.repaired_rows,
                     st.quarantined_served, st.wire_rejects,
                     st.detection_lag_flushes], np.int64)


STATS = ("reshards", "reshard_aborts", "migrated_rows", "evictions",
         "replays", "requests", "layout_version", "members",
         "blocks_scrubbed", "detections", "repaired_rows",
         "quarantined_served", "wire_rejects", "detection_lag_flushes")


# ---------------------------------------------------------------------------
# 'reshard'
# ---------------------------------------------------------------------------


def reshard(data, out):
    from repro_torch.runtime import placement as plc
    from repro_torch.runtime.elastic import Evicted
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.runtime.freshness import FreshnessManager, oracle_tables
    from repro_torch.data import synthetic as S

    sv = Serve(data, max_hot=4)
    c = sv.cfg
    p = dist.get_world_size()

    # 1. the rebalance policy fires, ships and cuts over, bit-exact
    eng = sv.engine(rebalance=True, rebalance_threshold=1.05,
                    rebalance_patience=2, mig_slice_cap=4)
    ref = sv.engine()
    outs, refs = [], []
    for s in range(30):
        b = drift(c, s)
        submit(eng, b, outs)
        submit(ref, b, refs)
    out["cut/ctr"] = np.concatenate(outs)
    out["cut/ref"] = np.concatenate(refs)
    out["cut/stats"] = stats_of(eng)
    out["cut/identity"] = np.array(eng.pmap.is_identity)
    out["cut/rows_equal"] = np.array(sv.real_rows_equal(
        canon_tables(eng), ref.params["tables"]))
    out["cut/imb_streak"] = np.array(eng._imb_streak)
    d = eng.stats.to_dict()
    out["cut/keys"] = np.array(sorted(d))
    out["cut/member_rows"] = np.array(d["member_rows"])
    out["cut/member_bytes"] = np.array(d["member_bytes"])
    out["cut/imbalance"] = np.array(d["imbalance_ratio"])

    # 2. a hand-started reshard spans many flushes, bit-exact throughout
    for pipe, wire in MID_CELLS:
        tag = f"mid/{pipe}/{wire}"
        eng = sv.engine(exchange="dense", exchange_pipeline=pipe,
                        wire_dtype=wire, rebalance=True,
                        rebalance_threshold=10.0, mig_slice_cap=2)
        ref = sv.engine(exchange="dense", exchange_pipeline=pipe,
                        wire_dtype=wire)
        outs, refs = [], []
        submit(eng, drift(c, 0), outs)
        submit(ref, drift(c, 0), refs)
        t_pad = eng.pmap.t_pad
        loads = np.zeros(t_pad)
        loads[:len(c.table_sizes)] = [50, 1, 40, 1, 30, 1]
        plan = plc.plan_migration(eng.pmap, loads, p,
                                  table_rows=eng._table_rows(t_pad))
        eng.start_reshard(plan)
        mig_flushes = 0
        for s in range(1, 20):
            if eng.reshard is not None and eng.reshard.active:
                mig_flushes += 1
            submit(eng, drift(c, s), outs)
            submit(ref, drift(c, s), refs)
        out[f"{tag}/mig_flushes"] = np.array(mig_flushes)
        out[f"{tag}/stats"] = stats_of(eng)
        out[f"{tag}/exact"] = np.array(np.array_equal(
            np.concatenate(outs), np.concatenate(refs)))
        out[f"{tag}/ctr"] = np.concatenate(outs)
        out[f"{tag}/rows_equal"] = np.array(sv.real_rows_equal(
            canon_tables(eng), ref.params["tables"]))
        out[f"{tag}/plan"] = np.array(plan.new_map.perm)

    # 3. a member killed at every migration stage: evict, replay, no loss
    init_tables = sv.base["tables"]
    for stage, pipe, straggle, burst in RESHARD_CELLS:
        tag = f"crash/{stage}"
        plan = FaultPlan.none(p, 64).with_mig_crash(1, stage, at_step=0)
        if straggle:
            plan = plan.with_straggler(2, 0.001, from_step=2)
        if burst:
            plan = plan.with_update_burst(3, 2, 2.0)
        eng = sv.engine(exchange="dense", exchange_pipeline=pipe,
                        rebalance=True, rebalance_threshold=1.05,
                        rebalance_patience=2, mig_slice_cap=4,
                        faults=FaultInjector(plan, time_scale=0.0))
        outs = []
        try:
            for s in range(30):
                submit(eng, drift(c, s), outs)
        except Evicted:
            out[f"{tag}/evicted"] = np.array(True)
            continue
        out[f"{tag}/evicted"] = np.array(False)
        out[f"{tag}/stats"] = stats_of(eng)
        out[f"{tag}/answered"] = np.array(len(outs) * B)
        out[f"{tag}/rows_equal"] = np.array(sv.real_rows_equal(
            canon_tables(eng), init_tables))
        lm = eng.load_model
        out[f"{tag}/lm_tables"] = np.array(-1 if lm is None
                                           else lm.n_tables)
        out[f"{tag}/ctr"] = np.concatenate(outs)

    # 4. deltas route to the CURRENT owner across the cutover
    fm = FreshnessManager(itertools.islice(
        S.delta_stream(c, rows_per_version=6, seed=3), N_VER),
        k_fresh=2, slice_cap=4, versions_per_flush=1)
    eng = sv.engine(exchange="dense", freshness=fm, rebalance=True,
                    rebalance_threshold=1.05, rebalance_patience=2,
                    mig_slice_cap=4)
    outs = []
    for s in range(30):
        submit(eng, drift(c, s), outs)
    batches = [S.make_delta_batch(c, v, rows_per_version=6, seed=3)
               for v in range(1, N_VER + 1)]
    want = oracle_tables(sv.base["tables"], batches)
    out["fresh/stats"] = stats_of(eng)
    out["fresh/committed"] = np.array(fm.fully_committed)
    out["fresh/rejects"] = np.array([fm.delta_rejects, fm.rollbacks])
    out["fresh/rows_equal"] = np.array(sv.real_rows_equal(
        canon_tables(eng), want))


# ---------------------------------------------------------------------------
# 'scrub'
# ---------------------------------------------------------------------------


def scrub(data, out):
    from repro_torch.runtime.elastic import Evicted
    from repro_torch.runtime.faults import FaultInjector, FaultPlan
    from repro_torch.runtime.freshness import FreshnessManager, oracle_tables
    from repro_torch.data import synthetic as S
    from repro_torch.serving import hot_cache as HC

    sv = Serve(data)
    c = sv.cfg
    p = dist.get_world_size()
    batches = [tuple(data[f"b{s}/{k}"] for k in ("dense", "idx", "mask"))
               for s in range(12)]
    oracle = sv.base["tables"]

    def run(tag, faults=None, n_flushes=14, calibrate=False, **kw):
        kw.setdefault("scrub_budget", 8)
        eng = sv.engine(exchange="dense", faults=faults, **kw)
        outs = []
        try:
            if calibrate:
                b0 = batches[0]
                eng.calibrate_cache(b0[1], b0[2], cache_rows=8)
            for s in range(n_flushes):
                submit(eng, batches[s % len(batches)], outs)
        except Evicted:
            out[f"{tag}/evicted"] = np.array(True)
            return None, None
        out[f"{tag}/evicted"] = np.array(False)
        out[f"{tag}/stats"] = stats_of(eng)
        out[f"{tag}/answered"] = np.array(len(outs))
        out[f"{tag}/finite"] = np.array(all(np.isfinite(o).all()
                                            for o in outs))
        got = eng.params["tables"]
        out[f"{tag}/tables_ok"] = np.array(all(
            torch.equal(oracle[t, :n], got[t, :n])
            for t, n in enumerate(P_CFG["table_sizes"])))
        out[f"{tag}/ctr"] = np.concatenate(outs)
        out[f"{tag}/repaired"] = np.array(eng.scrub.fully_repaired)
        return eng, outs

    # 1. clean: bit-identical to an engine without scrub
    plain = sv.engine(exchange="dense")
    outs0 = []
    for s in range(6):
        submit(plain, batches[s], outs0)
    out["clean/plain"] = np.concatenate(outs0)
    run("clean", n_flushes=6)

    # 2. the bit-flip grid
    pre = HC.build_from_batch(sv.base["tables"], batches[0][1],
                              batches[0][2], 8)
    crow = int(pre.hot_ids[2, 0])
    for pipe, wire, target in FLIP_CELLS:
        tag = f"flip/{pipe}/{wire}/{target}"
        row = 7 if target == "table" else crow
        plan = FaultPlan.none(p, 40).with_bitflip(1, 2, row, 5, when=2,
                                                  target=target)
        eng, _ = run(tag, FaultInjector(plan), exchange_pipeline=pipe,
                     wire_dtype=wire, calibrate=(target == "cache"))
        out[f"{tag}/invalidations"] = np.array(
            eng.scrub.cache_invalidations)
        if target == "cache":
            out[f"{tag}/slot"] = np.array(int(eng.cache.slot_of[2, crow]))

    # 3. a corrupted serving segment, rejected and served on
    for pipe in PIPES:
        plan = (FaultPlan.none(p, 40).with_wire_corruption(2, 0, when=3)
                .with_bitflip(1, 2, 7, 5, when=2))
        run(f"wire/{pipe}", FaultInjector(plan), exchange_pipeline=pipe)

    # 4. one link corrupt every flush: degrade, then evict
    plan = FaultPlan.none(p, 60)
    for s in range(2, 30):
        plan = plan.with_wire_corruption(2, 0, when=s)
    run("persist", FaultInjector(plan), n_flushes=16, confirm_after=2)

    # 5. the mirror off: detect and quarantine, never repair (the flip
    #    lands in the copy of the member serving the row)
    from repro_torch.models.dlrm import padded_tables
    t_loc = padded_tables(c, p) // p
    hot = tuple(int(x) for x in data["hot"])
    plan = FaultPlan.none(p, 40).with_bitflip(hot[0] // t_loc, hot[0],
                                              hot[1], 3, when=2)
    eng, _ = run("mirror_off", FaultInjector(plan), scrub_mirror=False,
                 n_flushes=12)
    out["mirror_off/quarantined"] = np.array(len(eng.scrub.quarantined))
    out["mirror_off/holder"] = np.array(hot[0] // t_loc)

    # 6. a fresher delta beats the repair
    src = itertools.islice(S.delta_stream(c, rows_per_version=6, seed=3), 4)
    dbs = [S.make_delta_batch(c, v, rows_per_version=6, seed=3)
           for v in range(1, 5)]
    tgt = (int(dbs[1].tab[0]), int(dbs[1].row[0]))
    plan = FaultPlan.none(p, 40).with_bitflip(0, tgt[0], tgt[1], 9, when=1)
    fm = FreshnessManager(src, k_fresh=2, slice_cap=4, versions_per_flush=1)
    eng, _ = run("delta", FaultInjector(plan), freshness=fm, n_flushes=16)
    want = oracle_tables(sv.base["tables"], dbs)
    out["delta/committed"] = np.array(fm.fully_committed)
    out["delta/oracle_ok"] = np.array(sv.real_rows_equal(
        eng.params["tables"], want))

    # 7. a repaired base row leaves no stale cached copy
    plan = FaultPlan.none(p, 40).with_bitflip(1, 2, crow, 5, when=2,
                                              target="table")
    eng, _ = run("coherent", FaultInjector(plan), calibrate=True)
    slot = int(eng.cache.slot_of[2, crow])
    out["coherent/slot"] = np.array(slot)
    out["coherent/fresh"] = np.array(slot < 0 or torch.equal(
        eng.cache.hot_rows[2, slot], eng.params["tables"][2, crow]))

    # 8. an eviction while a flip is unrepaired (member 3 leaves)
    plan = (FaultPlan.none(p, 40).with_bitflip(1, 2, 7, 5, when=2)
            .with_crash(3, 4))
    run("evict", FaultInjector(plan))

    # 9. one process's copy corrupted: the copy that serves table 2
    #    (member 2 // t_loc) and one that does not; only the holder's
    #    audit sees it, every member decides from the gathered words
    plain = sv.engine(exchange="dense")
    outs0 = []
    for s in range(14):
        submit(plain, batches[s % len(batches)], outs0)
    out["single/plain"] = np.concatenate(outs0)
    owner = 2 // t_loc
    for case, holder in (("owner", owner), ("other", (owner + 2) % p)):
        plan = FaultPlan.none(p, 40).with_bitflip(holder, 2, 7, 5, when=2)
        run(f"single/{case}", FaultInjector(plan))


def main(rank, world, d):
    from repro_torch.launch import mesh

    torch.set_num_threads(1)
    data = dict(np.load(d / "inputs.npz"))
    mesh.init_model_group("gloo", world, rank, f"file://{d / 'store'}")
    out = {}
    try:
        with torch.no_grad():
            {"riders": riders, "reshard": reshard,
             "scrub": scrub}[str(data["task"])](data, out)
    finally:
        mesh.destroy_model_group()
    np.savez(d / f"out_{rank}.npz", **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
