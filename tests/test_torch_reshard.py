"""The port's skew-aware placement and online resharding
(``repro_torch/runtime/placement.py``, ``runtime/reshard.py``, the
``migration=`` and ``table_inv=`` riders of ``forward_distributed`` and the
engine's rebalance path) against the JAX reference, on the CPU.

  * the ``placement.py`` copy function by function on seeded inputs: maps,
    the EWMA load model and its ``ready`` gate, LPT with its ties, minimal
    migration plans, ``min_gain``, row splits, the makespan check;
  * both ``ReshardExecutor``s over a stub engine, step by step on the same
    plan and harvests: wire leaves, banking, verification, rejects and
    re-ships, dirty rows, the committed stack, the permuted cache, every
    counter;
  * at P = 1, a hand-built plan through the reference's ``DLRMEngine`` (a
    one-device mesh) and the port's (a one-rank gloo group): the same
    executor state after every flush, the cutover on the same flush, CTRs
    within 1e-5;
  * on 2 and 4 gloo members (``_torch_resilience_worker.py``, task
    'riders'): the harvested ``xmig`` leaves bit for bit against a host
    model stamped with JAX's ``row_checksum_device``, logits under a
    non-identity ``table_inv`` against JAX's ``forward_local`` (rtol = atol
    = 1e-5), and the same collective calls with every rider as without;
  * on 4 gloo members (task 'reshard'), the reference's
    ``tests/test_reshard.py`` engine gates: a rebalance cutover
    bit-identical to a static engine and ledgered, a hand-started reshard
    bit-identical across pipeline x codec, a member killed at every
    ``MIG_STAGES`` stage recovering with no request lost, deltas routed
    across a cutover to the oracle; CTRs within 2e-5 of JAX;
  * the exclusion with ``plan_pipeline`` and the example's ``--rebalance``.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import flatten, run_members
from _torch_resilience_worker import (B, COLLECTIVES, MID_CELLS, P_CFG,
                                      PIPES, RESHARD_CELLS, STATS)
from repro.configs.base import DLRMConfig as JConfig
from repro.core import integrity as jinteg
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro.runtime import placement as jplc
from repro.runtime import reshard as jresh
from repro.serving import engine as jengine
from repro.serving import hot_cache as jhc
from repro.sharding import partition
from repro_torch.configs.base import DLRMConfig
from repro_torch.launch import mesh
from repro_torch.models import dlrm as tdlrm
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import placement as tplc
from repro_torch.runtime import reshard as tresh
from repro_torch.serving import hot_cache as thc
from repro_torch.serving.engine import DLRMEngine

WORKER = Path(__file__).with_name("_torch_resilience_worker.py")
CHAOS_TOL = 2e-5
LOGIT_TOL = {"rtol": 1e-5, "atol": 1e-5}


# ---------------------------------------------------------------------------
# the placement copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("perm", [tuple(range(8)), (3, 1, 0, 2),
                                  (7, 6, 5, 4, 3, 2, 1, 0),
                                  (2, 5, 0, 1, 4, 3)])
def test_partition_map_matches_reference(perm):
    t, j = tplc.PartitionMap(perm), jplc.PartitionMap(perm)
    assert (t.t_pad, t.is_identity) == (j.t_pad, j.is_identity)
    np.testing.assert_array_equal(t.perm_array(), j.perm_array())
    np.testing.assert_array_equal(t.inv_array(), j.inv_array())
    for p in (1, 2):
        np.testing.assert_array_equal(t.owners(p), j.owners(p))
        assert [t.owner_of(x, p) for x in perm] == \
            [j.owner_of(x, p) for x in perm]
    assert tplc.PartitionMap.identity(len(perm)).perm == tuple(range(
        len(perm)))
    for mod in (tplc, jplc):
        with pytest.raises(ValueError):
            mod.PartitionMap((0, 0) + perm[2:])


def test_load_model_matches_reference():
    rng = np.random.default_rng(3)
    for alpha, min_obs in ((0.25, 4), (0.5, 2), (1.0, 1)):
        t = tplc.TableLoadModel(6, alpha=alpha, min_obs=min_obs)
        j = jplc.TableLoadModel(6, alpha=alpha, min_obs=min_obs)
        np.testing.assert_array_equal(t.loads, j.loads)
        for _ in range(6):
            rows = rng.integers(0, 40, 6)
            t.observe(rows, row_bytes=36.0)
            j.observe(rows, row_bytes=36.0)
            assert t.ready == j.ready
            np.testing.assert_array_equal(t.loads, j.loads)
        t.reset()
        assert not t.ready and (t.loads == 0).all()
    for mod in (tplc, jplc):
        with pytest.raises(ValueError):
            mod.TableLoadModel(3, alpha=0.0)
        with pytest.raises(ValueError):
            mod.TableLoadModel(3).observe([1, 2])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("p", [2, 4])
def test_lpt_and_member_loads_match_reference(seed, p):
    rng = np.random.default_rng(seed)
    loads = rng.integers(0, 6, 8).astype(np.float64)     # ties on purpose
    prefer = rng.integers(0, p, 8)
    for kw in ({}, {"prefer": prefer}):
        to, tl = tplc.lpt_assign(loads, p, **kw)
        jo, jl = jplc.lpt_assign(loads, p, **kw)
        np.testing.assert_array_equal(to, jo)
        np.testing.assert_array_equal(tl, jl)
    pm = (tplc.PartitionMap(tuple(rng.permutation(8).tolist())))
    jm = jplc.PartitionMap(pm.perm)
    np.testing.assert_array_equal(tplc.member_loads(loads, pm, p),
                                  jplc.member_loads(loads, jm, p))
    assert tplc.imbalance(tl) == jplc.imbalance(jl)
    assert tplc.imbalance([]) == jplc.imbalance([]) == 1.0
    for mod in (tplc, jplc):
        with pytest.raises(ValueError):
            mod.lpt_assign(np.ones(5), 2)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("min_gain,split", [(0.0, 1.0), (0.5, 1.0),
                                            (0.0, 0.5)])
def test_plan_migration_matches_reference(seed, min_gain, split):
    rng = np.random.default_rng(10 + seed)
    loads = rng.pareto(1.5, 8) * 10
    rows = rng.integers(0, 50, 8)
    perm = tuple(rng.permutation(8).tolist())
    for p in (2, 4):
        t = tplc.plan_migration(tplc.PartitionMap(perm), loads, p,
                                table_rows=rows, min_gain=min_gain,
                                split_threshold=split)
        j = jplc.plan_migration(jplc.PartitionMap(perm), loads, p,
                                table_rows=rows, min_gain=min_gain,
                                split_threshold=split)
        assert t.new_map.perm == j.new_map.perm
        assert (t.moves, t.row_splits) == (j.moves, j.row_splits)
        assert (t.load_before, t.load_after) == (j.load_before,
                                                 j.load_after)
        assert t.summary() == j.summary()
        assert (t.is_noop, t.moved_rows) == (j.is_noop, j.moved_rows)
        if not t.is_noop:
            # keepers keep their slot; only owner changes ship
            moved = {x for x, *_ in t.moves}
            for ti in set(range(8)) - moved:
                cur = tplc.PartitionMap(perm)
                if t.new_map.owner_of(ti, p) == cur.owner_of(ti, p):
                    assert t.new_map.inv_array()[ti] == cur.inv_array()[ti]
    for mod in (tplc, jplc):
        with pytest.raises(ValueError):
            mod.plan_migration(mod.PartitionMap.identity(4), np.ones(3), 2,
                               table_rows=np.ones(4))


@pytest.mark.parametrize("bound", [0, 1, 3])
def test_predicted_makespan_matches_reference(bound):
    for ml in ([4.0, 1, 1, 1], [1.75] * 4, [2.0, 3.0]):
        assert tplc.predicted_makespan(ml, bound=bound, seed=2) == \
            jplc.predicted_makespan(ml, bound=bound, seed=2)
    assert tplc.predicted_makespan([1.75] * 4, bound=1) < \
        tplc.predicted_makespan([4.0, 1, 1, 1], bound=1)


# ---------------------------------------------------------------------------
# both executors over a stub engine
# ---------------------------------------------------------------------------


class StubEngine:
    """What a ``ReshardExecutor`` reads and writes of ``DLRMEngine``."""

    def __init__(self, tables, p, mb, faults=None, cache=None):
        self.params = {"tables": tables}
        self._p = p
        self.microbatches = mb
        self.faults, self.cache = faults, cache
        self._pmap = None
        self._staged_plan = None

    @property
    def pmap(self):
        mod = jplc if isinstance(self.params["tables"], jax.Array) else tplc
        return self._pmap or mod.PartitionMap.identity(
            self.params["tables"].shape[0])

    def _exchange_geometry(self):
        t_pad = self.params["tables"].shape[0]
        return self._p, t_pad, 1, 1

    def _active_mesh(self):
        return None

    def _group(self):
        return None


def mig_route(wire, tables, p, inv, corrupt=()):
    """Host model of the xmig rider: each (member, microbatch) slice's
    rows gathered from the member's shard of the stack under the placement
    ``inv`` (an index outside the shard clamps into it, as the
    reference's gather does), stamped with JAX's device fold (the epoch as
    the version) and delivered to ``mdst`` in slice order; leaves (P_dst,
    mb, P_src, ...).  ``corrupt`` names (src, j, i) rows whose first byte
    flips after the stamp.  ``tables`` is in original order."""
    mb, cap = wire["mgid"].shape[1:]
    r, s = tables.shape[1:]
    t_loc = tables.shape[0] // p
    perm = np.argsort(inv)
    out = {"mvec": np.zeros((p, mb, p, cap, s), np.float32),
           "mgid": np.zeros((p, mb, p, cap), np.int32),
           "mcs": np.zeros((p, mb, p, cap), np.uint32),
           "mcnt": np.zeros((p, mb, p, 1), np.int32),
           "mepoch": np.zeros((p, mb, p, 1), np.int32)}
    for m in range(p):
        for j in range(mb):
            n = int(wire["mcnt"][m, j, 0])
            g = wire["mgid"][m, j, :n].astype(np.int64)
            slot = m * t_loc + np.clip(inv[g // r] - m * t_loc, 0,
                                       t_loc - 1)
            vec = tables[perm[slot], g % r].astype(np.float32)
            ep = int(wire["mepoch"][m, j, 0])
            cs = np.asarray(jinteg.row_checksum_device(
                jnp.asarray(vec), jnp.asarray(g, jnp.int32),
                jnp.int32(ep))) if n else np.zeros(0, np.uint32)
            for i in range(n):
                if (m, j, i) in corrupt:
                    vec[i].view(np.uint8)[0] ^= 1
            dst = wire["mdst"][m, j, :n]
            for q in range(p):
                sel = np.flatnonzero(dst == q)
                out["mcnt"][q, j, m, 0] = len(sel)
                out["mepoch"][q, j, m, 0] = ep
                out["mvec"][q, j, m, :len(sel)] = vec[sel]
                out["mgid"][q, j, m, :len(sel)] = g[sel]
                out["mcs"][q, j, m, :len(sel)] = cs[sel]
    return out


def _executor_state(ex):
    return (ex.state, sorted(ex._queued), sorted(ex._inflight),
            sorted(ex._arriving), sorted(ex._dirty), sorted(ex.banked),
            ex.summary(), ex.complete)


@pytest.mark.parametrize("case", ["clean", "faults", "cache"])
def test_executor_matches_reference_over_stub_engine(case):
    """Step by step, both executors on the same plan and harvests: the
    wire leaves, every state set and counter, the banked rows; a
    corrupted row is rejected and shipped again, a row a delta lands on
    in flight re-ships, a banked one is patched; the committed stack, the
    map and the permuted cache are the reference's bit for bit."""
    p, mb, r, s = 2, 2, 12, 4
    rng = np.random.default_rng(5)
    base = rng.standard_normal((4, r, s)).astype(np.float32)
    plan_kw = dict(
        new_map=(2, 1, 0, 3), row_splits=(), load_before=(3.0, 1.0),
        load_after=(2.0, 2.0),
        moves=((0, 0, 1, 9), (2, 1, 0, 7)))
    jplan = jplc.MigrationPlan(**dict(
        plan_kw, new_map=jplc.PartitionMap(plan_kw["new_map"])))
    tplan = tplc.MigrationPlan(**dict(
        plan_kw, new_map=tplc.PartitionMap(plan_kw["new_map"])))
    jc = tc = None
    if case == "cache":
        counts = rng.integers(0, 5, (4, r)).astype(np.float64)
        jc = jhc.build(jnp.asarray(base), counts, 3)
        tc = thc.build(torch.from_numpy(base.copy()), counts, 3)
    jeng = StubEngine(jnp.asarray(base), p, mb, cache=jc)
    teng = StubEngine(torch.from_numpy(base.copy()), p, mb, cache=tc)
    jx = jresh.ReshardExecutor(jplan, epoch=4, slice_cap=3)
    tx = tresh.ReshardExecutor(tplan, epoch=4, slice_cap=3)
    jx.start(jeng)
    tx.start(teng)
    inv = np.arange(4)
    for step in range(20):
        jw, tw = jx.next_wire(jeng, step), tx.next_wire(teng, step)
        assert list(jw) == list(tw) == list(tresh.MIG_KEYS)
        for k in jw:
            np.testing.assert_array_equal(tw[k], jw[k], err_msg=(step, k))
        corrupt = {(0, 0, 1)} if case == "faults" and step == 1 else ()
        staged = mig_route(jw, base, p, inv, corrupt)
        if case == "faults" and step == 3:
            staged["mepoch"][:] = 9      # a dead reshard's stragglers
        jx.ingest({k: jnp.asarray(v) for k, v in staged.items()}, jeng,
                  step)
        tx.ingest({k: torch.from_numpy(v.copy()) for k, v in
                   staged.items()}, teng, step)
        if case == "faults" and step in (2, 4):
            # a delta lands on an in-flight row and on a banked one
            for ex in (jx, tx):
                for g in (sorted(ex._arriving)[:1]
                          + sorted(ex.banked)[:1]):
                    ex.note_applied(g, np.full(s, 7.0, np.float32),
                                    np.dtype(np.float32))
            g = (sorted(tx.banked)[:1] or [None])[0]
            if g is not None:
                base[g // r, g % r] = 7.0
        assert _executor_state(tx) == _executor_state(jx), step
        for g, v in jx.banked.items():
            np.testing.assert_array_equal(tx.banked[g], v)
        jdone = jx.try_commit(jeng, step)
        tdone = tx.try_commit(teng, step)
        assert jdone == tdone, step
        if tdone:
            break
    assert tx.state == "committed"
    if case == "faults":
        assert tx.rejects >= 1 and tx.reships >= 2
    assert teng.pmap.perm == jeng.pmap.perm == plan_kw["new_map"]
    np.testing.assert_array_equal(teng.params["tables"].numpy(),
                                  np.asarray(jeng.params["tables"]))
    if case == "cache":
        for f in ("hot_ids", "hot_rows", "slot_of"):
            np.testing.assert_array_equal(
                getattr(teng.cache, f).numpy(),
                np.asarray(getattr(jeng.cache, f)))
    with pytest.raises(ValueError):
        tresh.ReshardExecutor(dataclasses.replace(tplan, moves=()),
                              epoch=1)
    with pytest.raises(ValueError):
        tresh.ReshardExecutor(tplan, epoch=1, slice_cap=0)


@pytest.mark.parametrize("stage", ["ship", "bank", "verify", "install",
                                   "commit"])
def test_migration_crash_points_match_reference(stage):
    """A member killed at each named migration step raises at the same
    call of the same flush in both executors; before the commit's first
    swap nothing published has changed."""
    p, mb, r, s = 2, 1, 6, 2
    base = np.arange(4 * r * s, dtype=np.float32).reshape(4, r, s)
    fails = []
    for pl, rs, fa, arr in ((jplc, jresh, jfaults, jnp.asarray),
                            (tplc, tresh, tfaults, torch.from_numpy)):
        plan = pl.MigrationPlan(pl.PartitionMap((2, 1, 0, 3)),
                                ((0, 0, 1, 4), (2, 1, 0, 4)), (),
                                (1.0,), (1.0,))
        inj = fa.FaultInjector(fa.FaultPlan.none(p, 8).with_mig_crash(
            1, stage, at_step=1), time_scale=0.0)
        eng = StubEngine(arr(base.copy()), p, mb, faults=inj)
        ex = rs.ReshardExecutor(plan, epoch=1, slice_cap=2)
        ex.start(eng)
        where = None
        for step in range(6):
            try:
                w = ex.next_wire(eng, step)
                staged = mig_route(w, base, p, np.arange(4))
                ex.ingest({k: arr(v.copy()) for k, v in staged.items()},
                          eng, step)
                if ex.try_commit(eng, step):
                    break
            except (jfaults.NodeFailure, tfaults.NodeFailure):
                where = (step, ex.state, eng._pmap is None,
                         eng.cache is None)
                break
        fails.append((where, ex.summary()))
    assert fails[0] == fails[1]
    assert fails[1][0] is not None


# ---------------------------------------------------------------------------
# P = 1: a hand-built plan through both engines
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    mesh.init_model_group("gloo", 1, 0, f"file://{tmp_path / 'store'}")
    try:
        yield
    finally:
        mesh.destroy_model_group()


def test_hand_built_plan_at_one_member_matches_reference(one_rank):
    """P = 1 never plans a move (``maybe_rebalance`` returns None below 2
    members), so a plan reversing the slots with moves ``(t, 0, 0,
    rows)`` is started by hand, as the card's phase 5e does: both
    engines hold the same executor state after every flush, cut over on
    the same flush (``reshards`` 1, every real row migrated,
    ``layout_version`` 1, the map reversed) and serve CTRs within 1e-5 of
    each other, the port's bit-identical to a static engine."""
    kw = dict(P_CFG, max_hot=4)
    jcfg, tcfg = JConfig("t", **kw), DLRMConfig("t", **kw)
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=1)
    tp = tdlrm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ekw = dict(batch_size=B, bound=1, microbatches=2, mig_slice_cap=8,
               rebalance=True)
    jeng = jengine.DLRMEngine(dict(jp), jcfg, **ekw)
    teng = DLRMEngine(dict(tp), tcfg, device="cpu", **ekw)
    static = DLRMEngine(dict(tp), tcfg, device="cpu", batch_size=B,
                        bound=1, microbatches=2)
    perm = (5, 4, 3, 2, 1, 0)
    moves = tuple((t, 0, 0, n) for t, n in enumerate(kw["table_sizes"]))
    jmesh = jelastic.make_mesh_from(jax.devices()[:1], model=1)
    outs = {"j": [], "t": [], "s": []}
    cut = None
    with partition.axis_rules(jmesh):
        for step in range(24):
            if step == 1:
                for eng, mod in ((jeng, jplc), (teng, tplc)):
                    assert eng.maybe_rebalance(force=True) is None
                    eng.start_reshard(mod.MigrationPlan(
                        mod.PartitionMap(perm), moves, (), (1.0,),
                        (1.0,)))
            b = jsyn.make_batch(jcfg, B, mode="drift", seed=3, step=step)
            for r in range(B):
                for key, eng in (("j", jeng), ("t", teng), ("s", static)):
                    o = eng.submit(b.dense[r], b.idx[r], b.mask[r])
                    if o is not None:
                        outs[key].append(np.asarray(o))
            js = None if jeng.reshard is None else jeng.reshard.summary()
            ts = None if teng.reshard is None else teng.reshard.summary()
            assert ts == js, step
            if cut is None and teng.stats.reshards:
                cut = step
    assert cut is not None and 1 < cut < 23
    for eng in (jeng, teng):
        assert (eng.stats.reshards, eng.stats.migrated_rows,
                eng.layout_version, eng.pmap.perm) == \
            (1, sum(kw["table_sizes"]), 1, perm)
    got = np.concatenate(outs["t"])
    np.testing.assert_allclose(got, np.concatenate(outs["j"]), **LOGIT_TOL)
    np.testing.assert_array_equal(got, np.concatenate(outs["s"]))
    # every real row arrived (the padding past a moved table's rows is
    # zero in the new stack, as in the reference's)
    inv = torch.from_numpy(teng.pmap.inv_array().astype(np.int64))
    canon = teng.params["tables"][inv]
    for t, n in enumerate(kw["table_sizes"]):
        assert torch.equal(canon[t, :n], tp["tables"][t, :n]), t
    np.testing.assert_array_equal(teng.params["tables"].numpy(),
                                  np.asarray(jeng.params["tables"]))


# ---------------------------------------------------------------------------
# 2 and 4 gloo members: the forward's riders
# ---------------------------------------------------------------------------


def rider_inputs(p, seed=0):
    """The reference's parameters at ``p`` members, a hetero batch, a
    migration wire whose slices hold rows the member owns, a repair wire,
    a reversed placement and a quarantine vector naming live rows."""
    jcfg = JConfig("t", **P_CFG)
    t_pad = jdlrm.padded_tables(jcfg, p)
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=p)
    inputs = {"task": np.array("riders")}
    flatten("p", params, inputs)
    b = jsyn.make_batch(jcfg, B, mode="hetero", t_pad=t_pad, seed=1)
    inputs.update(dense=b.dense, idx=b.idx, mask=b.mask)
    r = np.asarray(params["tables"]).shape[1]
    t_loc = t_pad // p
    rng = np.random.default_rng(seed)
    cap, s = 4, jcfg.embed_dim
    mgid = np.zeros((p, 2, cap), np.int32)
    mdst = np.zeros((p, 2, cap), np.int32)
    mcnt = np.zeros((p, 2, 1), np.int32)
    for m in range(p):
        for j in range(2):
            mcnt[m, j, 0] = rng.integers(1, cap + 1)
            tabs = rng.integers(m * t_loc, (m + 1) * t_loc, cap)
            mgid[m, j] = tabs * r + rng.integers(0, 20, cap)
            mdst[m, j] = rng.integers(0, p, cap)
    inputs.update({"mig/mgid": mgid, "mig/mdst": mdst, "mig/mcnt": mcnt,
                   "mig/mepoch": np.full((p, 2, 1), 3, np.int32)})
    rvec = rng.standard_normal((p, 2, cap, s)).astype(np.float32)
    rgid = (rng.integers(0, jcfg.n_tables, (p, 2, cap)) * r
            + rng.integers(0, 20, (p, 2, cap))).astype(np.int32)
    inputs.update({"rep/rvec": rvec, "rep/rgid": rgid,
                   "rep/rcnt": rng.integers(1, cap + 1, (p, 2, 1))
                   .astype(np.int32),
                   "rep/rcs": jinteg.row_checksum(rvec, rgid, 0)})
    perm = np.arange(t_pad)[::-1].copy()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(t_pad)
    live = [(t, int(b.idx[k, t, 0])) for k, t in ((0, 1), (5, 3), (9, 0))]
    quar = np.array([t * r + row for t, row in live] + [-1, -1], np.int32)
    inputs.update(perm=perm, inv=inv.astype(np.int32), quar=quar)
    return params, b, inputs


def jax_ctr_logits(params, cfg, dense, idx, mask):
    return np.asarray(jdlrm.forward_local(params, cfg, *map(
        jnp.asarray, (dense, idx, mask))))


@pytest.fixture(scope="module", params=[2, 4])
def riders(request, tmp_path_factory):
    p = request.param
    params, b, inputs = rider_inputs(p)
    outs = run_members(WORKER, p, inputs,
                       tmp_path_factory.mktemp(f"riders{p}"))
    return p, params, b, inputs, outs


@pytest.mark.parametrize("pipe", PIPES)
def test_migration_rider_harvest_and_placement(riders, pipe):
    """Every member's ``xmig`` harvest is the host model's bit for bit
    (rows gathered from the live shard, stamped with JAX's device fold,
    delivered to their future owner), the same under a reversed
    placement; the logits under ``table_inv`` within 1e-5 of JAX's
    ``forward_local`` on the original order; with every rider armed and a
    flip-free hook the logits do not move."""
    p, params, b, inputs, outs = riders
    tables = np.asarray(params["tables"])
    wire = {k.split("/")[1]: v for k, v in inputs.items()
            if k.startswith("mig/")}
    want = {"xmig": mig_route(wire, tables, p, np.arange(tables.shape[0])),
            "placed_xmig": mig_route(wire, tables, p, inputs["inv"])}
    plain = jax_ctr_logits(params, JConfig("t", **P_CFG), b.dense, b.idx,
                           b.mask)
    for out in outs:
        for tag in ("xmig", "placed_xmig"):
            for k, v in want[tag].items():
                got = out[f"{pipe}/{tag}/{k}"]
                assert got.dtype == v.dtype, (tag, k)
                np.testing.assert_array_equal(got, v, err_msg=(tag, k))
        np.testing.assert_allclose(out[f"{pipe}/placed/logits"], plain,
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(out[f"{pipe}/armed/logits"],
                                      out[f"{pipe}/plain/logits"])
        np.testing.assert_allclose(out[f"{pipe}/plain/logits"], plain,
                                   **LOGIT_TOL)


@pytest.mark.parametrize("pipe", PIPES)
def test_migration_and_placement_add_no_collective(riders, pipe):
    """With the ``xmig`` rider and a non-identity placement gather (and
    with every rider armed), the forward makes the same calls of each
    collective as without: one all_to_all_single a microbatch for 'mono',
    P−1 point-to-point rounds for 'ring', one all_gather, no all_reduce."""
    p, _, _, _, outs = riders
    for out in outs:
        plain = out[f"{pipe}/plain/counts"]
        for tag in ("placed", "armed"):
            np.testing.assert_array_equal(out[f"{pipe}/{tag}/counts"],
                                          plain, err_msg=tag)
        n = dict(zip(COLLECTIVES, plain.tolist()))
        assert n == ({"all_to_all_single": 2, "batch_isend_irecv": 0,
                      "all_gather": 1, "all_reduce": 0} if pipe == "mono"
                     else {"all_to_all_single": 0,
                           "batch_isend_irecv": 2 * (p - 1),
                           "all_gather": 1, "all_reduce": 0})


# ---------------------------------------------------------------------------
# 4 gloo members: the reference's engine gates
# ---------------------------------------------------------------------------

P = 4


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    jcfg = JConfig("t", **dict(P_CFG, max_hot=4))
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=P)
    inputs = {"task": np.array("reshard")}
    flatten("p", params, inputs)
    outs = run_members(WORKER, P, inputs, tmp_path_factory.mktemp("resh4"),
                       timeout=600)
    ctr = np.concatenate([
        1 / (1 + np.exp(-jax_ctr_logits(params, jcfg, b.dense, b.idx,
                                         b.mask)))
        for b in (jsyn.make_batch(jcfg, B, mode="drift", seed=3, step=s)
                  for s in range(30))])
    return ctr, outs


def _stats(out, tag):
    return dict(zip(STATS, out[f"{tag}/stats"].tolist()))


def test_rebalance_cutover_stays_bit_exact_and_ledgered(members):
    """Drifting traffic arms the load model, the imbalance trigger starts
    a reshard, rows ship in installments while serving continues, the
    cutover lands: every flush bit-identical to a static engine, within
    2e-5 of JAX, no request lost, real rows preserved, the imbalance
    telemetry in ``to_dict``."""
    want, outs = members
    for out in outs:
        st = _stats(out, "cut")
        assert st["reshards"] >= 1 and st["reshard_aborts"] == 0
        assert st["migrated_rows"] > 0 and st["layout_version"] >= 1
        assert not bool(out["cut/identity"])
        np.testing.assert_array_equal(out["cut/ctr"], out["cut/ref"])
        assert np.abs(out["cut/ctr"] - want).max() < CHAOS_TOL
        assert out["cut/ctr"].size == st["requests"] == 30 * B
        assert bool(out["cut/rows_equal"])
        assert int(out["cut/imb_streak"]) == 0
        keys = set(out["cut/keys"].tolist())
        assert {"reshards", "reshard_aborts", "migrated_rows",
                "imbalance_ratio", "flush_time_ratio", "member_rows",
                "member_bytes"} <= keys
        assert out["cut/member_rows"].shape == (P,)
        assert out["cut/member_bytes"].shape == (P,)
        assert float(out["cut/imbalance"]) >= 1.0
    for out in outs[1:]:
        np.testing.assert_array_equal(out["cut/stats"], outs[0]["cut/stats"])


@pytest.mark.parametrize("pipe,wire", MID_CELLS)
def test_mid_migration_bit_exact_across_pipeline_and_codec(members, pipe,
                                                           wire):
    """A hand-started reshard with a slice cap of 2 spans many flushes;
    every flush, migration rows on the wire and the old owner serving, is
    bit-identical to a static engine (f32 also within 2e-5 of JAX)."""
    want, outs = members
    tag = f"mid/{pipe}/{wire}"
    for out in outs:
        assert int(out[f"{tag}/mig_flushes"]) >= 3
        assert _stats(out, tag)["reshards"] == 1
        assert bool(out[f"{tag}/exact"]) and bool(out[f"{tag}/rows_equal"])
        if wire == "float32":
            assert np.abs(out[f"{tag}/ctr"] - want[:20 * B]).max() < \
                CHAOS_TOL


@pytest.mark.parametrize("stage,pipe,straggle,burst", RESHARD_CELLS)
def test_crash_grid_every_stage_recovers_zero_lost(members, stage, pipe,
                                                   straggle, burst):
    """Member 1 killed at each migration step (with straggler and update
    bursts spread over the cells): the reshard aborts, the survivors
    evict and replay on 3 members with no request lost, real rows intact,
    the load model re-armed for the new geometry, CTRs within 2e-5."""
    want, outs = members
    tag = f"crash/{stage}"
    assert bool(outs[1][f"{tag}/evicted"])
    for m in (0, 2, 3):
        out = outs[m]
        assert not bool(out[f"{tag}/evicted"])
        st = _stats(out, tag)
        assert st["reshard_aborts"] >= 1 and st["evictions"] >= 1
        assert st["replays"] >= 1 and st["members"] == 3
        assert int(out[f"{tag}/answered"]) == st["requests"] == 30 * B
        assert bool(out[f"{tag}/rows_equal"])
        assert int(out[f"{tag}/lm_tables"]) in (
            -1, jdlrm.padded_tables(JConfig("t", **P_CFG), 3))
        assert np.abs(out[f"{tag}/ctr"] - want).max() < CHAOS_TOL
        np.testing.assert_array_equal(out[f"{tag}/stats"],
                                      outs[0][f"{tag}/stats"])


def test_freshness_deltas_route_across_cutover(members):
    _, outs = members
    for out in outs:
        assert _stats(out, "fresh")["reshards"] >= 1
        assert bool(out["fresh/committed"])
        assert out["fresh/rejects"].tolist() == [0, 0]
        assert bool(out["fresh/rows_equal"])


def test_rebalance_is_exclusive_with_plan_pipeline():
    cfg = DLRMConfig("t", **P_CFG)
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), JConfig("t", **P_CFG),
                         n_shards=1)
    tp = tdlrm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    with pytest.raises(ValueError, match="rebalance"):
        DLRMEngine(tp, cfg, batch_size=8, rebalance=True,
                   plan_pipeline=True, device="cpu")
    eng = DLRMEngine(tp, cfg, batch_size=8, device="cpu")
    eng.plan_pipeline = True
    plan = tplc.MigrationPlan(tplc.PartitionMap((1, 0, 2, 3, 4, 5)),
                              ((0, 0, 0, 1),), (), (1.0,), (1.0,))
    with pytest.raises(ValueError, match="plan_pipeline"):
        eng.start_reshard(plan)


def test_serve_example_rebalance_smoke(capsys):
    """``--rebalance``: a drifting stream through a static and a
    rebalancing engine on one member, bit-exact, the placement ledger
    printed (one member never plans a move)."""
    from repro_torch.examples import serve_dlrm_bls
    serve_dlrm_bls.main(["--rebalance", "--batches", "3", "--batch-size",
                         "32", "--bound", "1", "--microbatches", "2",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "placement: reshards=0" in out
    assert "bit-exact vs static placement: True" in out
