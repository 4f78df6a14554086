"""The bf16 DLRM's runtime (freshness, the scrubber, the reshard and the
fault plan's bit flips) through the port against the JAX reference, on the
CPU, at smoke shapes; the model, kernels, plans and exchange are in
``test_torch_dlrm_bf16.py``, whose helpers this file shares.

Host copies of bf16 rows are the port's ``np.uint16`` bit patterns and the
reference's ``ml_dtypes.bfloat16`` arrays: they are compared as bits.

Tolerances: bit for bit for the freshness and repair wires' bytes and
checksums, the mirror, the manager's and the scrubber's decisions and
counters, and the tables and cached rows after every apply, repair and bit
flip (so each flip lands at the reference's byte and bit); ``ServeStats``
equal bar timings; CTRs within 1e-2 (``LOGIT_TOL``) of the reference
engine's, bit for bit against a static engine across a cutover.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import DLRMConfig as JConfig
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro.runtime import faults as jfaults
from repro.runtime import freshness as jfresh
from repro.runtime import placement as jplc
from repro.runtime import scrub as jscrub
from repro.serving import engine as jengine
from repro.serving import hot_cache as jhc
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import alltoallv as ta2a
from repro_torch.data import synthetic as tsyn
from repro_torch.models import dlrm as tdlrm
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import freshness as tfresh
from repro_torch.runtime import placement as tplc
from repro_torch.runtime import scrub as tscrub
from repro_torch.runtime.elastic import NodeFailure as TNodeFailure
from repro_torch.serving import hot_cache as thc
from repro_torch.serving.engine import DLRMEngine
from test_torch_dlrm_bf16 import (BF16, LOGIT_TOL, TIMING, _jmesh, _serve,
                                  bits, one_rank)  # noqa: F401
from test_torch_freshness import (K_FRESH, SMALL, StubEngine as FreshStub,
                                  _manager_state, _plan, route)
from test_torch_scrub import StubEngine as ScrubStub
from test_torch_scrub import _flip, _scrub_state, rep_route


# ---------------------------------------------------------------------------
# freshness and the scrubber: bytes and checksums bit for bit
# ---------------------------------------------------------------------------


def _bf16_base(shape, seed):
    return np.asarray(jnp.asarray(
        np.random.default_rng(seed).standard_normal(shape)
        .astype(np.float32), jnp.bfloat16))


def _assert_same_wire(tw, jw, step):
    assert list(tw) == list(jw)
    for k in jw:
        if jw[k].dtype.name == BF16:
            assert tw[k].dtype == np.uint16, k
            np.testing.assert_array_equal(tw[k], bits(jw[k]),
                                          err_msg=(step, k))
        else:
            assert tw[k].dtype == jw[k].dtype, k
            np.testing.assert_array_equal(tw[k], jw[k], err_msg=(step, k))


def _port_leaves(staged):
    return {k: ta2a.from_host(np.array(v)) for k, v in staged.items()}


@pytest.mark.parametrize("case", ["clean", "faults", "cache"])
def test_freshness_manager_over_bf16_stack_matches_reference(case):
    """Both managers over a stub engine holding the same bf16 stack: the
    delta wire (``dvec`` as bf16 bit patterns, rounded once from the
    source's f32 rows; the checksums over their 2·s bytes) equal to the
    reference's bit for bit every step, including the fault plan's byte
    flips; the same decisions; after every apply the same tables and
    cached rows, bit for bit."""
    P = 4
    jcfg, tcfg = JConfig("t", dtype=BF16, **SMALL), \
        DLRMConfig("t", dtype=BF16, **SMALL)
    t_pad = jdlrm.padded_tables(jcfg, P)
    base = np.asarray(jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg,
                                      n_shards=P)["tables"])
    r = base.shape[1]
    jc = tc = None
    if case == "cache":
        counts = np.random.default_rng(2).integers(0, 4, base.shape[:2]) \
            .astype(np.float64)
        counts[:, :3] += 10
        jc = jhc.build(jnp.asarray(base), counts, 8)
        tc = thc.build(ta2a.from_host(base.copy()), counts, 8)
    jf = jfaults.FaultInjector(_plan(jfaults, case), time_scale=0.0)
    tf = tfaults.FaultInjector(_plan(tfaults, case), time_scale=0.0)
    jeng = FreshStub(jnp.asarray(base), P, t_pad, 2, jf, jc)
    teng = FreshStub(ta2a.from_host(base.copy()), P, t_pad, 2, tf, tc)
    kw = dict(k_fresh=K_FRESH, slice_cap=3)
    jm = jfresh.FreshnessManager(itertools.islice(jsyn.delta_stream(
        jcfg, rows_per_version=7, seed=4), 8), **kw)
    tm = tfresh.FreshnessManager(itertools.islice(tsyn.delta_stream(
        tcfg, rows_per_version=7, seed=4), 8), **kw)
    for step in range(30):
        fails = []
        for fm, eng in ((jm, jeng), (tm, teng)):
            try:
                fm.apply(eng, step)
                fails.append(False)
            except (jfaults.NodeFailure, TNodeFailure):
                fm.on_evict(eng)
                fails.append(True)
        assert fails[0] == fails[1], step
        np.testing.assert_array_equal(bits(teng.params["tables"]),
                                      bits(jeng.params["tables"]))
        if case == "cache":
            np.testing.assert_array_equal(bits(teng.cache.hot_rows),
                                          bits(jeng.cache.hot_rows))
        jw, tw = jm.next_wire(jeng, step), tm.next_wire(teng, step)
        _assert_same_wire(tw, jw, step)
        staged = route(jw, P, t_pad // P, r)
        jm.ingest(staged, jeng, step)
        tm.ingest(_port_leaves(staged), teng, step)
        assert _manager_state(tm) == _manager_state(jm), step
        if tm.fully_committed and step > 3:
            break
    assert tm.fully_committed and tm.rows_applied > 0
    if case == "faults":
        assert tm.delta_rejects > 0


@pytest.mark.parametrize("case", ["table", "cache"])
def test_scrubber_over_bf16_stack_matches_reference(case):
    """Both scrubbers over a stub engine holding the same bf16 stack: the
    boot checksums over the 2·s-byte rows, the mirror (the port's as bf16
    bit patterns), the detections, the repair wire (``rvec`` bits and
    ``rcs``) bit for bit every step, a row corrupted on the wire rejected,
    a delta on a quarantined row taken as its repair, the repaired tables
    and cache bit for bit."""
    p, mb, r, s = 2, 2, 20, 8
    base = _bf16_base((4, r, s), 8)
    jc = tc = None
    rng = np.random.default_rng(8)
    if case == "cache":
        counts = rng.integers(0, 5, (4, r)).astype(np.float64)
        jc = jhc.build(jnp.asarray(base), counts, 5)
        tc = thc.build(ta2a.from_host(base.copy()), counts, 5)
    jeng = ScrubStub(jnp.asarray(base), p, mb, jc)
    teng = ScrubStub(ta2a.from_host(base.copy()), p, mb, tc)
    kw = dict(budget=3, block_rows=4, slice_cap=2, quarantine_cap=8)
    js, ts = jscrub.Scrubber(jeng, **kw), tscrub.Scrubber(teng, **kw)
    np.testing.assert_array_equal(ts.row_cs, js.row_cs)
    np.testing.assert_array_equal(ts.ledger.block_cs, js.ledger.block_cs)
    assert ts.mirror.dtype == np.uint16
    np.testing.assert_array_equal(ts.mirror, bits(js.mirror))
    flips = {1: [(0, 5, 3), (2, 17, 1)], 4: [(3, 2, 0), (1, 9, 15)]}
    cached = (2, int(np.asarray(jc.hot_ids)[2, 1])) if jc else None
    tcfg = DLRMConfig("t", table_sizes=(20, 20, 20, 20), embed_dim=s,
                      max_hot=3)
    seen_rep = False
    for step in range(30):
        for eng in (jeng, teng):
            for t, row, byte in flips.get(step, ()):
                _flip(eng, t, row, byte)
            if cached is not None and step == 2:
                _flip(eng, *cached, 1, cache=True)
        if step == 9:
            g = sorted(ts.quarantined)[0] if ts.quarantined else 5
            vec = np.full(s, 3.0, np.float32)
            jvec = np.asarray(jnp.asarray(vec, jnp.bfloat16))
            tvec = ta2a.round_to_host(vec, torch.bfloat16)
            js.note_applied(g, jvec, jvec.dtype)
            ts.note_applied(g, tvec, tvec.dtype)
            jeng.params["tables"] = jeng.params["tables"].at[
                g // r, g % r].set(jvec)
            teng.params["tables"][g // r, g % r] = ta2a.from_host(
                tvec, torch.bfloat16)
        js.apply(jeng, step)
        ts.apply(teng, step)
        assert ts.audit(teng, step) == js.audit(jeng, step), step
        ts.bank_audit(ts.audit_words[None])
        np.testing.assert_array_equal(ts.quarantine_phys(teng),
                                      js.quarantine_phys(jeng))
        b = jsyn.make_batch(tcfg, 16, mode="powerlaw_hetero", seed=step)
        assert ts.count_quarantined_served(
            teng, torch.from_numpy(b.idx), torch.from_numpy(b.mask)) == \
            js.count_quarantined_served(jeng, b.idx, b.mask), step
        jw, tw = js.next_wire(jeng, step), ts.next_wire(teng, step)
        _assert_same_wire(tw, jw, step)
        corrupt = ()
        if jw["rcnt"].any() and not seen_rep:
            seen_rep = True
            m0, j0 = np.argwhere(jw["rcnt"][..., 0] > 0)[0]
            corrupt = {(int(m0), int(j0), 0)}
        staged = rep_route(jw, p, 2, r, corrupt)
        js.ingest({k: jnp.asarray(v) for k, v in staged.items()}, jeng, step)
        ts.ingest(_port_leaves(staged), teng, step)
        assert _scrub_state(ts) == _scrub_state(js), step
        np.testing.assert_array_equal(bits(teng.params["tables"]),
                                      bits(jeng.params["tables"]))
        if case == "cache":
            np.testing.assert_array_equal(bits(teng.cache.hot_rows),
                                          bits(jeng.cache.hot_rows))
    assert ts.fully_repaired and ts.repaired_rows >= 3
    assert ts.repair_rejects >= 1


# ---------------------------------------------------------------------------
# P = 1 engines: bit flips, scrub repairs, freshness and a reshard
# ---------------------------------------------------------------------------

P1_CFG = dict(table_sizes=(40, 60, 30, 50, 20, 70), embed_dim=8,
              n_dense_features=4, bottom_mlp=(16, 8), top_mlp=(16, 1),
              max_hot=4, sparse_backend="ref", dtype=BF16)
B = 48


def _p1_params():
    jcfg, tcfg = JConfig("t", **P1_CFG), DLRMConfig("t", **P1_CFG)
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=1)
    return jcfg, tcfg, jp, tdlrm.params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("cached", [False, True])
def test_scrub_engine_at_one_member_matches_reference(one_rank, cached):
    """Resident-row flips, a cached-copy flip and a corrupted segment on
    the self link, on a bf16 stack: after every flush the tables are the
    reference's bit for bit (each flip at the reference's byte and bit,
    each repair the mirror's bytes), ``ServeStats`` equal bar timings, the
    CTRs within 1e-2; the stack ends bit-identical to the clean one."""
    jcfg, tcfg, jp, tp = _p1_params()
    clean = tp["tables"].clone()
    batches = [jsyn.make_batch(jcfg, B, mode="powerlaw_hetero", seed=3,
                               step=s, t_pad=6) for s in range(14)]
    crow = None
    if cached:
        pre = jhc.build_from_batch(jp["tables"], batches[0].idx,
                                   batches[0].mask, 8)
        crow = int(np.asarray(pre.hot_ids)[0, 0])

    def plan(mod):
        pl = mod.FaultPlan.none(1, 40).with_bitflip(0, 2, 7, 5, when=2) \
            .with_bitflip(0, 0, 3, 9, when=3) \
            .with_wire_corruption(0, 0, when=4)
        if crow is not None:
            pl = pl.with_bitflip(0, 0, crow, 2, when=5, target="cache")
        return pl

    ekw = dict(batch_size=B, bound=1, microbatches=2, scrub_budget=4,
               exchange="dense")
    jeng = jengine.DLRMEngine(dict(jp), jcfg, faults=jfaults.FaultInjector(
        plan(jfaults)), **ekw)
    teng = DLRMEngine(dict(tp), tcfg, device="cpu",
                      faults=tfaults.FaultInjector(plan(tfaults)), **ekw)
    jo, to = [], []
    with _jmesh():
        if cached:
            for eng in (jeng, teng):
                eng.calibrate_cache(batches[0].idx, batches[0].mask,
                                    cache_rows=8)
        for b in batches:
            j, t = _serve((jeng, teng), [b], B)
            jo.append(j)
            to.append(t)
            jd, td = jeng.stats.to_dict(), teng.stats.to_dict()
            for k in set(jd) - TIMING:
                assert td[k] == jd[k], (len(to), k, td[k], jd[k])
            np.testing.assert_array_equal(bits(teng.params["tables"]),
                                          bits(jeng.params["tables"]))
    np.testing.assert_allclose(np.concatenate(to), np.concatenate(jo),
                               **LOGIT_TOL)
    st = teng.stats
    assert st.detections >= 2 + cached and st.repaired_rows >= 2
    assert st.wire_rejects == 2 and teng.scrub.fully_repaired
    for t, n in enumerate(P1_CFG["table_sizes"]):
        assert torch.equal(teng.params["tables"][t, :n].view(torch.int16),
                           clean[t, :n].view(torch.int16))


def test_freshness_engine_at_one_member_matches_reference(one_rank):
    """A freshness manager on each engine over the same delta stream, a
    bf16 stack and a bf16 wire: the tables after every flush bit for bit
    (deltas rounded once to bf16, the ``xdelta`` rider's ``dvec`` in
    bf16), ``ServeStats`` equal bar timings, CTRs within 1e-2, and the end
    state the reference's oracle tables."""
    jcfg, tcfg, jp, tp = _p1_params()
    kw = dict(k_fresh=2, slice_cap=8)
    jm = jfresh.FreshnessManager(itertools.islice(jsyn.delta_stream(
        jcfg, rows_per_version=6, seed=2), 4), **kw)
    tm = tfresh.FreshnessManager(itertools.islice(tsyn.delta_stream(
        tcfg, rows_per_version=6, seed=2), 4), **kw)
    ekw = dict(batch_size=B, bound=1, microbatches=2, wire_dtype=BF16)
    jeng = jengine.DLRMEngine(dict(jp), jcfg, freshness=jm, **ekw)
    teng = DLRMEngine(dict(tp), tcfg, device="cpu", freshness=tm, **ekw)
    jo, to = [], []
    with _jmesh():
        for s in range(8):
            b = jsyn.make_batch(jcfg, B, mode="hetero", seed=4, step=s,
                                t_pad=6)
            j, t = _serve((jeng, teng), [b], B)
            jo.append(j)
            to.append(t)
            np.testing.assert_array_equal(bits(teng.params["tables"]),
                                          bits(jeng.params["tables"]))
            jd, td = jeng.stats.to_dict(), teng.stats.to_dict()
            for k in set(jd) - TIMING:
                assert td[k] == jd[k], (s, k, td[k], jd[k])
    np.testing.assert_allclose(np.concatenate(to), np.concatenate(jo),
                               **LOGIT_TOL)
    assert tm.rows_applied == jm.rows_applied > 0
    oracle = tfresh.oracle_tables(tp["tables"], list(itertools.islice(
        tsyn.delta_stream(tcfg, rows_per_version=6, seed=2), 4)))
    if tm.fully_committed:
        np.testing.assert_array_equal(bits(teng.params["tables"]),
                                      bits(oracle))


def test_reshard_at_one_member_matches_reference(one_rank):
    """A hand-built plan reversing the slots on a bf16 stack: the banked
    rows (bf16 bit patterns on the host) installed bit for bit, the stack
    after the cutover the reference's, CTRs bit-identical to a static
    engine's and within 1e-2 of the reference's."""
    jcfg, tcfg, jp, tp = _p1_params()
    ekw = dict(batch_size=B, bound=1, microbatches=2, mig_slice_cap=8,
               rebalance=True)
    jeng = jengine.DLRMEngine(dict(jp), jcfg, **ekw)
    teng = DLRMEngine(dict(tp), tcfg, device="cpu", **ekw)
    static = DLRMEngine(dict(tp), tcfg, device="cpu", batch_size=B,
                        bound=1, microbatches=2)
    perm = (5, 4, 3, 2, 1, 0)
    moves = tuple((t, 0, 0, n) for t, n in
                  enumerate(P1_CFG["table_sizes"]))
    outs = []
    with _jmesh():
        for step in range(24):
            if step == 1:
                for eng, mod in ((jeng, jplc), (teng, tplc)):
                    eng.start_reshard(mod.MigrationPlan(
                        mod.PartitionMap(perm), moves, (), (1.0,), (1.0,)))
            b = jsyn.make_batch(jcfg, B, mode="drift", seed=3, step=step)
            outs.append(_serve((jeng, teng, static), [b], B))
            js = None if jeng.reshard is None else jeng.reshard.summary()
            ts = None if teng.reshard is None else teng.reshard.summary()
            assert ts == js, step
    assert teng.stats.reshards == jeng.stats.reshards == 1
    jo, to, so = (np.concatenate(x) for x in zip(*outs))
    np.testing.assert_allclose(to, jo, **LOGIT_TOL)
    np.testing.assert_array_equal(to, so)
    np.testing.assert_array_equal(bits(teng.params["tables"]),
                                  bits(jeng.params["tables"]))
