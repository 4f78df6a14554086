"""The port's online embedding freshness (``repro_torch/runtime/
freshness.py``, the ``deltas=`` rider of ``forward_distributed`` and the
engine's hooks) against the JAX reference, on the CPU.

  * ``row_checksum``, ``VersionLedger``, ``count_stale_served`` and the hot
    cache's ``refresh_rows`` count equal to the reference's;
  * the reference's ``FreshnessManager`` and the port's, each over a stub
    engine, step by step on the same stream and fault plan: every wire
    leaf, decision, counter and the tables after each apply bit for bit;
    a crash inside the apply leaves the tables and the cache as they were;
  * on 4 gloo members (``_torch_fresh_worker.py``, one run), the
    reference's ``tests/test_freshness.py`` gates: bit-exact convergence to
    the reference's ``oracle_tables`` on the float32, bf16 and int8 wires,
    ``versions_behind <= k_fresh`` over the burst x updater-straggler x
    crash grid, a corrupted delta rejected and applied again, a crash
    mid-apply rolled back and replayed on 3 members (``layout_version``
    1), a degraded member serving its last-good version, cached rows
    refreshed, ``rows_stale_served`` exact, the same collective calls with
    and without deltas, and a frontend resetting its flush estimate on the
    eviction;
  * the example's ``--frontend --updates`` mode.
"""
import itertools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import flatten, run_members
from _torch_fresh_worker import (COLLECTIVES, N_VER, P_CFG, PIPES, STATE,
                                 WIRES, B)
from repro.configs.base import DLRMConfig as JConfig
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro.runtime import faults as jfaults
from repro.runtime import freshness as jfresh
from repro.serving import hot_cache as jhc
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import integrity as tinteg
from repro_torch.data import synthetic as tsyn
from repro_torch.models import dlrm as tdlrm
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import freshness as tfresh
from repro_torch.runtime.elastic import NodeFailure as TNodeFailure
from repro_torch.serving import hot_cache as thc
from repro_torch.serving.engine import DLRMEngine

P = 4
K_FRESH = 2
REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the checksum, the ledger, the cache refresh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_row_checksum_matches_reference_with_byte_flips(dtype):
    """The same words for the same bytes, and every one-byte flip of a row
    changes both packages' words alike.  bf16 rows are rounded by torch on
    the port's side and by JAX's bf16 on the reference's."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((5, 8)).astype(np.float32)
    if dtype == "bfloat16":
        ref = np.asarray(jnp.asarray(f32, jnp.bfloat16))
        ours = torch.from_numpy(f32).to(torch.bfloat16).view(torch.int16) \
            .numpy()
    else:
        ref = ours = f32.astype(dtype)
    assert ref.tobytes() == ours.tobytes()
    gids, ver = np.arange(5) * 17 + 3, 6
    want = jfresh.row_checksum(ref, gids, ver)
    np.testing.assert_array_equal(tinteg.row_checksum(ours, gids, ver), want)
    assert tinteg.row_checksum(ours, gids, ver).dtype == np.uint32
    raw = ours[0].view(np.uint8)
    for i in range(raw.size):
        for bit in (0x01, 0x80, 0x55):
            mut = raw.copy()
            mut[i] ^= bit
            got = tinteg.row_checksum(mut.view(ours.dtype), 3, ver)
            assert got == jfresh.row_checksum(mut.view(ref.dtype), 3, ver)
            assert got != want[0], (i, bit)
    assert tinteg.row_checksum(ours[0], 4, ver) != want[0]     # wrong gid
    assert tinteg.row_checksum(ours[0], 3, ver + 1) != want[0]  # version


def test_version_ledger_matches_reference():
    for applied, shipped in (([3, 1, 3, 3], 3), ([0, 0], 0), ([], 0),
                             ([5, 2, 4], 7)):
        a = np.array(applied, np.int64)
        t = tfresh.VersionLedger(K_FRESH, a, shipped_max=shipped)
        j = jfresh.VersionLedger(K_FRESH, a, shipped_max=shipped)
        assert (t.min_applied, t.versions_behind) == \
            (j.min_applied, j.versions_behind)
        for v in range(10):
            assert t.may_ship(v) == j.may_ship(v)
    with pytest.raises(ValueError):
        tfresh.FreshnessManager(iter(()), k_fresh=0)
    with pytest.raises(ValueError):
        tfresh.FreshnessManager(iter(()), slice_cap=0)


def test_refresh_rows_counts_as_reference():
    """The cache refresh skips rows not cached and out-of-range sentinels
    (the reference pads its scatter with table id T) and counts what it
    refreshed as the reference does."""
    rng = np.random.default_rng(1)
    tables = rng.standard_normal((4, 30, 8)).astype(np.float32)
    counts = rng.integers(0, 5, (4, 30)).astype(np.float64)
    jc = jhc.build(jnp.asarray(tables), counts, 6)
    tc = thc.build(torch.from_numpy(tables), counts, 6)
    tab = np.array([0, 1, 2, 3, 4, 4, 0])
    row = np.array([int(np.asarray(jc.hot_ids)[0, 2]), 5, 29, 0, 0, 3,
                    int(np.asarray(jc.hot_ids)[0, 4])])
    vec = rng.standard_normal((7, 8)).astype(np.float32)
    jn, jcount = jhc.refresh_rows(jc, tab, row, vec)
    tn, tcount = thc.refresh_rows(tc, tab, row, torch.from_numpy(vec))
    assert tcount == jcount >= 2
    np.testing.assert_array_equal(tn.hot_rows.numpy(),
                                  np.asarray(jn.hot_rows))


# ---------------------------------------------------------------------------
# both managers over a stub engine
# ---------------------------------------------------------------------------


class StubEngine:
    """What a ``FreshnessManager`` reads of ``DLRMEngine``: the geometry,
    the table stack, the cache, the faults, the degraded members."""

    def __init__(self, tables, p, t_pad, mb, faults=None, cache=None):
        self.params = {"tables": tables}
        self._p, self._t_pad = p, t_pad
        self.microbatches = mb
        self.faults, self.cache = faults, cache
        self.degraded_members = ()
        self._staged_plan = None

    def _exchange_geometry(self):
        return self._p, self._t_pad, 1, 1

    def _active_mesh(self):
        return None

    def _group(self):
        return None


def route(wire, p, t_loc, r):
    """Host model of the rider: each (member, microbatch) slice's rows
    delivered to their owners, in slice order; leaves (P_dst, mb, P_src,
    ...).  The version rides to every destination."""
    mb, dcap = wire["dgid"].shape[1:]
    out = {k: np.zeros((p, mb, p) + v.shape[2:], v.dtype)
           for k, v in wire.items()}
    for m in range(p):
        for j in range(mb):
            n = int(wire["dcnt"][m, j, 0])
            dest = wire["dgid"][m, j, :n].astype(np.int64) // r // t_loc
            for q in range(p):
                sel = np.flatnonzero(dest == q)
                out["dcnt"][q, j, m, 0] = len(sel)
                out["dver"][q, j, m, 0] = wire["dver"][m, j, 0]
                for k in ("dvec", "dgid", "dcs"):
                    out[k][q, j, m, :len(sel)] = wire[k][m, j, sel]
    return out


SMALL = dict(table_sizes=(40, 60, 30, 50, 20, 70), embed_dim=8,
             n_dense_features=4, bottom_mlp=(16, 8), top_mlp=(16, 1))


def _plan(mod, case):
    plan = mod.FaultPlan.none(P, 32)
    if case == "faults":
        plan = plan.with_update_burst(1, 2, 3.0) \
            .with_delta_corruption(0, 1, n_rows=2) \
            .with_delta_corruption(3, 4, n_rows=3) \
            .with_updater_straggler(1, from_step=2, n_steps=3) \
            .with_apply_crash(2, at_step=5)
    return plan


def _manager_state(fm):
    return (sorted(fm._sendq), sorted(fm._inflight), sorted(fm._banked),
            sorted(fm._apply_buf),
            {v: sorted(g) for v, g in fm._remaining.items()},
            fm.latest_pulled, fm.ledger.applied.tolist(),
            fm.ledger.shipped_max, fm.rows_applied, fm.delta_rejects,
            fm.rollbacks, fm.applies, fm.source_blocked,
            fm.cache_refreshed, list(fm.behind_trace), fm.fully_committed)


@pytest.mark.parametrize("case", ["clean", "faults", "degraded", "cache"])
def test_manager_matches_reference_over_stub_engine(case):
    """Step by step, both managers on the same stream, geometry and fault
    plan: the wire leaves bit for bit, the same decisions and counters,
    and after every apply the same tables (and cached rows)."""
    jcfg, tcfg = JConfig("t", **SMALL), DLRMConfig("t", **SMALL)
    t_pad = jdlrm.padded_tables(jcfg, P)
    base = np.asarray(jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg,
                                      n_shards=P)["tables"])
    r = base.shape[1]
    jc = tc = None
    if case == "cache":
        counts = np.random.default_rng(2).integers(0, 4, base.shape[:2]) \
            .astype(np.float64)
        counts[:, :3] += 10          # the powerlaw head, which deltas hit
        jc = jhc.build(jnp.asarray(base), counts, 8)
        tc = thc.build(torch.from_numpy(base.copy()), counts, 8)
    jf = jfaults.FaultInjector(_plan(jfaults, case), time_scale=0.0)
    tf = tfaults.FaultInjector(_plan(tfaults, case), time_scale=0.0)
    jeng = StubEngine(jnp.asarray(base), P, t_pad, 2, jf, jc)
    teng = StubEngine(torch.from_numpy(base.copy()), P, t_pad, 2, tf, tc)
    kw = dict(k_fresh=K_FRESH, slice_cap=3)
    jm = jfresh.FreshnessManager(itertools.islice(jsyn.delta_stream(
        jcfg, rows_per_version=7, seed=4), 8), **kw)
    tm = tfresh.FreshnessManager(itertools.islice(tsyn.delta_stream(
        tcfg, rows_per_version=7, seed=4), 8), **kw)
    crashed = 0
    for step in range(30):
        if case == "degraded":
            deg = (1,) if 2 <= step < 6 else ()
            jeng.degraded_members = teng.degraded_members = deg
        fails = []
        for fm, eng in ((jm, jeng), (tm, teng)):
            try:
                fm.apply(eng, step)
                fails.append(False)
            except (jfaults.NodeFailure, TNodeFailure):
                fm.on_evict(eng)
                fails.append(True)
        assert fails[0] == fails[1], step
        crashed += fails[0]
        np.testing.assert_array_equal(teng.params["tables"].numpy(),
                                      np.asarray(jeng.params["tables"]))
        if case == "cache":
            np.testing.assert_array_equal(teng.cache.hot_rows.numpy(),
                                          np.asarray(jeng.cache.hot_rows))
        jw, tw = jm.next_wire(jeng, step), tm.next_wire(teng, step)
        assert list(jw) == list(tw)
        for k in jw:
            assert tw[k].dtype == jw[k].dtype, k
            np.testing.assert_array_equal(tw[k], jw[k], err_msg=(step, k))
        staged = route(jw, P, t_pad // P, r)
        jm.ingest(staged, jeng, step)
        tm.ingest({k: torch.from_numpy(v.copy()) for k, v in staged.items()},
                  teng, step)
        assert _manager_state(tm) == _manager_state(jm), step
        if tm.fully_committed and step > 3:
            break
    assert tm.fully_committed
    if case == "faults":
        assert crashed == 1 and tm.rollbacks == 1
        assert tm.delta_rejects > 0 and tm.source_blocked >= 0
    if case == "cache":
        assert tm.cache_refreshed > 0
    batches = [tsyn.make_delta_batch(tcfg, v, rows_per_version=7, seed=4)
               for v in range(1, 9)]
    oracle = tfresh.oracle_tables(torch.from_numpy(base.copy()), batches)
    assert torch.equal(teng.params["tables"], oracle)
    np.testing.assert_array_equal(oracle.numpy(), np.asarray(
        jfresh.oracle_tables(jnp.asarray(base), batches)))


def _buffered_manager(plan):
    """A manager over a stub engine with a 12-row cache whose rows are
    verified and buffered, ready for the apply window."""
    cfg = DLRMConfig("t", **SMALL)
    base = torch.randn(8, 70, 8, generator=torch.Generator().manual_seed(3))
    counts = np.zeros((8, 70))
    counts[:, :12] = 1
    cache = thc.build(base, counts, 12)
    inj = tfaults.FaultInjector(plan, time_scale=0.0)
    eng = StubEngine(base, P, 8, 2, inj, cache)
    fm = tfresh.FreshnessManager(itertools.islice(tsyn.delta_stream(
        cfg, rows_per_version=12, seed=1), 2), slice_cap=8)
    wire = fm.next_wire(eng, 0)
    fm.ingest({k: torch.from_numpy(v) for k, v in
               route(wire, P, 2, 70).items()}, eng, 0)
    fm._process_held(eng)
    assert fm._apply_buf
    return fm, eng, sorted(fm._apply_buf), base.clone(), \
        cache.hot_rows.clone()


def test_crash_mid_apply_leaves_tables_and_cache_bit_identical():
    """The in-place apply's undo: a crash at the injector's point inside
    the window writes the saved rows back, so the tables and the cache
    equal their state before the apply, and the rows stay buffered."""
    fm, eng, buf, tables0, rows0 = _buffered_manager(
        tfaults.FaultPlan.none(P, 8).with_apply_crash(2, at_step=1))
    with pytest.raises(TNodeFailure):
        fm.apply(eng, 1)
    assert fm.rollbacks == 1 and fm.rows_applied == 0
    assert torch.equal(eng.params["tables"], tables0)
    assert torch.equal(eng.cache.hot_rows, rows0)
    assert sorted(fm._apply_buf) == buf
    # the rows did touch the cache: the next window commits them
    fm.apply(eng, 2)
    assert fm.rows_applied == len(buf) and fm.cache_refreshed > 0
    assert not torch.equal(eng.cache.hot_rows, rows0)


@pytest.mark.parametrize("where", ["on_apply", "cache"])
def test_error_mid_apply_leaves_tables_and_cache_bit_identical(
        where, monkeypatch):
    """Any error inside the window, not only the injector's crash, writes
    the saved rows back: an interrupt at the injector's point (after both
    writes), or an error looking up the cache (after the table write).
    It is no rollback of a crash, and the rows stay buffered."""
    fm, eng, buf, tables0, rows0 = _buffered_manager(
        tfaults.FaultPlan.none(P, 8))
    err = KeyboardInterrupt if where == "on_apply" else RuntimeError

    def boom(*a, **kw):
        raise err("mid-apply")

    if where == "on_apply":
        monkeypatch.setattr(eng.faults, "on_apply", boom)
    else:
        monkeypatch.setattr(thc, "_cached", boom)
    with pytest.raises(err):
        fm.apply(eng, 1)
    assert fm.rollbacks == 0 and fm.rows_applied == 0
    assert torch.equal(eng.params["tables"], tables0)
    assert torch.equal(eng.cache.hot_rows, rows0)
    assert sorted(fm._apply_buf) == buf
    monkeypatch.undo()
    fm.apply(eng, 2)
    assert fm.rows_applied == len(buf)
    assert not torch.equal(eng.params["tables"], tables0)


def test_rows_outside_the_stack_are_refused_at_the_pull():
    """The port's gids are tab·R + row of its own ``DeltaBatch``es: a
    version holding a row outside the stack is refused where it is
    pulled, before anything ships."""
    cfg = DLRMConfig("t", **SMALL)
    good = tsyn.make_delta_batch(cfg, 1, rows_per_version=4, seed=2)
    bad = tsyn.DeltaBatch(good.version, good.tab, good.row + 70, good.vec)
    eng = StubEngine(torch.zeros(8, 70, 8), P, 8, 2)
    fm = tfresh.FreshnessManager(iter([bad]), slice_cap=8)
    with pytest.raises(ValueError, match="outside"):
        fm.next_wire(eng, 0)


def test_count_stale_served_matches_reference():
    jcfg, tcfg = JConfig("t", **SMALL), DLRMConfig("t", **SMALL)
    base = np.zeros((8, 70, 8), np.float32)
    jeng = StubEngine(jnp.asarray(base), P, 8, 2)
    teng = StubEngine(torch.from_numpy(base), P, 8, 2)
    jm = jfresh.FreshnessManager(jsyn.delta_stream(
        jcfg, rows_per_version=20, seed=2), slice_cap=2)
    tm = tfresh.FreshnessManager(tsyn.delta_stream(
        tcfg, rows_per_version=20, seed=2), slice_cap=2)
    for step in range(3):
        jm.next_wire(jeng, step)
        tm.next_wire(teng, step)
        b = jsyn.make_batch(jcfg, 32, mode="powerlaw_hetero", t_pad=8,
                            seed=5, step=step)
        want = jm.count_stale_served(jeng, b.idx, b.mask)
        got = tm.count_stale_served(teng, torch.from_numpy(b.idx),
                                    torch.from_numpy(b.mask))
        assert got == want
    assert want > 0


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _port_params():
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), JConfig("t", **SMALL),
                         n_shards=1)
    return tdlrm.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_deltas_need_a_group_and_later_riders_are_refused():
    """Deltas need a model group; the later riders (ROADMAP A11, A12) are
    ported and raise without one as the reference's do without a mesh.
    The name, from when they were refused, is kept so the test count
    holds."""
    cfg = DLRMConfig("t", **SMALL, sparse_backend="ref")
    params = _port_params()
    b = tsyn.make_batch(cfg, 8, mode="hetero", seed=1)
    x = [torch.from_numpy(a) for a in (b.dense, b.idx, b.mask)]
    wire = {k: torch.zeros((1, 1, 2)) for k in ("dgid", "dcs", "dvec")}
    with pytest.raises(ValueError, match="model group"):
        tdlrm.forward_distributed(params, cfg, *x, deltas=wire)
    # the later riders are ported (ROADMAP A11, A12): without a group the
    # ones that ride the exchange raise as deltas do, and quarantine and
    # table_inv fall back to forward_local, as the reference's do
    for kw in ({"migration": {}}, {"repair": {}}, {"wire_check": True}):
        with pytest.raises(ValueError, match="model group"):
            tdlrm.forward_distributed(params, cfg, *x, **kw)
    for kw in ({"table_inv": [0]}, {"quarantine": [1]}):
        assert torch.equal(tdlrm.forward_distributed(params, cfg, *x, **kw),
                           tdlrm.forward_local(params, cfg, *x))
    fm = tfresh.FreshnessManager(iter(()))
    with pytest.raises(ValueError, match="plan_pipeline"):
        DLRMEngine(params, cfg, batch_size=8, freshness=fm,
                   plan_pipeline=True, device="cpu")
    eng = DLRMEngine(params, cfg, batch_size=8, freshness=fm, device="cpu")
    assert eng.freshness is fm
    shard = dict(params, tables=params["tables"][:3])
    with pytest.raises(ValueError, match="whole"):
        DLRMEngine(shard, cfg, batch_size=8, freshness=fm, device="cpu")


# ---------------------------------------------------------------------------
# 4 gloo members: the reference's end-to-end gates
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    jcfg = JConfig("t", **P_CFG)
    t_pad = jdlrm.padded_tables(jcfg, P)
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=P)
    inputs = {}
    flatten("fresh", params, inputs)
    for s in range(24):
        b = jsyn.make_batch(jcfg, B, mode="powerlaw", t_pad=t_pad, seed=9,
                            step=s)
        for k in ("dense", "idx", "mask"):
            inputs[f"b{s}/{k}"] = getattr(b, k)
    deltas = [jsyn.make_delta_batch(jcfg, v, rows_per_version=6, seed=3)
              for v in range(1, N_VER + 1)]
    inputs["oracle"] = np.asarray(jfresh.oracle_tables(params["tables"],
                                                       deltas))
    # a delta wire for the collective count: random valid slices
    rng = np.random.default_rng(7)
    r, s, dcap = params["tables"].shape[1], jcfg.embed_dim, 4
    tab = rng.integers(0, jcfg.n_tables, (P, 2, dcap))
    row = rng.integers(0, 20, (P, 2, dcap))
    wire = {"dcnt": rng.integers(0, dcap + 1, (P, 2, 1)).astype(np.int32),
            "dgid": (tab * r + row).astype(np.int32),
            "dvec": rng.standard_normal((P, 2, dcap, s)).astype(np.float32),
            "dver": rng.integers(1, 6, (P, 2, 1)).astype(np.int32)}
    wire["dcs"] = jfresh.row_checksum(wire["dvec"], wire["dgid"],
                                      wire["dver"])
    for k, v in wire.items():
        inputs[f"wire/{k}"] = v
    outs = run_members(Path(__file__).with_name("_torch_fresh_worker.py"),
                       P, inputs, tmp_path_factory.mktemp("fresh4"),
                       timeout=600)
    want = {"rows": sum(d.n_rows for d in deltas), "wire": wire,
            "staged": route(wire, P, t_pad // P, r), "t_pad": t_pad}
    return want, outs


def _state(out, tag):
    return dict(zip(STATE, out[f"{tag}/state"].tolist()))


def _live(outs, tag):
    """The members a crash did not evict, with their state; every one of
    them took the same decisions."""
    live = [o for o in outs if not bool(o.get(f"{tag}/evicted", False))]
    for o in live[1:]:
        np.testing.assert_array_equal(o[f"{tag}/state"],
                                      live[0][f"{tag}/state"])
        np.testing.assert_array_equal(o[f"{tag}/trace"],
                                      live[0][f"{tag}/trace"])
    return [(o, _state(o, tag)) for o in live]


def _converged(out, st, tag, requests=True):
    assert all(v <= K_FRESH for v in out[f"{tag}/trace"]), \
        out[f"{tag}/trace"]
    assert st["fully_committed"] == 1, st
    assert bool(out[f"{tag}/oracle_ok"]), f"{tag}: tables != oracle"
    assert bool(out[f"{tag}/finite"])
    if requests:
        assert st["answered"] == st["requests"]      # zero lost requests


@pytest.mark.parametrize("wire", WIRES)
def test_clean_stream_converges_bit_exact(members, wire):
    """No faults, on each wire codec: the stream drains while serving,
    versions_behind <= k_fresh at every flush, every request answered, the
    tables equal to the oracle bit for bit (the delta rows travel in the
    table's dtype, not through the codec)."""
    want, outs = members
    tag = f"clean/{wire}"
    live = _live(outs, tag)
    assert len(live) == P
    for out, st in live:
        _converged(out, st, tag)
        assert st["rows_applied"] == st["stats_rows_applied"] == \
            want["rows"]
        assert st["delta_rejects"] == st["rollbacks"] == 0
        assert st["versions_behind"] == 0
        keys = set(out[f"{tag}/keys"].tolist())
        assert {"rows_applied", "rows_stale_served", "versions_behind",
                "delta_rejects", "apply_rollbacks"} <= keys


@pytest.mark.parametrize("cell", ["".join(c) for c in
                                  itertools.product("01", repeat=3)])
def test_fault_grid_staleness_invariant(members, cell):
    """update burst x updater straggler x crash mid-apply: serving never
    stops, versions_behind <= k_fresh throughout, the tables end on the
    oracle; a crash rolls back and evicts member 2."""
    _, outs = members
    tag = f"grid/{cell}"
    crash = cell[2] == "1"
    live = _live(outs, tag)
    assert len(live) == (P - 1 if crash else P)
    if crash:
        assert bool(outs[2][f"{tag}/evicted"])
    for out, st in live:
        _converged(out, st, tag)
        if crash:
            assert st["rollbacks"] >= 1 and st["evictions"] >= 1
            assert st["members"] == P - 1 and st["layout_version"] == 1


def test_corrupt_delta_rejected_then_reapplied(members):
    _, outs = members
    for out, st in _live(outs, "corrupt"):
        _converged(out, st, "corrupt")
        assert st["delta_rejects"] >= 2
        assert st["stats_delta_rejects"] == st["delta_rejects"]


def test_crash_mid_apply_rolls_back_then_replays(members):
    """Member 1 crashes inside the apply window at flush 3: the tables are
    bit-identical to their state before the apply on every member, the
    survivors evict it, replay onto 3 members (``layout_version`` 1) and
    converge on the oracle."""
    _, outs = members
    for out in outs:
        assert bool(out["crash/rollback_identical"])
    assert bool(outs[1]["crash/evicted"])
    live = _live(outs, "crash")
    assert len(live) == P - 1
    for out, st in live:
        _converged(out, st, "crash")
        assert st["rollbacks"] == st["apply_rollbacks"] == 1
        assert st["evictions"] == 1 and st["replays"] >= 1
        assert st["members"] == 3 and st["layout_version"] == 1


def test_degraded_member_serves_last_good_version(members):
    _, outs = members
    for out, st in _live(outs, "degraded"):
        assert out["degraded/held_owners"].tolist() == [2]
        assert all(v <= K_FRESH for v in out["degraded/held_trace"])
        _converged(out, st, "degraded")


def test_cached_rows_refreshed_in_place(members):
    want, outs = members
    for out, st in _live(outs, "cache"):
        _converged(out, st, "cache")
        assert st["cache_refreshed"] > 0
        assert st["stats_rows_applied"] == want["rows"]
        assert bool(out["cache/rows_match"])


def test_stale_serving_counted_exactly(members):
    _, outs = members
    for out, st in _live(outs, "stale"):
        per = out["stale/per_flush"]
        np.testing.assert_array_equal(per[:, 0], per[:, 1])
        assert st["rows_stale_served"] == per[:, 0].sum() > 0
        _converged(out, st, "stale")


@pytest.mark.parametrize("pipe", PIPES)
def test_deltas_add_no_collective(members, pipe):
    """With the delta rows on the wire, the forward makes the same calls of
    every collective (one all_to_all_single a microbatch for 'mono', P−1
    point-to-point rounds for 'ring', one all_gather), as it does with or
    without the diagnostics that return the harvest; the logits do not
    move, and every member's harvest is the host model's."""
    want, outs = members
    for m, out in enumerate(outs):
        plain = out[f"coll/{pipe}/plain/counts"]
        for tag in ("diag", "deltas"):
            np.testing.assert_array_equal(out[f"coll/{pipe}/{tag}/counts"],
                                          plain, err_msg=tag)
            np.testing.assert_array_equal(out[f"coll/{pipe}/{tag}/logits"],
                                          out[f"coll/{pipe}/plain/logits"])
        assert out[f"coll/{pipe}/diag/live_max"] == \
            outs[0][f"coll/{pipe}/diag/live_max"] > 0
        n = dict(zip(COLLECTIVES, plain.tolist()))
        if pipe == "mono":
            assert n["all_to_all_single"] == 2 and \
                n["batch_isend_irecv"] == 0
        else:
            assert n["all_to_all_single"] == 0 and \
                n["batch_isend_irecv"] == 2 * (P - 1)
        assert n["all_gather"] == 1 and n["all_reduce"] == 0
        for k, v in want["staged"].items():
            got = out[f"coll/{pipe}/staged/{k}"]
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_frontend_recalibrates_on_eviction(members):
    """A frontend over an engine whose member 1 crashes at flush 2: the
    engine reads ``layout_version`` 1 afterwards, as the reference's does,
    and the frontend's flush estimate is reset exactly on the flush that
    spans the eviction (the reference's ``_observe_flush``)."""
    _, outs = members
    assert bool(outs[1]["fe/evicted"])
    for m in (0, 2, 3):
        out = outs[m]
        assert not bool(out["fe/evicted"])
        admitted, completed, evictions, accounted, lv = \
            out["fe/state"].tolist()
        assert admitted == completed == 4 * B and accounted
        assert evictions == 1 and lv == 1
        ewma, versions = out["fe/ewma"], out["fe/versions"]
        first = int(np.flatnonzero(versions == 1)[0])
        assert first == 2 and ewma[first] == -1.0
        assert (np.delete(ewma, first) > 0).all()


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------


def test_serve_example_updates_smoke():
    """``--frontend --updates``: an open-loop bursty stream served while a
    live delta stream rides the exchange; the example's own asserts (exact
    accounting, bounded staleness) hold."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.serve_dlrm_bls",
         "--frontend", "--batches", "2", "--batch-size", "32",
         "--bound", "1", "--microbatches", "2", "--open-requests", "96",
         "--overload", "2.0", "--burstiness", "0.4", "--slo-ms", "200",
         "--updates", "4", "--k-fresh", "2", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert "accounting" in r.stdout and "exact" in r.stdout
    assert "freshness: applied" in r.stdout, r.stdout
    assert "<= k_fresh 2" in r.stdout, r.stdout
