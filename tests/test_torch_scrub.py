"""The port's integrity scrubbing (``repro_torch/core/integrity.py``,
``runtime/scrub.py``, the ``repair=``, ``quarantine=`` and ``wire_check``
riders of ``forward_distributed`` and the engine's scrub path) against the
JAX reference, on the CPU.

  * the folds: the pinned words, the torch device fold equal to the host
    ``row_checksum`` and to JAX's across f32, bf16 and f16, every
    single-bit flip moving exactly one block, padding rows folding to 0,
    ``note_update`` equal to a full recompute, the audit and cache-slot
    folds equal to JAX's, the ledger built on the device equal to the
    reference's ``IntegrityLedger.from_tables``, ``wire_stamp`` bytes
    equal to JAX's on the same fused buffer with every byte flip rejected;
  * both ``Scrubber``s over a stub engine, step by step: audits,
    detections, quarantine vectors, repair wire leaves, verification,
    rejects, the repaired tables and cache, every counter;
  * at P = 1, the reference's ``DLRMEngine`` (a one-device mesh) and the
    port's (a one-rank gloo group) under the same bit flips and wire
    corruption: ``ServeStats.to_dict`` equal after every flush, CTRs
    within 1e-5;
  * on 2 and 4 gloo members (``_torch_resilience_worker.py``, task
    'riders'): the ``xrep`` harvest bit for bit against a host model,
    quarantined rows out of their bags (logits within 1e-5 of JAX's
    ``forward_local`` on the masked batch), a wire flip rejecting exactly
    its segment on the dense and the ragged exchange, and the same
    collective calls with every rider as without;
  * on 4 gloo members (task 'scrub'), the reference's ``tests/test_scrub.py``
    engine gates: the clean path bit-identical, the bit-flip grid detected
    within its window and repaired bit-exact, a wire corruption rejected
    with nothing lost, a persistent one degrading then evicting, the
    mirror off detecting without repairing, a fresher delta winning over
    a repair, no stale cached copy, and survival of an eviction; CTRs
    within 2e-5 of JAX where nothing is quarantined.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_worker import flatten, run_members
from _torch_resilience_worker import (B, COLLECTIVES, FLIP_CELLS, P_CFG,
                                      PIPES, STATS)
from repro.configs.base import DLRMConfig as JConfig
from repro.core import alltoallv as ja2a
from repro.core import integrity as jinteg
from repro.data import synthetic as jsyn
from repro.models import dlrm as jdlrm
from repro.runtime import elastic as jelastic
from repro.runtime import faults as jfaults
from repro.runtime import scrub as jscrub
from repro.serving import engine as jengine
from repro.serving import hot_cache as jhc
from repro.sharding import partition
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import alltoallv as ta2a
from repro_torch.core import integrity as tinteg
from repro_torch.launch import mesh
from repro_torch.models import dlrm as tdlrm
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import scrub as tscrub
from repro_torch.serving import hot_cache as thc
from repro_torch.serving.engine import DLRMEngine, ServeStats
from test_torch_reshard import jax_ctr_logits, rider_inputs

WORKER = Path(__file__).with_name("_torch_resilience_worker.py")
CHAOS_TOL = 2e-5
LOGIT_TOL = {"rtol": 1e-5, "atol": 1e-5}
TIMING = {"total_s", "throughput_rps", "recovery_s"}


# ---------------------------------------------------------------------------
# the folds
# ---------------------------------------------------------------------------


def test_fold_is_pinned():
    """The reference's hard-coded words: a changed weight schedule, mixing
    constant or wrap would break every stamp on the wire."""
    vec = torch.arange(8, dtype=torch.float32)[None]
    assert int(tinteg.row_checksum_device(vec, 0, 0)[0]) == 29048
    assert int(tinteg.row_checksum_device(vec, 123, 7)[0]) == 1479294494
    z = torch.zeros(1, 4)
    assert int(tinteg.row_checksum_device(z, 1, 0)[0]) == 2654435761
    assert int(tinteg.row_checksum(vec.numpy()[0], 123, 7)) == 1479294494


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_device_fold_equals_host_and_jax(dtype):
    rng = np.random.default_rng(7)
    f32 = rng.standard_normal((6, 8)).astype(np.float32)
    jv = jnp.asarray(f32).astype(dtype)
    tv = torch.from_numpy(f32).to(getattr(torch, dtype))
    gids = np.arange(6) * 13 + 2
    host = jinteg.row_checksum(np.asarray(jv), gids, 3)
    dev = np.asarray(jinteg.row_checksum_device(
        jv, jnp.asarray(gids, jnp.int32), jnp.int32(3)))
    got = tinteg.row_checksum_device(tv, torch.from_numpy(gids), 3)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(got.numpy(), dev)


def test_single_bit_flip_moves_exactly_one_block():
    rng = np.random.default_rng(4)
    tables = rng.standard_normal((2, 16, 4)).astype(np.float32)
    _, led = tinteg.device_ledger(torch.from_numpy(tables), 4)
    for byte in range(16):
        for bit in (0, 3, 7):
            mut = tables.copy()
            mut[1, 9].view(np.uint8)[byte] ^= np.uint8(1 << bit)
            _, got = tinteg.device_ledger(torch.from_numpy(mut), 4)
            diff = led.block_cs != got.block_cs
            assert diff.sum() == 1 and diff[1, 9 // 4], (byte, bit)


def test_padding_rows_fold_to_zero_and_ledger_matches_reference():
    """A ledger over (t_pad, R) with R not a block multiple: the last
    block covers the real rows only, the audit's padding offsets fold to
    0, and the ledger built on the device (also read through a placement)
    equals the reference's ``from_tables`` word for word."""
    tables = np.ones((1, 10, 4), np.float32)
    shadow, led = tinteg.device_ledger(torch.from_numpy(tables), 4)
    assert led.n_blocks == 3
    rcs = tinteg.row_checksum(tables[0, 8:10], np.arange(8, 10), 0)
    assert int(led.block_cs[0, 2]) == int(rcs.astype(np.uint64).sum()
                                          % (1 << 32))
    words = tinteg.fold_rows(torch.from_numpy(tables), [0], [[8, 9, 10, 11]],
                             [0]).numpy()
    assert words[0, 2:].tolist() == [0, 0]
    rng = np.random.default_rng(2)
    stack = rng.standard_normal((5, 23, 8)).astype(np.float32)
    want = jinteg.IntegrityLedger.from_tables(stack, 4)
    shadow, got = tinteg.device_ledger(torch.from_numpy(stack), 4)
    np.testing.assert_array_equal(got.block_cs, want.block_cs)
    assert (got.block_rows, got.n_rows) == (want.block_rows, want.n_rows)
    gids = np.arange(5)[:, None] * 23 + np.arange(23)[None]
    np.testing.assert_array_equal(shadow,
                                  jinteg.row_checksum(stack, gids, 0))
    perm = np.array([3, 0, 4, 1, 2])
    inv = np.argsort(perm)
    _, placed = tinteg.device_ledger(torch.from_numpy(stack[perm]), 4,
                                     inv=inv)
    np.testing.assert_array_equal(placed.block_cs, want.block_cs)
    host = tinteg.IntegrityLedger.from_tables(stack, 4)
    np.testing.assert_array_equal(host.block_cs, want.block_cs)


def test_note_update_matches_full_recompute():
    rng = np.random.default_rng(3)
    tables = rng.standard_normal((4, 20, 8)).astype(np.float32)
    led = tinteg.IntegrityLedger.from_tables(tables, block_rows=8)
    ref = jinteg.IntegrityLedger.from_tables(tables.copy(), block_rows=8)
    for gid in (0, 19, 21, 45, 79):
        t, r = divmod(gid, 20)
        new = rng.standard_normal(8).astype(np.float32)
        led.note_update(gid, tables[t, r], new)
        ref.note_update(gid, tables[t, r], new)
        tables[t, r] = new
    want = tinteg.IntegrityLedger.from_tables(tables, block_rows=8)
    np.testing.assert_array_equal(led.block_cs, want.block_cs)
    np.testing.assert_array_equal(led.block_cs, ref.block_cs)
    assert led.block_of(45) == ref.block_of(45)
    np.testing.assert_array_equal(led.expected([1, 3], [0, 2]),
                                  ref.expected([1, 3], [0, 2]))
    np.testing.assert_array_equal(led.refit(tables).block_cs,
                                  want.block_cs)


def test_audit_folds_match_reference():
    rng = np.random.default_rng(0)
    tab = rng.standard_normal((3, 10, 8)).astype(np.float32)
    phys, orig = np.array([2, 0, 1]), np.array([1, 2, 0])
    offs = np.array([[0, 1, 2, 3], [8, 9, 10, 11], [4, 5, 6, 7]])
    tt, jt = torch.from_numpy(tab), jnp.asarray(tab)
    np.testing.assert_array_equal(
        tinteg.fold_rows(tt, phys, offs, orig).numpy(),
        np.asarray(jinteg.fold_rows(jt, phys, offs, orig)))
    np.testing.assert_array_equal(
        tinteg.fold_blocks(tt, phys, offs, orig).numpy(),
        np.asarray(jinteg.fold_blocks(jt, phys, offs, orig)))
    counts = rng.integers(0, 50, (3, 10)).astype(np.float64)
    jc = jhc.build(jt, counts, 4)
    tc = thc.build(tt.clone(), counts, 4)
    tc.hot_rows[1, 2].view(torch.uint8)[5] ^= 1       # one drifted copy
    jrows = jc.hot_rows.at[1, 2].set(jnp.asarray(tc.hot_rows[1, 2].numpy()))
    t_sel, c_sel = np.repeat(np.arange(3), 4), np.tile(np.arange(4), 3)
    jids, jok = jinteg.fold_cache_slots(jrows, jc.hot_ids, jt, t_sel, c_sel)
    tids, tok = tinteg.fold_cache_slots(tc.hot_rows, tc.hot_ids, tt, t_sel,
                                        c_sel)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert (~tok).sum() == 1


def _wire_layouts():
    return (ta2a.wire_layout(3, {"emb": ((24,), torch.uint8),
                                 "wcs": ((1,), torch.uint32)}),
            ja2a.wire_layout(3, {"emb": ((24,), jnp.uint8),
                                 "wcs": ((1,), jnp.uint32)}))


def test_wire_stamp_matches_reference_and_every_flip_rejects():
    tl, jl = _wire_layouts()
    rng = np.random.default_rng(5)
    buf = rng.integers(0, 256, (3, tl.slot_bytes)).astype(np.uint8)
    stamped = tinteg.wire_stamp(torch.from_numpy(buf.copy()), tl)
    np.testing.assert_array_equal(
        stamped.numpy(), np.asarray(jinteg.wire_stamp(jnp.asarray(buf), jl)))
    assert tinteg.wire_verify(stamped, tl).all()
    off = tl.field("wcs").offset
    for i in range(tl.slot_bytes):
        if off <= i < off + 4:
            continue
        mut = stamped.clone()
        mut[1, i] ^= 1
        ok = tinteg.wire_verify(mut, tl)
        assert ok.tolist() == [True, False, True], i
        assert ok.tolist() == np.asarray(jinteg.wire_verify(
            jnp.asarray(mut.numpy()), jl)).tolist()
        assert not bool(tinteg.wire_verify(mut[1], tl))
    # stamping twice is a fixpoint: the stamp's own bytes weigh nothing
    again = tinteg.wire_stamp(stamped.clone(), tl)
    assert torch.equal(again, stamped)


# ---------------------------------------------------------------------------
# both scrubbers over a stub engine
# ---------------------------------------------------------------------------


class StubEngine:
    """What a ``Scrubber`` reads and writes of ``DLRMEngine``."""

    def __init__(self, tables, p, mb, cache=None):
        self.params = {"tables": tables}
        self._p, self.microbatches = p, mb
        self.cache = cache
        self.pmap = None
        self.reshard = None
        self._staged_plan = None

    def _exchange_geometry(self):
        return self._p, self.params["tables"].shape[0], 1, 1


def rep_route(wire, p, t_loc, r, corrupt=()):
    """Host model of the xrep rider: each slice's rows delivered to the
    member owning their table, in slice order, the checksums verbatim;
    ``corrupt`` (src, j, i) rows flip a byte on the way."""
    mb, cap = wire["rgid"].shape[1:]
    out = {k: np.zeros((p, mb, p) + v.shape[2:], v.dtype)
           for k, v in wire.items()}
    for m in range(p):
        for j in range(mb):
            n = int(wire["rcnt"][m, j, 0])
            vec = wire["rvec"][m, j, :n].copy()
            for i in range(n):
                if (m, j, i) in corrupt:
                    vec[i].view(np.uint8)[0] ^= 1
            dest = wire["rgid"][m, j, :n].astype(np.int64) // r // t_loc
            for q in range(p):
                sel = np.flatnonzero(dest == q)
                out["rcnt"][q, j, m, 0] = len(sel)
                out["rvec"][q, j, m, :len(sel)] = vec[sel]
                for k in ("rgid", "rcs"):
                    out[k][q, j, m, :len(sel)] = wire[k][m, j, sel]
    return out


def _scrub_state(sc):
    return (sorted(sc.quarantined), sorted(sc._repairq),
            sorted(sc._inflight), sorted(sc._banked),
            sorted(g for g, _ in sc._apply_buf), sc._cursor,
            sc._slot_cursor, sc.blocks_scrubbed, sc.detections,
            sc.repaired_rows, sc.repair_rejects, sc.reships,
            sc.cache_invalidations, sc.fully_repaired)


def _flip(eng, t, row, byte, cache=False):
    """One flipped bit in the stub's table row (or its cached copy)."""
    if isinstance(eng.params["tables"], torch.Tensor):
        if cache:
            slot = int(eng.cache.slot_of[t, row])
            eng.cache.hot_rows[t, slot].view(torch.uint8)[byte] ^= 4
            eng.cache = thc.HotCache(eng.cache.hot_ids, eng.cache.hot_rows,
                                     eng.cache.slot_of)
        else:
            eng.params["tables"][t, row].view(torch.uint8)[byte] ^= 4
        return
    if cache:
        c = eng.cache
        slot = int(np.asarray(c.slot_of)[t, row])
        v = np.asarray(c.hot_rows[t, slot]).copy()
        v.view(np.uint8)[byte] ^= 4
        eng.cache = jhc.HotCache(c.hot_ids, c.hot_rows.at[t, slot].set(v),
                                 c.slot_of)
    else:
        v = np.asarray(eng.params["tables"][t, row]).copy()
        v.view(np.uint8)[byte] ^= 4
        eng.params["tables"] = eng.params["tables"].at[t, row].set(v)


@pytest.mark.parametrize("case", ["table", "cache", "mirror_off"])
def test_scrubber_matches_reference_over_stub_engine(case):
    """Step by step, both scrubbers on the same stack, flips and harvests:
    the audits' detections, the quarantine vectors, the repair wire
    leaves, the verification (a row corrupted on the wire is rejected and
    shipped again), the quarantined-bag counts, the repaired tables (and
    cache), a delta's interplay, every counter."""
    p, mb, r, s = 2, 2, 20, 4
    rng = np.random.default_rng(8)
    base = rng.standard_normal((4, r, s)).astype(np.float32)
    jc = tc = None
    if case == "cache":
        counts = rng.integers(0, 5, (4, r)).astype(np.float64)
        jc = jhc.build(jnp.asarray(base), counts, 5)
        tc = thc.build(torch.from_numpy(base.copy()), counts, 5)
    jeng = StubEngine(jnp.asarray(base), p, mb, jc)
    teng = StubEngine(torch.from_numpy(base.copy()), p, mb, tc)
    kw = dict(budget=3, block_rows=4, slice_cap=2, quarantine_cap=8,
              mirror=case != "mirror_off")
    js, ts = jscrub.Scrubber(jeng, **kw), tscrub.Scrubber(teng, **kw)
    np.testing.assert_array_equal(ts.row_cs, js.row_cs)
    np.testing.assert_array_equal(ts.ledger.block_cs, js.ledger.block_cs)
    flips = {1: [(0, 5, 3), (2, 17, 1)], 4: [(3, 2, 0), (1, 9, 2)]}
    cached = None
    if case == "cache":
        ids = np.asarray(jc.hot_ids)
        cached = (2, int(ids[2, 1]))
    tcfg = DLRMConfig("t", table_sizes=(20, 20, 20, 20), embed_dim=s,
                      max_hot=3)
    for step in range(30):
        for eng in (jeng, teng):
            for t, row, byte in flips.get(step, ()):
                _flip(eng, t, row, byte)
            if cached is not None and step == 2:
                _flip(eng, *cached, 1, cache=True)
        if step == 9:
            # a delta lands on a quarantined row: it is the repair
            g = sorted(ts.quarantined)[0] if ts.quarantined else 5
            vec = np.full(s, 3.0, np.float32)
            for sc, eng in ((js, jeng), (ts, teng)):
                sc.note_applied(g, vec, np.dtype(np.float32))
            base_row = (g // r, g % r)
            jeng.params["tables"] = jeng.params["tables"].at[
                base_row].set(vec)
            teng.params["tables"][base_row] = torch.from_numpy(vec)
        js.apply(jeng, step)
        ts.apply(teng, step)
        assert ts.audit(teng, step) == js.audit(jeng, step), step
        # one process: the gathered audit words are its own
        ts.bank_audit(ts.audit_words[None])
        np.testing.assert_array_equal(ts.quarantine_phys(teng),
                                      js.quarantine_phys(jeng))
        b = jsyn.make_batch(tcfg, 16, mode="powerlaw_hetero", seed=step)
        assert ts.count_quarantined_served(
            teng, torch.from_numpy(b.idx), torch.from_numpy(b.mask)) == \
            js.count_quarantined_served(jeng, b.idx, b.mask), step
        jw, tw = js.next_wire(jeng, step), ts.next_wire(teng, step)
        assert list(jw) == list(tw)
        for k in jw:
            assert tw[k].dtype == jw[k].dtype, k
            np.testing.assert_array_equal(tw[k], jw[k], err_msg=(step, k))
        # the first repair row on the wire arrives corrupted
        corrupt = ()
        if jw["rcnt"].any() and not getattr(ts, "_seen_rep", False):
            ts._seen_rep = True
            m0, j0 = np.argwhere(jw["rcnt"][..., 0] > 0)[0]
            corrupt = {(int(m0), int(j0), 0)}
        staged = rep_route(jw, p, 2, r, corrupt)
        js.ingest({k: jnp.asarray(v) for k, v in staged.items()}, jeng, step)
        ts.ingest({k: torch.from_numpy(v.copy()) for k, v in
                   staged.items()}, teng, step)
        assert _scrub_state(ts) == _scrub_state(js), step
        np.testing.assert_array_equal(teng.params["tables"].numpy(),
                                      np.asarray(jeng.params["tables"]))
        if case == "cache":
            np.testing.assert_array_equal(teng.cache.hot_rows.numpy(),
                                          np.asarray(jeng.cache.hot_rows))
    if case == "mirror_off":
        assert ts.quarantined and ts.repaired_rows == 0
    else:
        assert ts.fully_repaired and ts.repaired_rows >= 3
        assert ts.repair_rejects >= 1
    if case == "cache":
        assert ts.cache_invalidations >= 1
    for bad in ({"budget": 0}, {"block_rows": 0}, {"slice_cap": 0},
                {"quarantine_cap": 0}):
        with pytest.raises(ValueError):
            tscrub.Scrubber(teng, **dict(kw, **bad))
    ts.quarantined = set(range(9))
    with pytest.raises(RuntimeError, match="overflow"):
        ts.quarantine_phys(teng)


def test_audit_reporting_more_mismatches_than_it_can_carry_raises():
    """One member's audit carries at most ``2 x quarantine_cap + 2``
    mismatches on the all-gather; more in one flush (corruption the
    quarantine could not hold either) raises at the harvest rather than
    leaving rows unaccounted for.  Up to that many are all reported."""
    r, s = 16, 4
    base = np.random.default_rng(3).standard_normal((2, r, s)) \
        .astype(np.float32)
    for n_bad, raises in ((4, False), (5, True)):
        eng = StubEngine(torch.from_numpy(base.copy()), 1, 1)
        sc = tscrub.Scrubber(eng, budget=8, block_rows=4, quarantine_cap=1)
        assert sc.mismatch_cap == 4
        for row in range(n_bad):
            _flip(eng, 0, row, 0)
        sc.audit(eng, 0)
        sc.bank_audit(sc.audit_words[None])
        if raises:
            with pytest.raises(RuntimeError, match="mismatches"):
                sc.audit(eng, 1)
        else:
            assert sc.audit(eng, 1) == list(range(n_bad))


# ---------------------------------------------------------------------------
# P = 1: both engines under the same corruption
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank(tmp_path):
    mesh.init_model_group("gloo", 1, 0, f"file://{tmp_path / 'store'}")
    try:
        yield
    finally:
        mesh.destroy_model_group()


@pytest.mark.parametrize("cached", [False, True])
def test_engine_at_one_member_matches_reference(one_rank, cached):
    """Resident-row flips, a cached-copy flip and a corrupted segment on
    the self link: after every flush the port's ``ServeStats.to_dict``
    equals the reference's (timings aside) and the CTRs agree within
    1e-5; the stack ends bit-identical to the clean one."""
    kw = dict(P_CFG, max_hot=4)
    jcfg, tcfg = JConfig("t", **kw), DLRMConfig("t", **kw)
    jp = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=1)
    npp = jax.tree.map(np.asarray, jp)
    tp = tdlrm.params_from_jax(npp, "cpu")
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
    jmesh = jelastic.make_mesh_from(jax.devices()[:1], model=1)
    jo, to = [], []
    with partition.axis_rules(jmesh):
        if cached:
            for eng in (jeng, teng):
                eng.calibrate_cache(batches[0].idx, batches[0].mask,
                                    cache_rows=8)
        for b in batches:
            for r in range(B):
                o = jeng.submit(b.dense[r], b.idx[r], b.mask[r])
                if o is not None:
                    jo.append(np.asarray(o))
                o = teng.submit(b.dense[r], b.idx[r], b.mask[r])
                if o is not None:
                    to.append(o)
            jd, td = jeng.stats.to_dict(), teng.stats.to_dict()
            assert set(jd) == set(td)
            for k in set(jd) - TIMING:
                assert td[k] == jd[k], (len(to), k, td[k], jd[k])
    np.testing.assert_allclose(np.concatenate(to), np.concatenate(jo),
                               **LOGIT_TOL)
    st = teng.stats
    assert st.detections >= 2 + cached and st.repaired_rows >= 2
    assert st.wire_rejects == 2 and teng.scrub.fully_repaired
    for t, n in enumerate(kw["table_sizes"]):
        assert torch.equal(teng.params["tables"][t, :n], clean[t, :n])


def test_serve_stats_round_trip_and_reference_fields():
    """``ServeStats.to_dict`` has exactly the reference's fields (the
    placement and scrub counters included) and round-trips through JSON."""
    st = ServeStats()
    st.requests, st.blocks_scrubbed, st.detections = 7, 40, 3
    st.repaired_rows, st.quarantined_served, st.wire_rejects = 2, 5, 1
    st.detection_lag_flushes = 4
    st.member_rows = [1.0, 2.0]
    d = st.to_dict()
    assert set(d) == set(jengine.ServeStats().to_dict())
    back = json.loads(json.dumps(d))
    assert back == d
    assert (back["blocks_scrubbed"], back["detections"],
            back["repaired_rows"], back["quarantined_served"],
            back["wire_rejects"], back["detection_lag_flushes"]) == \
        (40, 3, 2, 5, 1, 4)


# ---------------------------------------------------------------------------
# 2 and 4 gloo members: the forward's riders
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[2, 4])
def riders(request, tmp_path_factory):
    p = request.param
    params, b, inputs = rider_inputs(p, seed=1)
    outs = run_members(WORKER, p, inputs,
                       tmp_path_factory.mktemp(f"scrub_riders{p}"))
    return p, params, b, inputs, outs


@pytest.mark.parametrize("pipe", PIPES)
def test_repair_rider_harvest_and_quarantine(riders, pipe):
    """Every member's ``xrep`` harvest is the host model's bit for bit
    (each mirror row delivered to the owner of its table, the stamps
    verbatim); a quarantine vector takes exactly its rows out of their
    bags (logits within 1e-5 of JAX's ``forward_local`` on the batch with
    those ids masked); every rider armed leaves no segment flagged."""
    p, params, b, inputs, outs = riders
    r = np.asarray(params["tables"]).shape[1]
    t_loc = jdlrm.padded_tables(JConfig("t", **P_CFG), p) // p
    wire = {k.split("/")[1]: v for k, v in inputs.items()
            if k.startswith("rep/")}
    want = rep_route(wire, p, t_loc, r)
    t_pad = b.idx.shape[1]
    gid = np.arange(t_pad)[None, :, None] * r + b.idx.astype(np.int64)
    masked = b.mask * ~np.isin(gid, inputs["quar"])
    assert (masked != b.mask).any()
    cfg = JConfig("t", **P_CFG)
    quar = jax_ctr_logits(params, cfg, b.dense, b.idx, masked)
    for out in outs:
        for k, v in want.items():
            got = out[f"{pipe}/xrep/{k}"]
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)
        np.testing.assert_allclose(out[f"{pipe}/quar/logits"], quar,
                                   **LOGIT_TOL)
        assert not out[f"{pipe}/armed/wbad"].any()
        assert out[f"{pipe}/armed/wbad"].shape == (p, 2, p)


@pytest.mark.parametrize("ex", ["dense", "ragged"])
@pytest.mark.parametrize("pipe", PIPES)
def test_wire_flip_rejects_exactly_its_segment(riders, pipe, ex):
    """A flipped byte on the link 1 -> 0: member 0 flags source 1 in both
    microbatches and nothing else; only member 0's slice of the batch
    moves (source 1's tables zeroed), every other logit is the clean
    one, all finite; the ragged exchange's counts are zeroed with it."""
    p, _, _, _, outs = riders
    tag = "flip" if ex == "dense" else "flip_ragged"
    want = np.zeros((p, 2, p), np.int32)
    want[0, :, 1] = 1
    bs = B // (2 * p)
    for out in outs:
        np.testing.assert_array_equal(out[f"{pipe}/{tag}/wbad"], want)
        lg = out[f"{pipe}/{tag}/logits"].reshape(2, p, bs)
        clean = out[f"{pipe}/plain/logits"].reshape(2, p, bs)
        assert np.isfinite(lg).all()
        np.testing.assert_array_equal(lg[:, 1:], clean[:, 1:])
        assert (lg[:, 0] != clean[:, 0]).any()


@pytest.mark.parametrize("pipe", PIPES)
def test_scrub_riders_add_no_collective(riders, pipe):
    """The repair rider, the wire checksum, the quarantine mask, the
    flip hook and the audit words ride the same buffer: the same calls of
    each collective with all of them armed as without, and every member
    gets every member's audit words."""
    p, _, _, _, outs = riders
    words = np.stack([np.arange(7, dtype=np.int32) * 3 - 100 * m
                      for m in range(p)])
    for out in outs:
        np.testing.assert_array_equal(out[f"{pipe}/armed/counts"],
                                      out[f"{pipe}/plain/counts"])
        # the audit words come back from every member
        np.testing.assert_array_equal(out[f"{pipe}/armed/audit"], words)
        assert dict(zip(COLLECTIVES, out[f"{pipe}/armed/counts"]))[
            "all_gather"] == 1


# ---------------------------------------------------------------------------
# 4 gloo members: the reference's engine gates
# ---------------------------------------------------------------------------

P = 4


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    jcfg = JConfig("t", **P_CFG)
    t_pad = jdlrm.padded_tables(jcfg, P)
    params = jdlrm.init_dlrm(jax.random.PRNGKey(0), jcfg, n_shards=P)
    inputs = {"task": np.array("scrub")}
    flatten("p", params, inputs)
    batches = [jsyn.make_batch(jcfg, B, mode="powerlaw", t_pad=t_pad,
                               seed=9, step=s) for s in range(12)]
    for s, b in enumerate(batches):
        for k in ("dense", "idx", "mask"):
            inputs[f"b{s}/{k}"] = getattr(b, k)
    # a row every one of the first 6 batches touches (the mirror-off gate
    # must count quarantined serves)
    hot = next((t, r0) for t in range(6)
               for r0 in range(jcfg.table_sizes[t])
               if all(((b.idx[:, t] == r0) & (b.mask[:, t] > 0)).any()
                      for b in batches[:6]))
    inputs["hot"] = np.array(hot)
    outs = run_members(WORKER, P, inputs, tmp_path_factory.mktemp("scrub4"),
                       timeout=600)
    ctr = np.concatenate([
        1 / (1 + np.exp(-jax_ctr_logits(params, jcfg, b.dense, b.idx,
                                         b.mask))) for b in batches])
    return ctr, outs


def _stats(out, tag):
    return dict(zip(STATS, out[f"{tag}/stats"].tolist()))


def _want(ctr, n):
    return np.concatenate([ctr] * (n // 12 + 1))[:n * B]


def test_clean_path_bit_exact_with_scrub_armed(members):
    ctr, outs = members
    for out in outs:
        np.testing.assert_array_equal(out["clean/ctr"], out["clean/plain"])
        assert np.abs(out["clean/ctr"] - _want(ctr, 6)).max() < CHAOS_TOL
        st = _stats(out, "clean")
        assert st["blocks_scrubbed"] > 0
        assert st["detections"] == st["wire_rejects"] == 0
        assert st["repaired_rows"] == st["quarantined_served"] == 0
        assert bool(out["clean/tables_ok"])


@pytest.mark.parametrize("pipe,wire,target", FLIP_CELLS)
def test_bitflip_grid_detected_and_repaired_bit_exact(members, pipe, wire,
                                                      target):
    """A resident-row flip and a cached-copy flip on each pipeline and
    wire: detected within the scrub window (budget 8: 8 tables x 3 blocks
    = 3 flushes, 8 x 8 slots = 8 flushes, plus the harvest's flush),
    resident flips repaired bit-exact, the cached copy invalidated, no
    request lost, every member the same ledger."""
    _, outs = members
    tag = f"flip/{pipe}/{wire}/{target}"
    for out in outs:
        st = _stats(out, tag)
        assert int(out[f"{tag}/answered"]) == 14
        assert st["detections"] >= 1 and bool(out[f"{tag}/finite"])
        assert st["detection_lag_flushes"] <= (4 if target == "table"
                                               else 9)
        assert bool(out[f"{tag}/tables_ok"])
        if target == "table":
            assert st["repaired_rows"] >= 1 and bool(out[f"{tag}/repaired"])
        else:
            assert int(out[f"{tag}/invalidations"]) >= 1
            assert int(out[f"{tag}/slot"]) == -1
        np.testing.assert_array_equal(out[f"{tag}/stats"],
                                      outs[0][f"{tag}/stats"])


@pytest.mark.parametrize("pipe", PIPES)
def test_wire_corruption_rejected_and_reshipped_zero_lost(members, pipe):
    _, outs = members
    tag = f"wire/{pipe}"
    for out in outs:
        st = _stats(out, tag)
        assert int(out[f"{tag}/answered"]) == 14
        assert st["wire_rejects"] >= 1 and bool(out[f"{tag}/finite"])
        assert st["repaired_rows"] >= 1 and bool(out[f"{tag}/tables_ok"])


def test_persistent_wire_corruption_escalates_degrade_then_evict(members):
    """Link 2 -> 0 corrupt every flush: source 2 is degraded after two
    flushes of rejects, then evicted; every request is answered."""
    _, outs = members
    assert bool(outs[2]["persist/evicted"])
    for m in (0, 1, 3):
        out = outs[m]
        st = _stats(out, "persist")
        assert int(out["persist/answered"]) == 16
        assert st["wire_rejects"] >= 4 and st["evictions"] >= 1
        assert st["members"] == 3 and bool(out["persist/finite"])


def test_mirror_disabled_detects_and_quarantines_but_cannot_repair(members):
    _, outs = members
    for out in outs:
        st = _stats(out, "mirror_off")
        assert int(out["mirror_off/answered"]) == 12
        assert st["detections"] >= 1 and st["repaired_rows"] == 0
        assert int(out["mirror_off/quarantined"]) == 1
        assert st["quarantined_served"] > 0
        assert bool(out["mirror_off/finite"])
        # the corruption stays in the copy it hit, and only there
        holder = int(out["mirror_off/holder"])
        assert bool(out["mirror_off/tables_ok"]) == (out is not outs[holder])
        np.testing.assert_array_equal(out["mirror_off/stats"],
                                      outs[0]["mirror_off/stats"])


def test_repair_never_resurrects_a_fresher_delta(members):
    _, outs = members
    for out in outs:
        assert bool(out["delta/committed"]) and bool(out["delta/repaired"])
        assert bool(out["delta/oracle_ok"])


def test_repaired_base_row_leaves_no_stale_cache_copy(members):
    _, outs = members
    for out in outs:
        st = _stats(out, "coherent")
        assert int(out["coherent/answered"]) == 14
        assert st["repaired_rows"] >= 1 and bool(out["coherent/repaired"])
        assert bool(out["coherent/tables_ok"])
        assert bool(out["coherent/fresh"])


def test_scrub_survives_eviction_and_keeps_repairing(members):
    ctr, outs = members
    assert bool(outs[3]["evict/evicted"])
    for m in (0, 1, 2):
        out = outs[m]
        st = _stats(out, "evict")
        assert st["evictions"] == 1 and st["members"] == 3
        assert int(out["evict/answered"]) == 14
        assert st["repaired_rows"] >= 1 and bool(out["evict/repaired"])
        assert bool(out["evict/tables_ok"])


@pytest.mark.parametrize("case", ["owner", "other"])
def test_one_copy_flip_detected_by_its_holder_and_repaired(members, case):
    """Silent corruption in ONE process's copy of table 2, the one that
    serves it ('owner') or one that does not ('other'): only the holder's
    audit can see it, its mismatch words ride the all-gather, and every
    member detects, quarantines, repairs and counts alike; afterwards
    every copy equals the original and the CTRs are bit-identical to an
    engine that never saw the flip.  A copy nobody serves never reaches a
    CTR before its quarantine."""
    _, outs = members
    tag = f"single/{case}"
    plain = outs[0]["single/plain"]
    for out in outs:
        st = _stats(out, tag)
        assert int(out[f"{tag}/answered"]) == 14
        assert bool(out[f"{tag}/finite"])
        assert st["detections"] == 1 and st["repaired_rows"] == 1
        assert bool(out[f"{tag}/repaired"]) and bool(out[f"{tag}/tables_ok"])
        np.testing.assert_array_equal(out[f"{tag}/stats"],
                                      outs[0][f"{tag}/stats"])
        # flipped at flush 2, detected lag flushes later; the repair is
        # shipped that flush, verified the next, committed the one after
        found = 2 + st["detection_lag_flushes"]
        settled = found + 2
        assert settled < 14
        np.testing.assert_array_equal(out[f"{tag}/ctr"][settled * B:],
                                      plain[settled * B:])
        if case == "other":
            np.testing.assert_array_equal(out[f"{tag}/ctr"][:found * B],
                                          plain[:found * B])
