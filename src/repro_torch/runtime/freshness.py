"""Online embedding freshness (the port of ``repro/runtime/freshness.py``):
versioned row deltas over the BLS exchange with bounded staleness, an
atomic apply between flushes and rollback on a crash.

Serving absorbs embedding-row updates from a continuously training model
without draining.  As a member may consume an exchange up to k iterations
late, it may serve rows up to ``k_fresh`` versions stale, and the fastest
updater blocks when a member falls ``k_fresh`` versions behind.

  * An update source (``data.synthetic.delta_stream``) emits
    ``DeltaBatch`` objects of monotone versions.  ``FreshnessManager``
    pulls from it through the staleness gate: version v enters only while
    ``v − min_m applied[m] ≤ k_fresh``.
  * The rows ride the exchange the embeddings ride: the ``"xdelta"`` field
    of the fused wire, packed by owning member inside stage_a
    (``models/dlrm.py``), so they cost no collective.
  * Every row carries a checksum stamped at the source
    (``core/integrity.row_checksum``); the receiving host verifies the
    bytes that arrived and ships a corrupted row again instead of applying
    it.
  * Verified rows commit between flushes.  The port writes them IN PLACE
    (the reference scatters into a copy of the whole stack, 7.33 GB at
    full ``dlrm-kaggle`` width): it saves the rows it is about to
    overwrite, writes the table and the hot cache's copies, then calls the
    injector's mid-apply crash point; a crash there writes the saved rows
    back, so the tables and the cache are bit-identical to their state
    before the apply, and the rows stay buffered for the replay.  The
    window runs on the compute stream between synchronous flushes
    (``plan_pipeline`` is refused with freshness), so no forward sees a
    half-applied state.
  * Each member process runs the same manager on the same harvest (the
    forward hands every member the whole group's), so every decision and
    counter is the same on all of them and equal to the reference's.
  * Under a table placement (``runtime/reshard.py``) rows route to their
    table's CURRENT owner and are written to its physical slot; every
    committed row is reported to a live reshard (``note_applied``: a
    banked copy is patched, an in-flight one re-ships) and to the
    scrubber, whose mirror and ledger follow every authorized write.

Degraded members and updater stragglers keep serving their last-good
version: their rows stay buffered and their lag holds the gate.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.integrity import row_checksum
from repro_torch.runtime.elastic import NodeFailure
from repro_torch.serving import hot_cache as hc_mod

def to_host_async(staged: dict, pinned: dict):
    """(host tensors, event or None): a copy of a harvest's leaves that
    does not block.  On the card the leaves go into pinned host buffers
    kept in ``pinned`` (reused while their shape holds) behind an event
    the reader synchronizes on; on the CPU they are copied as they are.
    The delta, migration and repair harvests all bank this way."""
    if next(iter(staged.values())).device.type != "cuda":
        return {k: v.cpu() for k, v in staged.items()}, None
    host = {}
    for k, v in staged.items():
        buf = pinned.get(k)
        if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
            buf = pinned[k] = torch.empty(v.shape, dtype=v.dtype,
                                          pin_memory=True)
        buf.copy_(v, non_blocking=True)
        host[k] = buf
    done = torch.cuda.Event()
    done.record()
    return host, done


@dataclasses.dataclass
class VersionLedger:
    """Per-member committed versions.  ``applied[m]`` is the highest
    version v such that member m's shard holds every row of every version
    <= v (0 is the base tables); ``shipped_max`` the highest version that
    entered the wire.  The invariant: ``versions_behind = shipped_max −
    min(applied) <= k_fresh``."""
    k_fresh: int
    applied: np.ndarray          # (P,) int64 committed version per member
    shipped_max: int = 0

    @property
    def min_applied(self) -> int:
        return int(self.applied.min()) if self.applied.size else 0

    @property
    def versions_behind(self) -> int:
        return max(0, self.shipped_max - self.min_applied)

    def may_ship(self, version: int) -> bool:
        """The staleness gate: the fastest updater blocks."""
        return version - self.min_applied <= self.k_fresh


class FreshnessManager:
    """Host half of the delta path: pulls versions through the staleness
    gate, fills the (member, microbatch) wire slices ``DLRMEngine`` hands
    the forward, verifies and buffers what each member harvests, and runs
    the atomic apply between flushes.

    ``slice_cap`` is the rows a slice holds (the delta sub-wire's bucket
    cap, so the in-forward repack never drops); ``versions_per_flush`` the
    pull rate, scaled by the fault plan's ``update_factor``.

    A row's states, all on the host: ``_sendq`` (admitted, waiting for wire
    room) -> ``_inflight`` (on the wire this flush) -> ``_banked``
    (harvested, verified at the next flush) -> ``_apply_buf`` (verified,
    waiting for its owner's apply window) -> committed (a fully committed
    version is dropped).  ``on_evict`` returns every uncommitted row to
    ``_sendq``: owners follow the geometry at the next ship.

    ``apply_trace`` holds (host seconds, start event, end event) of each
    committed apply window; the events are CUDA events on the card, None
    on the CPU."""

    def __init__(self, source: Iterator, *, k_fresh: int = 2,
                 slice_cap: int = 8, versions_per_flush: int = 1):
        if k_fresh < 1:
            raise ValueError(f"k_fresh must be >= 1, got {k_fresh}")
        if slice_cap < 1:
            raise ValueError(f"slice_cap must be >= 1, got {slice_cap}")
        self.source = source
        self.k_fresh = int(k_fresh)
        self.slice_cap = int(slice_cap)
        self.versions_per_flush = int(versions_per_flush)
        self._sendq: list = []       # [(version, gid)] version-sorted
        self._inflight: list = []    # [(version, gid)] on the wire now
        self._banked: list = []      # [(version, gid)] harvested, unverified
        self._apply_buf: list = []   # [(version, gid)] verified, unapplied
        self._remaining: dict = {}   # version -> set(gid) not committed
        self._batches: dict = {}     # version -> (DeltaBatch, {gid: row_i})
        self.latest_pulled = 0
        self.ledger = VersionLedger(self.k_fresh, np.zeros(0, np.int64))
        # -- exact counters (mirrored into ServeStats per flush) -----------
        self.rows_applied = 0        # delta rows committed into the tables
        self.delta_rejects = 0       # checksum-rejected (and re-shipped)
        self.rollbacks = 0           # applies abandoned by a mid-apply crash
        self.applies = 0             # committed apply windows
        self.source_blocked = 0      # pulls refused by the staleness gate
        self.cache_refreshed = 0     # cached rows updated in place
        self.behind_trace: list = []  # versions_behind per verify window
        self.apply_trace: list = []  # (host s, start, end) per commit
        self._held = None            # last flush's harvest, unverified
        self._pinned: dict = {}      # reused host buffers of the harvest

    # -- geometry ----------------------------------------------------------

    def _geometry(self, engine):
        p, t_pad, _, _ = engine._exchange_geometry()
        r = engine.params["tables"].shape[1]
        return p, t_pad // p, r

    @staticmethod
    def _inv_of(engine):
        """The engine's placement inverse (original table -> physical
        slot), or None under the identity boot layout: ownership follows
        the CURRENT placement, so rows route to their owner across a
        cutover."""
        pm = getattr(engine, "pmap", None)
        if pm is None or pm.is_identity:
            return None
        return pm.inv_array()

    @staticmethod
    def _owner(gid: int, t_loc: int, r: int, inv=None) -> int:
        tab = gid // r
        return (int(inv[tab]) if inv is not None else tab) // t_loc

    def _refresh_ledger(self, engine):
        p, t_loc, r = self._geometry(engine)
        inv = self._inv_of(engine)
        applied = np.full(p, self.latest_pulled, np.int64)
        for v, gids in self._remaining.items():
            if not gids:
                continue
            for m in {self._owner(g, t_loc, r, inv) for g in gids}:
                applied[m] = min(applied[m], v - 1)
        self.ledger = VersionLedger(self.k_fresh, applied,
                                    self.ledger.shipped_max)

    @property
    def fully_committed(self) -> bool:
        return not (self._sendq or self._inflight or self._banked
                    or self._apply_buf or self._remaining)

    # -- ship (host -> wire) ----------------------------------------------

    def next_wire(self, engine, step: int) -> dict:
        """This flush's delta wire slices: numpy leaves
        ``dcnt/dcs/dgid/dvec/dver`` shaped ``(P, microbatches, ...)``, one
        single-version slice per (member, microbatch), every row
        checksum-stamped.  New versions are pulled through the staleness
        gate first (scaled by an injected update burst), and the fault
        plan's wire corruption is applied AFTER the stamp, so the
        receiver's verify is what catches it."""
        p, t_loc, r = self._geometry(engine)
        mb = engine.microbatches
        tables = engine.params["tables"]
        s = tables.shape[2]
        if tables.dtype != torch.float32:
            # the bag kernels serve float32 tables (ROADMAP B2)
            raise NotImplementedError(
                f"delta rows for {tables.dtype} tables are not ported")
        emb_dt = np.dtype(np.float32)
        dcap = self.slice_cap
        # a flush that died between ship and ingest left rows marked in
        # flight that never arrived: ship them again
        if self._inflight:
            self._sendq = sorted(set(self._sendq) | set(self._inflight))
            self._inflight = []
        self._refresh_ledger(engine)
        factor = (engine.faults.update_factor(step)
                  if engine.faults is not None else 1.0)
        want = max(0, int(round(self.versions_per_flush * factor)))
        for _ in range(want):
            v = self.latest_pulled + 1
            if not self.ledger.may_ship(v):
                self.source_blocked += 1    # the fastest updater blocks
                break
            try:
                b = next(self.source)
            except StopIteration:
                break
            if b.version != v:
                raise ValueError(
                    f"delta source must be monotone: expected version {v}, "
                    f"got {b.version}")
            gids = (b.tab.astype(np.int64) * r + b.row).astype(np.int64)
            if ((b.tab < 0) | (b.row < 0) | (b.row >= r)
                    | (b.tab >= tables.shape[0])).any():
                raise ValueError(f"delta version {v} holds rows outside the "
                                 f"{tuple(tables.shape[:2])} stack")
            self._batches[v] = (b, {int(g): i for i, g in enumerate(gids)})
            self._remaining[v] = {int(g) for g in gids}
            self._sendq.extend((v, int(g)) for g in gids)
            self.latest_pulled = v
            self._refresh_ledger(engine)
        self._sendq.sort()
        dvec = np.zeros((p, mb, dcap, s), emb_dt)
        dgid = np.zeros((p, mb, dcap), np.int32)
        dcs = np.zeros((p, mb, dcap), np.uint32)
        dcnt = np.zeros((p, mb, 1), np.int32)
        dver = np.zeros((p, mb, 1), np.int32)
        slices = [(m, j) for m in range(p) for j in range(mb)]
        si = 0
        while self._sendq and si < len(slices):
            v0 = self._sendq[0][0]
            take = []
            while self._sendq and self._sendq[0][0] == v0 \
                    and len(take) < dcap:
                take.append(self._sendq.pop(0))
            m, j = slices[si]
            si += 1
            b, gix = self._batches[v0]
            for i, (_, g) in enumerate(take):
                dvec[m, j, i] = np.asarray(b.vec[gix[g]], emb_dt)
                dgid[m, j, i] = g
            n = len(take)
            dcnt[m, j, 0] = n
            dver[m, j, 0] = v0
            dcs[m, j, :n] = row_checksum(dvec[m, j, :n], dgid[m, j, :n], v0)
            self._inflight.extend(take)
            self.ledger.shipped_max = max(self.ledger.shipped_max, v0)
        # wire corruption: byte flips AFTER the stamp
        if engine.faults is not None:
            for pos, n_rows in engine.faults.corrupt_rows(step):
                left = n_rows
                for j in range(mb):
                    c = min(int(dcnt[pos, j, 0]), left)
                    if c > 0:
                        dvec[pos, j, :c].view(np.uint8)[...] ^= 0x55
                        left -= c
                    if left == 0:
                        break
        return {"dcnt": dcnt, "dcs": dcs, "dgid": dgid, "dvec": dvec,
                "dver": dver}

    # -- harvest (wire -> apply buffer) -----------------------------------

    def ingest(self, staged, engine, step: int) -> None:
        """Bank this flush's harvest (the forward's ``staged`` leaves)
        WITHOUT waiting for it: on the card the leaves are copied into
        pinned host buffers behind an event, and the PREVIOUS flush's
        harvest, long since arrived, is verified now."""
        self._process_held(engine)
        self._held = to_host_async(staged, self._pinned)
        self._banked = self._inflight
        self._inflight = []

    def _process_held(self, engine) -> None:
        """Verify the banked harvest.  Leaves are ``(P_dst, mb, P_src,
        ...)``: destination m's buckets from each source.  Verified rows
        move to the apply buffer; a mismatch is rejected and shipped again
        (back onto the send queue)."""
        if self._held is None:
            return
        (host, done), self._held = self._held, None
        if done is not None:
            done.synchronize()
        dd = {k: v.numpy() for k, v in host.items()}
        p_dst, mb, p_src = dd["dgid"].shape[:3]
        requeue = []
        # empty slices (a drained stream) cost one sum, not a sweep
        if dd["dcnt"].any():
            for m in range(p_dst):
                for j in range(mb):
                    for q in range(p_src):
                        # clamp: a corrupted slice can carry a garbage
                        # count; never index past the cap
                        c = min(int(dd["dcnt"][m, j, q, 0]),
                                dd["dgid"].shape[3])
                        if c <= 0:
                            continue
                        v = int(dd["dver"][m, j, q, 0])
                        rem = self._remaining.get(v, set())
                        gids = dd["dgid"][m, j, q, :c].astype(np.int64)
                        got = np.asarray(row_checksum(
                            dd["dvec"][m, j, q, :c], gids, np.int64(v)),
                            np.uint32)
                        ok = got == dd["dcs"][m, j, q, :c]
                        for i, g in enumerate(int(x) for x in gids):
                            if g not in rem:
                                continue  # already committed elsewhere
                            if ok[i]:
                                self._apply_buf.append((v, g))
                            else:
                                self.delta_rejects += 1
                                requeue.append((v, g))
        self._banked = []
        if requeue:
            self._sendq = sorted(set(self._sendq) | set(requeue))
        self._refresh_ledger(engine)
        self.behind_trace.append(self.ledger.versions_behind)

    # -- atomic apply (between flushes) -----------------------------------

    def apply(self, engine, step: int) -> None:
        """Commit the buffered rows: write them into the tables and the hot
        cache's copies in place, keeping the overwritten rows, then fire
        the injector's mid-apply crash point.  A crash, or any other error
        inside the window, writes the kept rows back (a crash counts as a
        rollback): the tables and the cache are as before the apply and
        the rows stay buffered for the replay.  Rows owned
        by a degraded member or one under an injected apply stall stay
        buffered; that member serves its last-good version."""
        if not self._apply_buf:
            return
        t_host = time.perf_counter()
        _, t_loc, r = self._geometry(engine)
        inv = self._inv_of(engine)
        skip = {int(d) for d in engine.degraded_members}
        if engine.faults is not None:
            skip |= engine.faults.stalled_positions(step)
        ready, hold = [], []
        for v, g in self._apply_buf:
            (hold if self._owner(g, t_loc, r, inv) in skip
             else ready).append((v, g))
        if not ready:
            self._apply_buf = hold
            return
        # a gid that several buffered versions touch commits once, at the
        # HIGHEST version: the same as applying them in version order
        best: dict = {}
        for v, g in sorted(ready):
            best[g] = v
        gids = np.array(sorted(best), np.int64)
        vecs = np.stack([
            self._batches[best[g]][0].vec[self._batches[best[g]][1][g]]
            for g in gids])
        tab, row = gids // r, gids % r
        if inv is not None:
            # the stack holds physical slots under a placement
            tab = inv[tab].astype(np.int64)
        tables, cache = engine.params["tables"], engine.cache
        dev = tables.device
        events = None
        if dev.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        # two uploads: the (table, row) pairs and the rows
        tr = torch.from_numpy(np.stack([tab, row])).to(dev)
        upd = torch.from_numpy(np.ascontiguousarray(vecs)).to(dev) \
            .to(tables.dtype)
        ti, ri = tr[0], tr[1]        # in range: checked at the pull
        kept = tables[ti, ri]                    # the undo log (a copy)
        refreshed, kept_c = 0, None
        try:
            tables[ti, ri] = upd
            if cache is not None and cache.cache_rows > 0:
                ct, _, slots, hit = hc_mod._cached(cache, ti, ri)
                ct, cs = ct[hit], slots[hit]
                kept_c = cache.hot_rows[ct, cs]
                cache.hot_rows[ct, cs] = upd[hit].to(cache.hot_rows.dtype)
                refreshed = int(hit.sum())
            if engine.faults is not None:
                engine.faults.on_apply(step, engine._group())
        except BaseException as e:
            # crash (or any error) mid-apply: write the kept rows back; the
            # buffered rows replay after recovery
            tables[ti, ri] = kept
            if kept_c is not None:
                cache.hot_rows[ct, cs] = kept_c
            if isinstance(e, NodeFailure):
                self.rollbacks += 1
            raise
        if events is not None:
            events[1].record()
        engine._staged_plan = None       # staged plans predate the write
        if cache is not None and cache.cache_rows > 0:
            # a refreshed cache is a new object, as the reference's
            # refresh builds one: a scrubber's slot audit dispatched
            # before it is stale
            engine.cache = hc_mod.HotCache(hot_ids=cache.hot_ids,
                                           hot_rows=cache.hot_rows,
                                           slot_of=cache.slot_of)
        # a live migration's banked or in-flight copies of these rows are
        # stale now, and the scrubber's mirror and ledger must follow
        # every authorized write
        resh = getattr(engine, "reshard", None)
        scrub = getattr(engine, "scrub", None)
        dt = np.dtype(np.float32)        # deltas serve f32 stacks only
        for k, g in enumerate(gids):
            if resh is not None and resh.active:
                resh.note_applied(int(g), vecs[k], dt)
            if scrub is not None:
                scrub.note_applied(int(g), vecs[k], dt)
        self._apply_buf = hold
        for v, g in ready:
            rem = self._remaining.get(v)
            if rem is not None:
                rem.discard(g)
                if not rem:              # fully committed: prune
                    del self._remaining[v]
                    del self._batches[v]
        self.rows_applied += len(ready)
        self.cache_refreshed += refreshed
        self.applies += 1
        self._refresh_ledger(engine)
        self.apply_trace.append((time.perf_counter() - t_host,) +
                                (events or (None, None)))

    # -- recovery ----------------------------------------------------------

    def on_evict(self, engine) -> None:
        """After an eviction (``DLRMEngine.evict``, once the new group is
        installed): every uncommitted row, verified or in flight, returns
        to the send queue; the next ship routes it to its new owner."""
        requeue = (list(self._apply_buf) + list(self._inflight)
                   + list(self._banked))
        self._apply_buf = []
        self._inflight = []
        self._banked = []
        # the banked harvest's geometry is gone; its rows are requeued
        self._held = None
        if requeue:
            self._sendq = sorted(set(self._sendq) | set(requeue))
        self._refresh_ledger(engine)

    # -- serving-side staleness accounting --------------------------------

    def count_stale_served(self, engine, idx, mask) -> int:
        """Exact count of the (sample, table) bags in this flush's batch
        that touched a row with a PENDING (admitted, not yet committed)
        newer version: ``rows_stale_served``.  ``idx``/``mask`` are the
        batch's tensors on the engine's device; the membership test runs
        there."""
        if not self._remaining:
            return 0
        pend: set = set()
        for gids in self._remaining.values():
            pend |= gids
        if not pend:
            return 0
        _, _, r = self._geometry(engine)
        # idx columns are PHYSICAL slots under a placement: map each back
        # to its original table before forming gids
        inv = self._inv_of(engine)
        t = torch.arange(idx.shape[1], device=idx.device)
        if inv is not None:
            t = torch.from_numpy(engine.pmap.perm_array().astype(np.int64)
                                 ).to(idx.device)
        gids_b = t[None, :, None] * r + idx.long()
        # membership by binary search in the sorted pending gids: exact,
        # and it never forms the (ids x pending) comparison
        want = torch.tensor(sorted(pend), dtype=torch.int64,
                            device=idx.device)
        pos = torch.searchsorted(want, gids_b).clamp_(max=len(want) - 1)
        hit = (want[pos] == gids_b) & (mask > 0)
        return int(hit.any(dim=-1).sum())


def oracle_tables(base_tables: torch.Tensor, batches) -> torch.Tensor:
    """The apply-everything-up-front oracle: every batch's rows written in
    version order onto a copy of ``base_tables``, outside the wire and the
    ledger (on the tables' device)."""
    out = base_tables.clone()
    for b in sorted(batches, key=lambda x: x.version):
        out[torch.from_numpy(b.tab.astype(np.int64)).to(out.device),
            torch.from_numpy(b.row.astype(np.int64)).to(out.device)] = \
            torch.from_numpy(np.asarray(b.vec)).to(out.device, out.dtype)
    return out
