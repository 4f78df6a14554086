"""Silent-data-corruption self-healing (the port of
``repro/runtime/scrub.py``): background integrity scrubbing, quarantine,
and repair over the fused BLS wire.

Serving never re-reads its embedding tables end to end, so a flipped bit
(faulty HBM, a DMA error, a kernel bug) would be served forever.  Three
cooperating parts close that loop:

  * A **background scrubber** audits ``budget`` row blocks a flush (and
    as many hot-cache slots) against an
    :class:`~repro_torch.core.integrity.IntegrityLedger` of expected
    per-(table, row-block) checksums, built at load on the card and
    re-folded in O(1) on every authorized write (freshness apply, scrub
    repair).  The fold runs on the card; its per-row words come back one
    flush later (pinned host buffers behind an event), so the audit never
    waits on the step it just dispatched.  The ledger lives in ORIGINAL
    table space: the audit translates original -> physical through the
    live placement, so a cutover is a ledger no-op.
  * **Quarantine**: a corrupt row's gid joins a bounded vector the
    forward masks out of every bag (the zero fallback at row
    granularity), on the cache-hit and the miss-residual path alike.
  * **Repair**: the host mirror ships the row's known-good bytes as the
    ``"xrep"`` rider of the fused exchange (no extra collective), verified
    against the CURRENT mirror at bank time and again at apply time, so a
    repair never resurrects a value a fresher delta has overwritten.  The
    apply writes the rows IN PLACE between flushes with an undo log (the
    reference scatters into a copy of the whole stack, 7.33 GB at full
    ``dlrm-kaggle`` width), as ``FreshnessManager.apply`` does.

With ``mirror=False`` the scrubber still detects and quarantines (the
per-row checksum shadow costs 4 bytes a row) but cannot repair.

Each member process holds the whole stack and runs the same scrubber on
its own copy.  Silent corruption hits one process's memory, so only the
process holding a bad copy can see it: each audit compacts its mismatches
on the card into a few hundred int32 words (:attr:`Scrubber.audit_words`)
that ride the logits' all-gather (the forward's ``audit_words``), and the
harvest decides from every member's words.  Every member therefore
quarantines, queues and repairs the same gids on the same flush, and the
repair, harvested by all, lands in every copy (a no-op write in a clean
one).  The repair harvest and the wire flags ride the same all-gather.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import integrity as integ
from repro_torch.core.alltoallv import from_host, host_dtype, to_numpy
from repro_torch.core.integrity import row_checksum
from repro_torch.runtime.freshness import to_host_async
from repro_torch.serving import hot_cache as hc_mod


class Scrubber:
    """Host half of the scrub/quarantine/repair subsystem.

    ``budget``: row BLOCKS audited a flush (plus as many hot-cache slots);
    ``block_rows`` the ledger's block granularity; ``slice_cap`` the
    repair sub-wire's rows a slice; ``quarantine_cap`` the quarantine
    vector's length (overflow raises: a corrupt row left unmasked is a
    poisoned answer); ``mirror`` keeps the host byte mirror (repair on)
    or only the checksum shadow (detect only).

    A repaired row's states: ``_repairq`` (quarantined, waiting for wire
    room) -> ``_inflight`` (on the wire) -> ``_banked``/``_held``
    (harvested, unverified) -> ``_apply_buf`` (verified == current mirror)
    -> committed (written, cache refreshed, unquarantined between
    flushes).  ``on_evict`` returns every uncommitted state to the queue.

    ``boot`` holds the boot's times: the ledger on the card (``ledger_ms``
    between CUDA events, None on the CPU) and on the host clock
    (``ledger_s``), and the mirror's copy (``mirror_s``)."""

    def __init__(self, engine, *, budget: int, block_rows: int = 32,
                 slice_cap: int = 8, quarantine_cap: int = 64,
                 mirror: bool = True):
        if budget < 1:
            raise ValueError(f"scrub budget must be >= 1, got {budget}")
        if block_rows < 1:
            raise ValueError(
                f"scrub block_rows must be >= 1, got {block_rows}")
        if slice_cap < 1:
            raise ValueError(f"rep_slice_cap must be >= 1, got {slice_cap}")
        if quarantine_cap < 1:
            raise ValueError(
                f"quarantine_cap must be >= 1, got {quarantine_cap}")
        tables = engine.params["tables"]
        self.budget = int(budget)
        self.block_rows = int(block_rows)
        self.slice_cap = int(slice_cap)
        self.quarantine_cap = int(quarantine_cap)
        # the loaded tables in ORIGINAL order: the boot layout is the
        # identity, but translate in case a placement was adopted first
        inv = self._inv_of(engine)
        on_card = tables.device.type == "cuda"
        ev = None
        if on_card:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t0 = time.perf_counter()
        # the boot fold on the stack's device, in chunks: only the shadow
        # and the block words come to the host
        self.row_cs, self.ledger = integ.device_ledger(
            tables, self.block_rows, inv=inv)
        t1 = time.perf_counter()
        ledger_ms = None
        if ev is not None:
            ev[1].record()
            ev[1].synchronize()
            ledger_ms = ev[0].elapsed_time(ev[1])
        self.mirror = None
        if mirror:
            # the table's bytes: a bf16 stack as its 16-bit patterns
            self.mirror = np.empty(tuple(tables.shape),
                                   host_dtype(tables.dtype))
            for t in range(tables.shape[0]):
                phys = int(inv[t]) if inv is not None else t
                self.mirror[t] = to_numpy(tables[phys])
        self.boot = {"ledger_ms": ledger_ms, "ledger_s": t1 - t0,
                     "mirror_s": time.perf_counter() - t1}
        self.quarantined: set = set()    # original gids masked from serving
        self._cursor = 0                 # block-audit round-robin position
        self._slot_cursor = 0            # cache-slot audit position
        self._repairq: list = []         # gids waiting for wire room
        self._inflight: list = []        # gids on the wire this flush
        self._banked: list = []          # gids harvested, unverified
        self._apply_buf: list = []       # [(gid, vec)] verified == mirror
        self._held = None                # harvested repair leaves, unread
        self._audit_held = None          # dispatched block audit, unread
        self._slot_held = None           # dispatched cache audit, unread
        self._words_held = None          # the gathered audit words, unread
        self.audit_words = None          # this flush's words, to gather
        self._pinned: dict = {}          # reused host buffers, by use
        # mismatched rows (and cache slots) one member's audit reports a
        # flush: a quarantined row stays corrupt until its repair lands,
        # so one audit may re-report up to quarantine_cap of them
        self.mismatch_cap = 2 * self.quarantine_cap + 2
        # the checksum shadow on the stack's device (int32 words), which
        # the audit compares on the card; writes refold it in one scatter
        # before the next audit
        self._row_cs_dev = self._shadow_to(tables.device)
        self._dirty: dict = {}           # (t, row) -> new word, unsynced
        # -- exact counters (mirrored into ServeStats per flush) -----------
        self.blocks_scrubbed = 0
        self.detections = 0              # newly corrupt rows/slots found
        self.repaired_rows = 0
        self.repair_rejects = 0          # failed verify (re-queued)
        self.reships = 0                 # in-flight rows re-shipped
        self.cache_invalidations = 0     # corrupt cached copies dropped

    # -- geometry ----------------------------------------------------------

    def _geometry(self, engine):
        p, t_pad, _, _ = engine._exchange_geometry()
        r = engine.params["tables"].shape[1]
        return p, t_pad // p, r

    @staticmethod
    def _inv_of(engine):
        pm = getattr(engine, "pmap", None)
        if pm is None or pm.is_identity:
            return None
        return pm.inv_array()

    @staticmethod
    def _perm_of(engine):
        pm = getattr(engine, "pmap", None)
        if pm is None or pm.is_identity:
            return None
        return pm.perm_array()

    def _fetch(self, key, leaves: dict):
        """Start the host copy of device ``leaves`` without waiting."""
        return to_host_async(leaves, self._pinned.setdefault(key, {}))

    @staticmethod
    def _arrived(held) -> dict:
        host, done = held
        if done is not None:
            done.synchronize()
        return {k: to_numpy(v) for k, v in host.items()}

    # -- checksum-shadow bookkeeping ---------------------------------------

    def _note_row(self, gid: int, new_cs: int) -> None:
        """O(1) refold of the shadow + ledger for one overwritten row."""
        r = self.ledger.n_rows
        t, row = divmod(int(gid), r)
        b = row // self.block_rows
        cur = int(self.ledger.block_cs[t, b])
        old = int(self.row_cs[t, row])
        self.ledger.block_cs[t, b] = np.uint32(
            (cur - old + int(new_cs)) % integ._CS_MOD)
        self.row_cs[t, row] = np.uint32(new_cs)
        self._dirty[(t, row)] = int(new_cs)

    def _shadow_to(self, dev) -> torch.Tensor:
        return torch.from_numpy(self.row_cs.view(np.int32)).to(dev)

    def _sync_shadow(self) -> None:
        """Refold the device shadow with the rows written since the last
        audit, in one scatter."""
        if not self._dirty:
            return
        keys = np.array(list(self._dirty), np.int64).reshape(-1, 2)
        vals = np.array(list(self._dirty.values()), np.uint32)
        self._dirty = {}
        dev = self._row_cs_dev.device
        ix = torch.from_numpy(keys.T.copy()).to(dev)
        self._row_cs_dev[ix[0], ix[1]] = torch.from_numpy(
            vals.view(np.int32)).to(dev)

    def note_applied(self, gid: int, vec, dtype) -> None:
        """An AUTHORIZED write landed on ``gid`` (freshness apply): track
        it in the mirror and the expected checksums, or the next audit
        would flag a legitimate delta (and a stale repair could resurrect
        the pre-delta bytes).  A delta overwriting a quarantined row IS
        its repair: the row unquarantines and its pending repair drops."""
        gid = int(gid)
        v = np.ascontiguousarray(np.asarray(vec, dtype))
        self._note_row(gid, int(row_checksum(v, gid, 0)))
        if self.mirror is not None:
            r = self.ledger.n_rows
            self.mirror[gid // r, gid % r] = v.astype(self.mirror.dtype)
        if gid in self.quarantined:
            self.quarantined.discard(gid)
            self._drop_pending(gid)

    def _drop_pending(self, gid: int) -> None:
        self._repairq = [g for g in self._repairq if g != gid]
        self._inflight = [g for g in self._inflight if g != gid]
        self._banked = [g for g in self._banked if g != gid]
        self._apply_buf = [(g, v) for g, v in self._apply_buf if g != gid]

    # -- audit (the detection half) ----------------------------------------

    def audit(self, engine, step: int) -> list:
        """Audit ``budget`` row blocks (and as many cache slots) against
        the ledger, one flush deferred: HARVEST the audit dispatched last
        flush and DISPATCH the next.  Returns the NEWLY detected original
        gids.  A corrupt resident row quarantines (and queues for repair
        with the mirror on); a corrupt CACHED copy is invalidated (its
        base row is still authoritative).

        The dispatch folds this process's copy on the card, compares the
        words with the shadow there and compacts the mismatches into
        :attr:`audit_words`, which the engine gathers over the model group
        with the flush's logits and hands back through
        :meth:`bank_audit`; the harvest decides from every member's
        words."""
        newly = self._harvest(engine)
        wb = self._dispatch_blocks(engine)
        wc = self._dispatch_cache(engine)
        self.audit_words = torch.cat([wb, wc])
        return newly

    def bank_audit(self, gathered) -> None:
        """Bank the (P, len(audit_words)) int32 words every member's audit
        of this flush produced (the forward's ``ExchangeDiag.audit``); the
        host copy starts now and is read at the next audit."""
        self._words_held = self._fetch("audit", {"w": gathered})

    def _harvest(self, engine) -> list:
        held, self._words_held = self._words_held, None
        if self._audit_held is None:
            return []
        if held is None:
            # the flush died between the audit and the gather: the next
            # sweep audits these blocks and slots again
            self._audit_held = self._slot_held = None
            return []
        words = self._arrived(held)["w"]
        kb = 1 + 2 * self.mismatch_cap
        newly = self._harvest_blocks(engine, words[:, :kb])
        newly.extend(self._harvest_cache(engine, words[:, kb:]))
        return newly

    def _entries(self, words, n_cols: int) -> list:
        """Every member's reported entries, deduplicated and sorted: rows
        of ``n_cols`` ints.  A member that found more mismatches than it
        could report leaves corruption unaccounted for: that raises, as a
        quarantine overflow does."""
        k = self.mismatch_cap
        cnt = words[:, 0]
        if (cnt > k).any():
            raise RuntimeError(
                f"scrub: an audit found {int(cnt.max())} mismatches, more "
                f"than the {k} one member reports a flush — raise "
                f"quarantine_cap or investigate the corruption source")
        out = set()
        for m in range(words.shape[0]):
            c = int(cnt[m])
            cols = [words[m, 1 + i * k:1 + i * k + c] for i in range(n_cols)]
            out.update(zip(*(col.tolist() for col in cols)))
        return sorted(out)

    def _dispatch_blocks(self, engine) -> torch.Tensor:
        """The next ``budget`` blocks round-robin: their per-row fold on
        the card, compared there with the shadow (the expected words AT
        DISPATCH: writes may refold the shadow before the harvest), the
        mismatches compacted; nothing waits here.  The quarantine set is
        snapshotted now too."""
        p, t_loc, r = self._geometry(engine)
        t_pad = t_loc * p
        inv = self._inv_of(engine)
        nb = self.ledger.n_blocks
        total = t_pad * nb
        n = min(self.budget, total)
        tables = engine.params["tables"]
        dev = tables.device
        self._sync_shadow()
        # the selection is made on the card: no index array is uploaded
        # (a pageable upload would wait for the fold queued before it)
        ks = (self._cursor + torch.arange(n, device=dev)) % total
        self._cursor = int((self._cursor + n) % total)
        ot = ks // nb
        of = (ks % nb)[:, None] * self.block_rows \
            + torch.arange(self.block_rows, device=dev)
        pt = ot if inv is None else \
            torch.from_numpy(inv.astype(np.int64)).to(dev)[ot]
        got = integ._fold_rows_words(tables, pt, of, ot)
        valid = of < r
        want = self._row_cs_dev[ot[:, None], of.clamp(max=r - 1)] \
            .to(torch.int64) & integ._MASK
        want = torch.where(valid, want, 0)      # padding folds to 0
        gid = ot[:, None] * r + of
        words = integ.compact_mismatches(got != want, (gid, want),
                                         self.mismatch_cap)
        self._audit_held = (n, set(self.quarantined), r)
        return words

    def _harvest_blocks(self, engine, words) -> list:
        n, qsnap, r_then = self._audit_held
        self._audit_held = None
        if r_then != engine.params["tables"].shape[1]:
            return []                    # geometry changed under the fold
        self.blocks_scrubbed += n
        newly: list = []
        for g, snap in self._entries(words, 2):
            t0, row = divmod(g, r_then)
            if int(self.row_cs[t0, row]) != snap & 0xFFFFFFFF:
                continue   # a legit write landed between dispatch and
                           # harvest; the next sweep re-audits the row
            if g in self.quarantined or g in qsnap:
                continue                 # known: already masked/queued
            self.quarantined.add(g)
            self.detections += 1
            newly.append(g)
            if self.mirror is not None:
                self._repairq.append(g)
        return newly

    def _dispatch_cache(self, engine) -> torch.Tensor:
        """The next ``budget`` hot-cache slots round-robin: their compare
        fold on the card, the drifted slots compacted as PHYSICAL flat
        gids (slot table · R + row)."""
        cache = engine.cache
        dev = engine.params["tables"].device
        k = self.mismatch_cap
        if cache is None or cache.cache_rows == 0 or cache.hot_ids is None:
            return torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                              torch.full((k,), -1, dtype=torch.int32,
                                         device=dev)])
        t_all, c_all = cache.hot_ids.shape
        total = t_all * c_all
        n = min(self.budget, total)
        ks = (self._slot_cursor
              + torch.arange(n, device=cache.hot_ids.device)) % total
        self._slot_cursor = int((self._slot_cursor + n) % total)
        t_sel = ks // c_all
        tables = engine.params["tables"]
        ids, ok = integ.fold_cache_slots(cache.hot_rows, cache.hot_ids,
                                         tables, t_sel, ks % c_all)
        r = int(tables.shape[1])
        pg = t_sel * r + ids.long()
        self._slot_held = cache
        return integ.compact_mismatches(~ok, (pg,), k).to(dev)

    def _harvest_cache(self, engine, words) -> list:
        """Last flush's cache-slot audit: a cached copy whose bytes
        drifted from its base row on ANY member is dropped on every
        member (the base tables are untouched), so the caches stay alike.
        Every legitimate cache change (refresh, invalidate, cutover
        permute, evict refit) swaps in a NEW ``HotCache`` object on every
        member, so an identity mismatch means the dispatch is stale: it
        is dropped and the next sweep covers those slots."""
        cache_then, self._slot_held = self._slot_held, None
        if cache_then is None:
            return []
        cache = engine.cache
        if cache is not cache_then:
            return []
        r = int(engine.params["tables"].shape[1])
        bad = [g for (g,) in self._entries(words, 1)]
        if not bad:
            return []
        tabs = np.array([g // r for g in bad], np.int64)
        rows = np.array([g % r for g in bad], np.int64)
        new_cache, ninv = hc_mod.invalidate(cache, tabs, rows)
        engine.cache = new_cache
        engine._staged_plan = None
        self.cache_invalidations += int(ninv)
        perm = self._perm_of(engine)
        newly = []
        for tb, rw in zip(tabs, rows):
            t0 = int(perm[tb]) if perm is not None else int(tb)
            self.detections += 1
            newly.append(t0 * r + int(rw))
        return newly

    # -- quarantine (serving-side mask + accounting) -----------------------

    def quarantine_phys(self, engine) -> np.ndarray:
        """The (quarantine_cap,) int32 PHYSICAL flat-gid vector the forward
        masks against, −1 padded.  Overflow raises."""
        if len(self.quarantined) > self.quarantine_cap:
            raise RuntimeError(
                f"quarantine overflow: {len(self.quarantined)} corrupt rows "
                f"exceed quarantine_cap={self.quarantine_cap} — raise the "
                f"cap or investigate the corruption source")
        _, _, r = self._geometry(engine)
        inv = self._inv_of(engine)
        q = np.full(self.quarantine_cap, -1, np.int32)
        for i, g in enumerate(sorted(self.quarantined)):
            tab, row = divmod(g, r)
            phys = int(inv[tab]) if inv is not None else tab
            q[i] = phys * r + row
        return q

    def count_quarantined_served(self, engine, idx, mask) -> int:
        """Exact count of the (sample, table) bags of this flush that
        touched a quarantined row: bags served on the zero fallback.
        ``idx``/``mask`` are the batch's (physical-order) tensors on the
        engine's device; membership is a binary search in the sorted
        quarantined gids, never an (ids x quarantined) comparison."""
        if not self.quarantined:
            return 0
        _, _, r = self._geometry(engine)
        perm = self._perm_of(engine)
        t = torch.arange(idx.shape[1], device=idx.device) if perm is None \
            else torch.from_numpy(perm.astype(np.int64)).to(idx.device)
        gids_b = t[None, :, None] * r + idx.long()
        want = torch.tensor(sorted(self.quarantined), dtype=torch.int64,
                            device=idx.device)
        pos = torch.searchsorted(want, gids_b).clamp_(max=len(want) - 1)
        hit = (want[pos] == gids_b) & (mask > 0)
        return int(hit.any(dim=-1).sum())

    # -- ship (mirror -> wire) ---------------------------------------------

    def next_wire(self, engine, step: int) -> dict:
        """This flush's repair wire slices: numpy leaves keyed
        ``rcnt/rcs/rgid/rvec`` shaped (P, microbatches, ...), each row
        stamped with its transport checksum from the mirror bytes.  The
        forward routes every row to its owner under the CURRENT placement,
        so the slices fill round-robin."""
        p, t_loc, r = self._geometry(engine)
        mb = engine.microbatches
        s = engine.params["tables"].shape[2]
        cap = self.slice_cap
        if self._inflight:
            # the previous flush died between ship and ingest: re-ship
            self.reships += len(self._inflight)
            self._repairq = sorted(set(self._repairq) | set(self._inflight))
            self._inflight = []
        rvec = np.zeros((p, mb, cap, s),
                        host_dtype(engine.params["tables"].dtype))
        rgid = np.zeros((p, mb, cap), np.int32)
        rcs = np.zeros((p, mb, cap), np.uint32)
        rcnt = np.zeros((p, mb, 1), np.int32)
        if self.mirror is not None and self._repairq:
            queue = sorted(set(self._repairq))
            slices = [(m, j) for m in range(p) for j in range(mb)]
            si = 0
            while queue and si < len(slices):
                take, queue = queue[:cap], queue[cap:]
                m, j = slices[si]
                si += 1
                for i, g in enumerate(take):
                    rvec[m, j, i] = self.mirror[g // r, g % r]
                    rgid[m, j, i] = g
                k = len(take)
                rcnt[m, j, 0] = k
                rcs[m, j, :k] = row_checksum(rvec[m, j, :k],
                                             rgid[m, j, :k], 0)
                self._inflight.extend(take)
            self._repairq = queue        # overflow waits its turn
        return {"rcnt": rcnt, "rcs": rcs, "rgid": rgid, "rvec": rvec}

    # -- harvest (wire -> apply buffer) ------------------------------------

    def ingest(self, staged, engine, step: int) -> None:
        """Bank this flush's repair harvest (the forward's ``staged_rep``)
        WITHOUT waiting for it, and verify the PREVIOUS flush's."""
        self._process_held(engine)
        self._held = self._fetch("repair", staged)
        self._banked = self._inflight
        self._inflight = []

    def _process_held(self, engine) -> None:
        if self._held is None:
            return
        held, self._held = self._held, None
        dd = self._arrived(held)
        p_dst, mb, p_src = dd["rgid"].shape[:3]
        cap = dd["rgid"].shape[3]
        _, _, r = self._geometry(engine)
        seen: set = set()
        if dd["rcnt"].any():
            for m in range(p_dst):
                for j in range(mb):
                    for q in range(p_src):
                        # clamp: a wire-corrupted slice can carry a
                        # garbage count; never index past the cap
                        c = min(int(dd["rcnt"][m, j, q, 0]), cap)
                        if c <= 0:
                            continue
                        gids = dd["rgid"][m, j, q, :c].astype(np.int64)
                        got = np.asarray(row_checksum(
                            dd["rvec"][m, j, q, :c], gids, 0), np.uint32)
                        ok = got == dd["rcs"][m, j, q, :c]
                        for i, g in enumerate(int(x) for x in gids):
                            seen.add(g)
                            if g not in self.quarantined:
                                continue    # a delta fixed it meanwhile
                            # a copy: the pinned buffer is reused
                            vec = np.array(dd["rvec"][m, j, q, i])
                            # the transport checksum AND the current
                            # mirror's bytes: a repair is the mirror's
                            # bytes or it is nothing
                            cur = None if self.mirror is None else \
                                np.ascontiguousarray(
                                    self.mirror[g // r, g % r])
                            if ok[i] and cur is not None and \
                                    vec.tobytes() == cur.tobytes():
                                self._apply_buf.append((g, vec))
                            else:
                                self.repair_rejects += 1
                                self._repairq.append(g)
        # banked rows the harvest never surfaced (a dropped segment, a
        # rejected destination) re-queue: a lost repair is a retried one
        lost = [g for g in self._banked
                if g not in seen and g in self.quarantined]
        self._banked = []
        self._repairq = sorted(set(self._repairq) | set(lost))

    # -- apply (between flushes) -------------------------------------------

    def apply(self, engine, step: int) -> None:
        """Commit the verified repairs: write them into the tables and the
        hot cache's copies IN PLACE, keeping the overwritten rows (any
        error in the window writes them back, and the repairs stay
        buffered), then unquarantine.  Runs AFTER the freshness apply in
        the same window, and re-checks each row against the mirror at the
        last moment: a repair a delta has since superseded re-queues."""
        if not self._apply_buf:
            return
        _, _, r = self._geometry(engine)
        inv = self._inv_of(engine)
        buf, self._apply_buf = self._apply_buf, []
        best: dict = {}
        for g, vec in buf:
            best[g] = vec
        ready = []
        for g in sorted(best):
            if g not in self.quarantined:
                continue
            cur = np.ascontiguousarray(self.mirror[g // r, g % r])
            if best[g].tobytes() != cur.tobytes():
                self._repairq.append(g)
                continue
            ready.append((g, best[g]))
        if not ready:
            return
        gids = np.array([g for g, _ in ready], np.int64)
        vecs = np.stack([v for _, v in ready])
        tab = gids // r
        if inv is not None:
            tab = inv[tab].astype(np.int64)
        row = gids % r
        tables, cache = engine.params["tables"], engine.cache
        dev = tables.device
        tr = torch.from_numpy(np.stack([tab, row])).to(dev)
        upd = from_host(vecs, tables.dtype).to(dev)
        ti, ri = tr[0], tr[1]
        kept = tables[ti, ri]                    # the undo log (a copy)
        kept_c = None
        try:
            tables[ti, ri] = upd
            if cache is not None and cache.cache_rows > 0:
                ct, _, slots, hit = hc_mod._cached(cache, ti, ri)
                ct, cs = ct[hit], slots[hit]
                kept_c = cache.hot_rows[ct, cs]
                cache.hot_rows[ct, cs] = upd[hit].to(cache.hot_rows.dtype)
        except BaseException:
            tables[ti, ri] = kept
            if kept_c is not None:
                cache.hot_rows[ct, cs] = kept_c
            self._apply_buf = buf
            raise
        if cache is not None and cache.cache_rows > 0:
            # a refreshed cache is a new object, as the reference's
            # refresh builds one: a slot audit dispatched before it is
            # stale
            engine.cache = hc_mod.HotCache(hot_ids=cache.hot_ids,
                                           hot_rows=cache.hot_rows,
                                           slot_of=cache.slot_of)
        engine._staged_plan = None
        resh = getattr(engine, "reshard", None)
        if resh is not None and resh.active:
            for k, g in enumerate(gids):
                resh.note_applied(int(g), vecs[k], vecs.dtype)
        for g, _ in ready:
            self.quarantined.discard(g)
        self.repaired_rows += len(ready)

    # -- recovery ----------------------------------------------------------

    def on_evict(self, engine) -> None:
        """Refit after an eviction (``DLRMEngine.evict``, once the new
        group is installed).  The mirror and the shadow refit on the host,
        NOT from the device, which may still hold unrepaired corruption
        that a re-snapshot would bless.  Every uncommitted repair returns
        to the queue; quarantines outside the new geometry drop with their
        tables."""
        p, t_loc, r = self._geometry(engine)
        t_pad = t_loc * p
        old = self.row_cs.shape[0]
        if self.mirror is not None:
            if t_pad <= old:
                self.mirror = self.mirror[:t_pad].copy()
            else:
                z = np.zeros((t_pad - old,) + self.mirror.shape[1:],
                             self.mirror.dtype)
                self.mirror = np.concatenate([self.mirror, z], axis=0)
        if t_pad <= old:
            self.row_cs = self.row_cs[:t_pad].copy()
        else:
            tables = engine.params["tables"]
            gids = (np.arange(old, t_pad)[:, None] * r
                    + np.arange(r)[None, :])
            zeros = np.zeros((t_pad - old, r, tables.shape[2]),
                             host_dtype(tables.dtype))
            zcs = row_checksum(zeros, gids, 0)
            self.row_cs = np.concatenate([self.row_cs, zcs], axis=0)
        self.ledger = integ.IntegrityLedger(
            block_rows=self.block_rows, n_rows=r,
            block_cs=np.stack([
                integ._host_block_sums(self.row_cs[t], self.block_rows)
                for t in range(t_pad)]))
        pend = (set(self._repairq) | set(self._inflight)
                | set(self._banked) | {g for g, _ in self._apply_buf})
        self._inflight, self._banked, self._apply_buf = [], [], []
        self._held = None
        self._audit_held = None          # audits of a dead geometry
        self._slot_held = None
        self._words_held = None
        self._dirty = {}
        self._row_cs_dev = self._shadow_to(self._row_cs_dev.device)
        self.quarantined = {g for g in self.quarantined if g // r < t_pad}
        self._repairq = sorted(g for g in pend if g in self.quarantined)
        self._cursor = 0
        self._slot_cursor = 0

    @property
    def fully_repaired(self) -> bool:
        return not (self.quarantined or self._repairq or self._inflight
                    or self._banked or self._apply_buf)
