"""Crash-safe online resharding (the port of ``repro/runtime/reshard.py``):
the executor half of skew-aware placement.

A :class:`~repro_torch.runtime.placement.MigrationPlan` says which tables
move where; this module moves them WHILE SERVING CONTINUES, over the fused
exchange the batches ride (the ``"xmig"`` field, no extra collective), in
``slice_cap``-bounded installments a flush.  The life of one row:

  queued -> on the wire (the CURRENT owner's stage_a gathers it from its
  live shard, stamps a device checksum over the bytes that ship and routes
  it to the FUTURE owner) -> held (the harvest banked unread, verified one
  flush later) -> banked (a verified host copy) -> installed (the commit
  builds the new stack with the banked rows).

The old owner keeps serving every in-flight table from its live shard
until the commit (the wire ships copies, never state), so every flush
before the swap is bit-exact on the old layout.  The commit is two swaps:
(1) the tables and the partition map together, (2) the hot cache.
Rollback is the absence of the swap: a crash at ship, bank, verify or
install leaves the published references untouched and the engine's evict
-> replay recovers on the old layout; a crash BETWEEN the swaps is the one
window where tables and cache disagree, which is why ``DLRMEngine.evict``
cold-invalidates the cache whenever a reshard was in flight.

Each member process runs the same executor on the same harvest (the
forward gathers every member's into the logits' all-gather), so their
decisions, counters and committed stacks agree.  ``FreshnessManager.apply``
and the scrubber's repair call :meth:`ReshardExecutor.note_applied` for
every committed row: a banked copy is patched, an in-flight one re-ships.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.alltoallv import from_host, host_dtype, to_numpy
from repro_torch.core.integrity import row_checksum
# MIG_STAGES: the five migration steps a fault plan can kill (shipping,
# banking, verifying, installing, and the window between the two commit
# swaps), re-exported beside MIG_KEYS as the reference does
from repro_torch.runtime.faults import MIG_STAGES  # noqa: F401
from repro_torch.runtime.freshness import to_host_async
from repro_torch.serving import hot_cache as hc_mod


def install_stack(tables, order, mov_slots, slot_ix, row_ix, vals):
    """The post-cutover stack on the tables' device: keepers gathered by
    ``order`` (new slot -> old slot), moved slots zeroed, the banked rows
    scattered in.  A new tensor beside the old one (the old is released
    when the engine drops it at swap 1)."""
    dev = tables.device

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64)).to(dev)

    new = tables[ix(order)]
    new[ix(mov_slots)] = 0
    new[ix(slot_ix), ix(row_ix)] = from_host(vals, tables.dtype).to(dev)
    return new


# the migration wire leaves, in the order ReshardExecutor.next_wire emits
MIG_KEYS = ("mcnt", "mdst", "mepoch", "mgid")


class ReshardExecutor:
    """Executes one :class:`MigrationPlan` in installments between
    flushes.  All state is on the host; the card only gathers, checksums
    and routes copies.  ``epoch`` stamps this reshard's wire traffic
    (mixed into every row checksum), so slices of an aborted predecessor
    never bank into a successor."""

    def __init__(self, plan, *, epoch: int, slice_cap: int = 8):
        if plan.is_noop:
            raise ValueError("refusing to execute a noop migration plan")
        if slice_cap < 1:
            raise ValueError(f"slice_cap must be >= 1, got {slice_cap}")
        self.plan = plan
        self.epoch = int(epoch)
        self.slice_cap = int(slice_cap)
        self.state = "idle"          # idle|shipping|committed|aborted
        self._src: dict = {}         # gid -> current owner (ships it)
        self._dst: dict = {}         # gid -> future owner
        self._expected: set = set()  # every gid the plan moves
        self._queued: set = set()    # waiting for wire room
        self._inflight: set = set()  # on the wire this flush
        self._arriving: set = set()  # harvested, banked unread
        self._dirty: set = set()     # delta landed while in flight
        self.banked: dict = {}       # gid -> verified host row copy
        self._held = None            # last flush's harvest, unread
        self._held_step = 0
        self._pinned: dict = {}      # reused host buffers of the harvest
        # -- exact counters (mirrored into ServeStats) --------------------
        self.shipped_rows = 0        # row installments on the wire
        self.reships = 0             # re-sent (lost flush / dirty / reject)
        self.rejects = 0             # checksum-verify failures
        self.installments = 0        # flushes that carried migration rows

    # -- lifecycle ---------------------------------------------------------

    def start(self, engine) -> None:
        """Build the send queues from the plan against the engine's live
        geometry.  Only real (unpadded) rows ship: a move of ``rows=0``
        commits as a pure relabel."""
        r = int(engine.params["tables"].shape[1])
        for ti, src, dst, rows in self.plan.moves:
            for j in range(rows):
                g = ti * r + j
                self._src[g] = src
                self._dst[g] = dst
                self._expected.add(g)
                self._queued.add(g)
        self.state = "shipping"

    @property
    def active(self) -> bool:
        return self.state == "shipping"

    @property
    def complete(self) -> bool:
        """Every expected row banked and verified, nothing in motion: the
        precondition of the commit."""
        return (self.state == "shipping" and not self._queued
                and not self._inflight and not self._arriving
                and self._held is None and not self._dirty
                and set(self.banked) == self._expected)

    def abort(self) -> None:
        self.state = "aborted"

    def _fault(self, engine, step: int, stage: str) -> None:
        if engine.faults is not None:
            engine.faults.on_migrate(step, stage, group=engine._group())

    # -- ship (host -> wire) ----------------------------------------------

    def next_wire(self, engine, step: int) -> dict:
        """This flush's migration wire slices: numpy leaves keyed
        ``mcnt/mdst/mepoch/mgid`` shaped ``(P, microbatches, ...)``.  Slice
        (m, j) carries only rows member m owns NOW (its stage_a gathers
        them from its live shard), at most ``slice_cap`` of them."""
        self._fault(engine, step, "ship")
        # a flush that died between ship and ingest left rows marked in
        # flight that never arrived: ship them again
        if self._inflight:
            self.reships += len(self._inflight)
            self._queued |= self._inflight
            self._inflight = set()
        p, _, _, _ = engine._exchange_geometry()
        mb = engine.microbatches
        cap = self.slice_cap
        mgid = np.zeros((p, mb, cap), np.int32)
        mdst = np.zeros((p, mb, cap), np.int32)
        mcnt = np.zeros((p, mb, 1), np.int32)
        mepoch = np.full((p, mb, 1), self.epoch, np.int32)
        carried = False
        for m in range(p):
            gids = sorted(g for g in self._queued if self._src[g] == m)
            gids = gids[:mb * cap]
            for j in range(mb):
                chunk = gids[j * cap:(j + 1) * cap]
                if not chunk:
                    break
                n = len(chunk)
                mgid[m, j, :n] = chunk
                mdst[m, j, :n] = [self._dst[g] for g in chunk]
                mcnt[m, j, 0] = n
                self._queued.difference_update(chunk)
                self._inflight.update(chunk)
                self.shipped_rows += n
                carried = True
        if carried:
            self.installments += 1
        return {"mcnt": mcnt, "mdst": mdst, "mepoch": mepoch, "mgid": mgid}

    # -- harvest (wire -> bank) -------------------------------------------

    def ingest(self, staged, engine, step: int) -> None:
        """Bank this flush's harvest (the forward's ``staged_mig``) WITHOUT
        waiting for it (pinned host buffers behind an event on the card);
        the PREVIOUS flush's, long since arrived, is verified now."""
        self._process_held(engine)
        self._fault(engine, step, "bank")
        self._held = to_host_async(staged, self._pinned)
        self._held_step = step
        self._arriving = self._inflight
        self._inflight = set()

    def _process_held(self, engine) -> None:
        """Verify the banked harvest, leaves ``(P_dst, mb, P_src, ...)``:
        checksum-verified rows bank as host copies; a mismatch re-ships (a
        corrupted installment is retried, never lost or poisoned); rows a
        delta dirtied in flight re-ship too, so the bank equals the live
        shard."""
        if self._held is None:
            return
        self._fault(engine, self._held_step, "verify")
        (host, done), self._held = self._held, None
        if done is not None:
            done.synchronize()
        dd = {k: to_numpy(v) for k, v in host.items()}
        p_dst, mb, p_src = dd["mgid"].shape[:3]
        if dd["mcnt"].any():
            for m in range(p_dst):
                for j in range(mb):
                    for q in range(p_src):
                        # clamp: a wire-corrupted slice can carry a
                        # garbage count; never index past the cap
                        c = min(int(dd["mcnt"][m, j, q, 0]),
                                dd["mgid"].shape[3])
                        if c <= 0:
                            continue
                        ep = int(dd["mepoch"][m, j, q, 0])
                        if ep != self.epoch:
                            continue   # a dead reshard's stragglers
                        gids = dd["mgid"][m, j, q, :c].astype(np.int64)
                        got = np.asarray(row_checksum(
                            dd["mvec"][m, j, q, :c], gids, np.int64(ep)),
                            np.uint32)
                        ok = got == dd["mcs"][m, j, q, :c]
                        for i, g in enumerate(int(x) for x in gids):
                            if g not in self._arriving:
                                continue  # duplicate delivery
                            self._arriving.discard(g)
                            if not ok[i]:
                                self.rejects += 1
                                self.reships += 1
                                self._queued.add(g)
                            elif g in self._dirty:
                                self._dirty.discard(g)
                                self.reships += 1
                                self._queued.add(g)
                            else:
                                self.banked[g] = np.array(
                                    dd["mvec"][m, j, q, i])
        # anything expected that never arrived re-ships
        if self._arriving:
            self.reships += len(self._arriving)
            self._queued |= self._arriving
            self._arriving = set()

    # -- freshness interop -------------------------------------------------

    def note_applied(self, gid: int, vec, dtype) -> None:
        """An authorized write just committed ``gid`` into the live tables:
        a banked copy is patched to the same value; an in-flight one is
        marked dirty so it re-ships from the written shard.  Queued rows
        need nothing: their gather reads the live shard at ship time."""
        g = int(gid)
        if g not in self._expected:
            return
        if g in self.banked:
            self.banked[g] = np.asarray(vec).astype(dtype).copy()
        elif g in self._inflight or g in self._arriving:
            self._dirty.add(g)

    # -- commit (two swaps) ------------------------------------------------

    def try_commit(self, engine, step: int) -> bool:
        """The cutover, iff every moved row is banked and verified.  Builds
        the NEW physical stack on the card (keepers gathered from the old
        stack, movers installed from the banked wire-shipped rows, padding
        past each table's real size zero: it is never pooled), then swaps
        (1) tables + partition map, (2) the hot cache, with the injectable
        ``"commit"`` crash point between them.  Before swap (1) nothing
        published has changed."""
        self._process_held(engine)
        if not self.complete:
            return False
        self._fault(engine, step, "install")
        old = engine.params["tables"]
        r = int(old.shape[1])
        s = int(old.shape[2])
        old_inv = engine.pmap.inv_array()
        new_map = self.plan.new_map
        new_inv = new_map.inv_array()
        order = old_inv[new_map.perm_array()]        # new slot -> old slot
        mov_slots, slot_ix, row_ix, vals = [], [], [], []
        for ti, _, _, rows in self.plan.moves:
            slot = int(new_inv[ti])
            mov_slots.append(slot)
            for j in range(rows):
                slot_ix.append(slot)
                row_ix.append(j)
                vals.append(self.banked[ti * r + j])
        # the banked rows' bytes, a bf16 row as its 16-bit patterns
        vals_a = (np.stack(vals) if vals
                  else np.zeros((0, s), host_dtype(old.dtype)))
        staged_tables = install_stack(old, order, mov_slots, slot_ix,
                                      row_ix, vals_a)
        del old
        staged_cache = engine.cache
        if engine.cache is not None:
            staged_cache = hc_mod.permute_tables(engine.cache, order)
        # swap 1: the stack and the map that interprets it, together
        engine.params["tables"] = staged_tables
        engine._pmap = new_map
        engine._staged_plan = None
        self._fault(engine, step, "commit")
        # swap 2: the cache's copies, permuted to the new physical order
        engine.cache = staged_cache
        self.state = "committed"
        return True

    def summary(self) -> dict:
        return {
            "state": self.state,
            "epoch": self.epoch,
            "moved_rows": self.plan.moved_rows,
            "banked": len(self.banked),
            "shipped_rows": self.shipped_rows,
            "reships": self.reships,
            "rejects": self.rejects,
            "installments": self.installments,
        }
