"""Serving engines (the port of the core of ``repro/serving/engine.py``):
``DLRMEngine`` for CTRs and ``LMEngine`` for greedy LM decoding.

CTR requests (dense, sparse) accumulate into fixed-size batches; each flush
runs the BLS forward over microbatches on the model group and returns
``sigmoid(logits)``; per-batch latency feeds the straggler monitor whose
recommendation can retune the bound between batches, and the exchange's
live-row counts feed the cap autotuner that moves an ``exchange='auto'``
engine with a hot-row cache onto the ragged exchange.  ``plan_pipeline``
builds each batch's stream plans off the critical path and returns results
one flush late; the chaos options (``faults``, ``deadline_s``,
``on_deadline``) serve around stragglers and evict crashed members;
``freshness`` applies versioned embedding-row updates between flushes;
``rebalance`` moves tables between members while serving continues, and
``scrub_budget`` audits, quarantines and repairs corrupted rows.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import DLRMConfig, ModelConfig
from repro_torch.core import alltoallv as a2a_mod
from repro_torch.core import bls as bls_mod
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import api
from repro_torch.models import dlrm as dlrm_mod
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.runtime import elastic
from repro_torch.runtime import placement as plc_mod
from repro_torch.runtime.elastic import Evicted, NodeFailure
from repro_torch.runtime.reshard import MIG_KEYS, ReshardExecutor
from repro_torch.runtime.straggler import (CapAutotuner, StragglerMonitor,
                                           detect_stragglers)
from repro_torch.serving import hot_cache as hc_mod
from repro_torch.train import steps as steps_mod

# the delta wire leaves, in the order FreshnessManager.next_wire emits them
DELTA_KEYS = ("dcnt", "dcs", "dgid", "dvec", "dver")

# the integrity-repair wire leaves, in the order Scrubber.next_wire emits
REP_KEYS = ("rcnt", "rcs", "rgid", "rvec")


@dataclasses.dataclass
class ServeStats:
    batches: int = 0
    requests: int = 0
    total_s: float = 0.0
    retunes: int = 0          # caps the autotuner adopted
    # -- chaos ledger (deadline policy / degraded serving / eviction) ------
    deadline_breaches: int = 0  # flushes that exceeded deadline_s
    degraded_batches: int = 0   # batches served with degraded_members set
    approx_rows: int = 0        # live bags served from the fallback, total
    evictions: int = 0          # evict() recoveries (crash or policy)
    replays: int = 0            # batches dispatched again after a NodeFailure
    recovery_s: float = 0.0     # wall time inside evict()
    # -- freshness ledger (versioned delta updates) ------------------------
    rows_applied: int = 0       # delta rows committed into the tables
    rows_stale_served: int = 0  # bags served that touched a pending row
    versions_behind: int = 0    # ledger spread after the last flush
    delta_rejects: int = 0      # checksum-rejected (re-shipped) delta rows
    apply_rollbacks: int = 0    # applies abandoned by a mid-apply crash
    # -- placement ledger (skew-aware resharding) --------------------------
    reshards: int = 0           # committed placement cutovers
    reshard_aborts: int = 0     # in-flight reshards torn down by evict()
    migrated_rows: int = 0      # embedding rows moved by committed cutovers
    imbalance_ratio: float = 1.0   # max/mean per-member pooled-row load
    flush_time_ratio: float = 1.0  # max/mean per-member flush-time estimate
    # -- scrub ledger (silent-corruption self-healing) ---------------------
    blocks_scrubbed: int = 0    # table blocks audited on the device
    detections: int = 0         # rows (or cache slots) caught corrupt
    repaired_rows: int = 0      # quarantined rows restored from the mirror
    quarantined_served: int = 0  # bags that touched a quarantined row
    wire_rejects: int = 0       # (dst, microbatch, src) segments rejected
    detection_lag_flushes: int = 0  # worst inject -> detect lag observed
    # per-member exchange telemetry (EWMA pooled rows / exchanged bytes),
    # lists so the JSON view keeps the member axis
    member_rows: list = dataclasses.field(default_factory=list)
    member_bytes: list = dataclasses.field(default_factory=list)

    @property
    def throughput_rps(self) -> float:
        return self.requests / self.total_s if self.total_s else 0.0

    def to_dict(self) -> dict:
        """Plain-JSON view of the ledger: every ``ServeStats`` field and
        the derived throughput (``serving.frontend.FrontendStats`` extends
        it with its own counters and histograms)."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(ServeStats)}
        d["throughput_rps"] = self.throughput_rps
        return d


# one side stream per card for plan builds, shared by every engine: the
# caching allocator keeps blocks per stream, so a stream of its own would
# make each new engine allocate its plan buffers afresh
_PLAN_STREAMS: dict = {}


def _plan_stream(device) -> "torch.cuda.Stream":
    if device not in _PLAN_STREAMS:
        _PLAN_STREAMS[device] = torch.cuda.Stream(device)
    return _PLAN_STREAMS[device]


def _fit_tables(a, t_pad: int, fill=0):
    """Crop or pad a (T_pad_old, ...) stack to ``t_pad`` tables: padding
    tables carry mask 0 and are never indexed, so this is exact."""
    if a.shape[0] >= t_pad:
        return a[:t_pad]
    pad = a.new_full((t_pad - a.shape[0],) + tuple(a.shape[1:]), fill)
    return torch.cat([a, pad])


class DLRMEngine:
    """Fixed-batch CTR serving with the BLS-enabled forward.

    ``wire_dtype``, ``exchange``, ``ragged_cap``, ``exchange_pipeline``,
    ``row_block`` and ``pool_mode`` default to the config's.  ``cache`` (a
    ``serving/hot_cache.HotCache`` over the full table stack) or one built
    by :meth:`calibrate_cache` moves the skewed head of the traffic off the
    wire.  Under ``exchange='auto'`` with a cache every flush feeds the
    exchange's live-count and drop diagnostics to a ``CapAutotuner``, and
    every ``retune_every`` batches :meth:`retune_cap` adopts its cap, which
    moves the engine between the dense and the ragged exchange; the port
    has no jit, so a retune takes effect at the next flush.  ``device`` is
    where the batches go and the parameters must live; ``group`` the model
    group (default: the one ``launch/mesh.py`` set up, or single-device
    without one).

    ``plan_pipeline=True`` builds each batch's embedding-bag stream plans
    (:func:`~repro_torch.models.dlrm.build_forward_plans`) on a side stream
    the compute stream waits on, dispatches the forward without waiting
    for the card, and returns the PREVIOUS batch's CTRs: results arrive
    one flush late, and :meth:`drain` returns the last ones.
    :meth:`stage_plan` builds the plans of a batch before it is flushed.
    Where no plan exists (the 'ref' backend, a resident regime, a ragged
    exchange) the plan is None and the pipeline only defers the harvest;
    the CTRs are the same either way.

    Chaos: ``deadline_s`` arms a per-flush deadline with policy
    ``on_deadline``: 'block' only counts breaches, 'degrade' serves around
    confirmed sustained stragglers (``degraded_members`` with
    ``degraded_fallback``, the loss ledgered in ``ServeStats.approx_rows``)
    and 'evict' removes them from the group.  A breach that
    ``detect_stragglers`` does not confirm for ``confirm_after``
    consecutive breaching flushes is transient: the bound rises toward
    :meth:`recommend_bound` instead.  ``faults`` (a
    ``runtime.faults.FaultInjector``) sleeps the plan's delays before each
    flush and raises ``NodeFailure`` at crash steps; the engine then backs
    off, evicts the crashed member and dispatches the same batch again (up
    to ``max_retries`` times), so no request is lost.  With a deadline
    armed the members agree on each flush's latency (the slowest one's),
    so every member takes the same decision.

    ``freshness`` (a ``runtime.freshness.FreshnessManager``) serves
    versioned embedding-row updates: before each flush its apply window
    commits the rows harvested on earlier flushes, then this flush's delta
    slices ride the exchange as the ``"xdelta"`` field (no extra
    collective) and are harvested for a later apply; the five freshness
    counters of :class:`ServeStats` mirror the manager's.  The rows are
    written into ``params["tables"]`` (and the cache) in place: pass a
    copy of the stack to keep the original.
    ``layout_version`` counts the layout changes (evictions and
    cutovers), on which a frontend resets its flush-time estimate.

    Skew-aware placement: ``rebalance=True`` feeds every flush's live-bag
    counts to a per-table ``runtime.placement.TableLoadModel``; per-member
    imbalance over ``rebalance_threshold`` for ``rebalance_patience``
    flushes (paused while a frontend's ladder is off FULL) plans a minimal
    LPT migration and runs it online (:meth:`start_reshard`,
    ``runtime.reshard``): the moved rows ride the exchange as the
    ``"xmig"`` field in ``mig_slice_cap``-row installments while serving
    continues bit-exact on the old layout, then the cutover swaps the
    stack.  An eviction aborts a reshard in flight and makes a rebalance
    on the shrunken group mandatory.  At P = 1 no plan is ever made; a
    plan handed to :meth:`start_reshard` still runs.

    Integrity: ``scrub_budget`` > 0 arms a ``runtime.scrub.Scrubber``
    (``scrub_block_rows``, ``rep_slice_cap``, ``quarantine_cap``,
    ``scrub_mirror``): each flush audits that many row blocks and cache
    slots, quarantined rows are masked out of every bag, repairs from the
    host mirror ride the ``"xrep"`` field, and every wire slot carries a
    segment checksum (``"wcs"``) whose rejects escalate a persistently
    corrupt source through the confirm -> degrade -> evict ladder.  Each
    member audits its own copy and the mismatch words ride the logits'
    all-gather, so every member quarantines and repairs alike.  The bit
    flips of a fault plan (``with_bitflip``) land IN PLACE in the named
    member's copy only, and repairs are written in place: pass a copy of
    the stack to keep the original.  Rebalancing and scrubbing need the whole (T_pad,
    R, s) stack, as freshness does.

    ``unroll`` is the reference's BLS scan unroll (None or >= 1).  The
    reference compiles microbatches in an unrolled scan differently unless
    ``unroll=1``, so a request's CTR there depends on its position in the
    batch; here every microbatch runs the same code at the same shape, so
    it never does, and the value changes nothing."""

    def __init__(self, params, cfg: DLRMConfig, *, batch_size: int = 512,
                 bound: int = 0, microbatches: int = 1,
                 unroll: Optional[int] = None,
                 wire_dtype: Optional[str] = None, cache=None,
                 exchange: Optional[str] = None,
                 ragged_cap: Optional[int] = None,
                 exchange_pipeline: Optional[str] = None,
                 retune_every: int = 8,
                 row_block: Optional[int] = None,
                 pool_mode: Optional[str] = None,
                 device="cuda", group=None,
                 plan_pipeline: bool = False,
                 deadline_s: Optional[float] = None,
                 on_deadline: str = "block", faults=None, freshness=None,
                 degraded_fallback: str = "zero", confirm_after: int = 2,
                 max_retries: int = 2, retry_backoff_s: float = 0.0,
                 rebalance: bool = False,
                 rebalance_threshold: float = 1.25,
                 rebalance_patience: int = 8,
                 mig_slice_cap: int = 8,
                 scrub_budget: int = 0,
                 scrub_block_rows: int = 32,
                 rep_slice_cap: int = 8,
                 quarantine_cap: int = 64,
                 scrub_mirror: bool = True):
        self.device = resolve_device(device)
        if unroll is not None and (isinstance(unroll, bool) or
                                   not isinstance(unroll, int) or unroll < 1):
            raise ValueError(f"unroll must be None or an int >= 1, got "
                             f"{unroll!r}")
        if on_deadline not in ("block", "degrade", "evict"):
            raise ValueError(f"unknown on_deadline {on_deadline!r}")
        if degraded_fallback not in ("zero", "mean"):
            raise ValueError(
                f"unknown degraded_fallback {degraded_fallback!r}")
        for name, val, path in (
                ("faults", faults, "drives recovery through the "
                 "synchronous flush path"),
                ("freshness", freshness, "applies deltas atomically "
                 "BETWEEN synchronous flushes"),
                ("rebalance", rebalance, "migrates rows through the "
                 "synchronous flush path"),
                ("scrub_budget", scrub_budget, "audits and repairs "
                 "through the synchronous flush path")):
            if val and plan_pipeline:
                raise ValueError(
                    f"{name} {path}; plan_pipeline's deferred harvest would "
                    f"tear that boundary — run {name} without plan_pipeline")
        self.params, self.cfg = params, cfg
        if params["tables"].device != self.device:
            raise ValueError(f"parameters are on {params['tables'].device}, "
                             f"the engine serves on {self.device}")
        self.wire_dtype = dlrm_mod.resolve_slice(
            cfg, wire_dtype=wire_dtype, exchange=exchange,
            exchange_pipeline=exchange_pipeline)
        self.cache = cache
        self.exchange = exchange or cfg.exchange
        self.ragged_cap = ragged_cap if ragged_cap is not None \
            else cfg.ragged_cap
        self.exchange_pipeline = exchange_pipeline or cfg.exchange_pipeline
        self.retune_every = retune_every
        self.row_block = row_block if row_block is not None \
            else cfg.row_block
        self.pool_mode = pool_mode if pool_mode is not None \
            else cfg.pool_mode
        self.batch_size = batch_size
        self.bound, self.microbatches = int(bound), microbatches
        self.unroll = unroll
        self.group = group
        self.plan_pipeline = plan_pipeline
        self.deadline_s = deadline_s
        self.on_deadline = on_deadline
        self.faults = faults
        self.freshness = freshness
        self.degraded_fallback = degraded_fallback
        self.confirm_after = max(1, int(confirm_after))
        self.max_retries = max(0, int(max_retries))
        self.retry_backoff_s = float(retry_backoff_s)
        self.degraded_members: tuple = ()
        self._flushes = 0              # fault-plan step counter
        self._streak: dict = {}        # straggler confirmation streaks
        self._evicted = False          # this process left the group
        self.monitor = StragglerMonitor()
        self.cap_tuner = CapAutotuner()
        self.stats = ServeStats()
        self._pending: list = []
        # (CTRs, diag, n, t0, watcher, done, step_no) of the batch in
        # flight under plan_pipeline; always None otherwise
        self._inflight = None
        self._last_finish_t = 0.0      # end of the last harvested batch
        # (fitted idx, plan) staged by stage_plan() for the next flush
        self._staged_plan = None
        self.plan_stage_hits = 0       # flushes served a staged plan
        # bumped on every layout change (cutover, eviction): the
        # frontend's flush estimate keys off it to recalibrate
        self.layout_version = 0
        for name, val in (("freshness", freshness is not None),
                          ("rebalance", rebalance),
                          ("scrub_budget", bool(scrub_budget))):
            if val and params["tables"].shape[0] != \
                    self._exchange_geometry()[1]:
                raise ValueError(
                    f"{name} writes rows into the whole (T_pad, R, s) "
                    f"stack; the engine holds one member's shard")
        # -- skew-aware placement + online resharding ----------------------
        self.rebalance = bool(rebalance)
        self.rebalance_threshold = float(rebalance_threshold)
        self.rebalance_patience = max(1, int(rebalance_patience))
        self.mig_slice_cap = max(1, int(mig_slice_cap))
        self._pmap = None              # None == identity boot placement
        self.reshard = None            # the ReshardExecutor in flight
        self._reshard_epoch = 0        # fences dead reshards' wire slices
        self.load_model = None         # TableLoadModel, sized per geometry
        self._member_ewma = None       # EWMA per-member pooled live rows
        self._imb_streak = 0           # consecutive over-threshold flushes
        self._rebalance_pending = False  # mandatory rebalance after evict()
        # -- integrity scrubbing -------------------------------------------
        self.scrub = None
        self._held_wbad = None         # the previous flush's wire flags
        self._wire_streak: dict = {}   # per-src consecutive-corrupt flushes
        self._flip_log: dict = {}      # injected-flip gid -> flush, for lag
        if scrub_budget:
            from repro_torch.runtime.scrub import Scrubber
            self.scrub = Scrubber(self, budget=int(scrub_budget),
                                  block_rows=int(scrub_block_rows),
                                  slice_cap=int(rep_slice_cap),
                                  quarantine_cap=int(quarantine_cap),
                                  mirror=bool(scrub_mirror))

    def calibrate_cache(self, idx: np.ndarray, mask: np.ndarray,
                        cache_rows: Optional[int] = None):
        """Build the hot-row cache from an observed (idx, mask) sample;
        ``cache_rows`` defaults to cfg.cache_rows."""
        rows = cache_rows if cache_rows is not None else self.cfg.cache_rows
        self.cache = hc_mod.build_from_batch(self.params["tables"], idx,
                                             mask, rows)
        self._staged_plan = None       # plan applicability may change
        return self.cache

    def adopt_cache(self, cache):
        """Swap in an externally built hot-row cache (None drops it)."""
        self.cache = cache
        self._staged_plan = None

    def _group(self):
        return self.group if self.group is not None \
            else mesh_mod.current_group()

    @property
    def pmap(self) -> "plc_mod.PartitionMap":
        """The live table placement; None inside means the identity boot
        layout (t_pad depends on the group, so it is made on demand)."""
        if self._pmap is None:
            _, t_pad, _, _ = self._exchange_geometry()
            return plc_mod.PartitionMap.identity(t_pad)
        return self._pmap

    def _table_inv(self):
        """The placement inverse the forward gathers through, or None: it
        rides whenever a migration is live or the map is not the
        identity."""
        live = self.reshard is not None and self.reshard.active
        if live or (self._pmap is not None and not self._pmap.is_identity):
            return self.pmap.inv_array()
        return None

    # -- stream plans off the critical path --------------------------------

    def _plan_fn(self, idx):
        return dlrm_mod.build_forward_plans(
            self.params, self.cfg, idx, microbatches=self.microbatches,
            cache=self.cache, exchange=self.exchange,
            ragged_cap=self.ragged_cap, row_block=self.row_block,
            group=self._group())

    def _build_plan(self, idx):
        """The batch's plans, built on the CPU inline and on the card on a
        side stream that the compute stream waits on through an event, so
        the build overlaps the work already queued."""
        if idx.device.type != "cuda":
            return self._plan_fn(idx)
        main = torch.cuda.current_stream(idx.device)
        side = _plan_stream(idx.device)
        side.wait_stream(main)                 # idx's upload
        with torch.cuda.stream(side):
            plan = self._plan_fn(idx)
            built = torch.cuda.Event()
            built.record()
        idx.record_stream(side)
        main.wait_event(built)
        return plan

    def stage_plan(self, idx_rows) -> bool:
        """Build the stream plans of a PROSPECTIVE batch before it is
        flushed: ``idx_rows`` are its per-request index rows (n <=
        batch_size, padded as :meth:`flush` pads).  The next pipelined
        flush whose batch matches adopts them (``plan_stage_hits``); a
        mismatch plans inline.  Returns True when plans were staged."""
        if not self.plan_pipeline:
            return False
        rows = list(idx_rows)
        if not rows or len(rows) > self.batch_size:
            return False
        i = np.stack(rows + [rows[-1]] * (self.batch_size - len(rows)))
        _, i, _ = self._fit_batch(None, i, np.zeros(i.shape, np.float32))
        (idx,) = self._upload(i)
        self._staged_plan = (i, self._build_plan(idx))
        return True

    # -- serving ------------------------------------------------------------

    def submit(self, dense: np.ndarray, idx: np.ndarray, mask: np.ndarray):
        """Queue one request (row).  Returns CTRs when a batch fills (the
        PREVIOUS batch's CTRs under ``plan_pipeline``)."""
        self._pending.append((dense, idx, mask))
        if len(self._pending) >= self.batch_size:
            return self.flush()
        return None

    def _upload(self, *arrays):
        """Host arrays to the engine's device.  Under ``plan_pipeline`` on
        the card they go through pinned memory without blocking the host."""
        quiet = self.plan_pipeline and self.device.type == "cuda"
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if quiet:
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=quiet))
        return tuple(out)

    def _dispatch(self, dense, idx, mask, plan=None, **riders):
        """One forward on the model group: (CTRs, diagnostics or None,
        the whole diagnostics with the riders' harvests or None), left
        where they were computed.  ``riders``: the forward's ``deltas``,
        ``migration``, ``repair``, ``quarantine``, ``wire_flip``,
        ``wire_check`` and ``audit_words``.  The diagnostics cost a re-probe of the misses:
        only when something reads them (drop monitoring under 'ragged',
        the autotuner under 'auto' with a cache, the degraded ledger) or
        when riders, which come back in them, ride the exchange."""
        diag_on = self.exchange == "ragged" or (
            self.exchange == "auto" and self.cache is not None) or \
            bool(self.degraded_members)
        want = diag_on or bool(riders)
        with torch.no_grad():
            res = dlrm_mod.forward_distributed(
                self.params, self.cfg, dense, idx, mask,
                bound=self.bound, microbatches=self.microbatches,
                cache=self.cache, wire_dtype=self.wire_dtype,
                exchange=self.exchange, ragged_cap=self.ragged_cap,
                exchange_pipeline=self.exchange_pipeline,
                row_block=self.row_block, pool_mode=self.pool_mode,
                plan=plan, table_inv=self._table_inv(), **riders,
                degraded_members=self.degraded_members,
                degraded_fallback=self.degraded_fallback,
                return_diag=want, group=self._group())
        logits, diag = res if want else (res, None)
        return (torch.sigmoid(logits), diag if diag_on else None,
                diag if want else None)

    def _agreed(self, seconds: float) -> float:
        """A lockstep flush takes its slowest member's time: with a
        deadline armed the members adopt the group's maximum, so each
        takes the same policy decision."""
        group = self._group()
        if self.deadline_s is None or group is None or \
                dist.get_world_size(group) == 1:
            return seconds
        t = torch.tensor([seconds], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return float(t.item())

    def _finish_batch(self, out, diag, n, t0, done_t=None, step_no=None):
        """Bring one batch's CTRs to the host and account for it.
        ``done_t`` (pipelined batches: when the card completed it)
        keeps the monitor observing dispatch-to-completion latency;
        ``total_s`` clips each interval at the previous batch's end."""
        out = out.cpu().numpy()                  # waits for the card
        end = done_t if done_t is not None else time.perf_counter()
        elapsed = self._agreed(end - t0)
        self.monitor.observe(elapsed)
        if diag is not None:
            self.cap_tuner.observe(int(diag.live_max), int(diag.drops))
            self.stats.approx_rows += int(diag.approx_rows)
        if self.degraded_members:
            self.stats.degraded_batches += 1
        self.stats.batches += 1
        self.stats.requests += n
        self.stats.total_s += end - max(t0, self._last_finish_t)
        self._last_finish_t = max(self._last_finish_t, end)
        if self.exchange == "auto" and \
                self.stats.batches % self.retune_every == 0:
            self.retune_cap()
        if step_no is not None:
            self._after_flush(step_no, elapsed)
            self.maybe_rebalance()
        return out[:n]

    def _harvest(self):
        """The in-flight batch of a pipelined flush, if any.  An error the
        watcher saw on the card surfaces here, with the batch's context,
        after the in-flight entry is cleared."""
        if self._inflight is None:
            return None
        out, diag, n, t0, watcher, done, step_no = self._inflight
        self._inflight = None
        if watcher is not None:
            watcher.join()
        if done["err"] is not None:
            err = done["err"]
            raise RuntimeError(
                f"pipelined step failed in flight (batch of {n} requests, "
                f"flush #{step_no}): {err!r}") from err
        done_t = done["t"]
        if done_t is None:
            # the start event ran when the card reached it: at t0, or at
            # the previous batch's completion if the card was still busy
            started, finished = done["events"]
            done_t = max(t0, self._last_finish_t) + \
                started.elapsed_time(finished) / 1e3
        return self._finish_batch(out, diag, n, t0, done_t,
                                  step_no=step_no)

    def flush(self):
        """Run the pending batch (padded with copies of its last request).
        Inline it returns its CTRs; under ``plan_pipeline`` the batch is
        dispatched and the previous one's CTRs are returned.  With nothing
        pending it harvests the batch in flight, if any, else None."""
        if not self._pending:
            return self._harvest()
        if self._evicted:
            raise Evicted("this process was evicted from the model group")
        n = len(self._pending)
        pad = self.batch_size - n
        d = np.stack([p[0] for p in self._pending] +
                     [self._pending[-1][0]] * pad)
        i = np.stack([p[1] for p in self._pending] +
                     [self._pending[-1][1]] * pad)
        m = np.stack([p[2] for p in self._pending] +
                     [self._pending[-1][2]] * pad)
        self._pending.clear()
        step_no = self._flushes
        self._flushes += 1
        t0 = time.perf_counter()
        if not self.plan_pipeline:
            out, diag = self._run_batch(d, i, m, step_no)
            return self._finish_batch(out, diag, n, t0, step_no=step_no)
        on_card = self.device.type == "cuda"
        if on_card:
            started = torch.cuda.Event(enable_timing=True)
            started.record()
        fd, fi, fm = self._fit_batch(d, i, m)
        dense, idx, mask = self._upload(fd, fi, fm)
        staged, self._staged_plan = self._staged_plan, None
        if staged is not None and staged[0].shape == fi.shape and \
                np.array_equal(staged[0], fi):
            plan = staged[1]
            self.plan_stage_hits += 1
        else:
            plan = self._build_plan(idx)
        out, diag, _ = self._dispatch(dense, idx, mask, plan)
        # a watcher synchronizes on the batch's completion off the main
        # thread (an error on the card surfaces at the harvest); the
        # latency is dispatch to completion on the card's clock, which a
        # thread waiting for the interpreter lock would stretch
        done = {"t": None, "err": None}
        watcher = None
        if on_card:
            finished = torch.cuda.Event(enable_timing=True)
            finished.record()

            def _watch(ev=finished, d=done):
                try:
                    ev.synchronize()
                except Exception as e:   # surfaces at the next harvest
                    d["err"] = e

            done["events"] = (started, finished)
            watcher = threading.Thread(target=_watch, daemon=True)
            watcher.start()
        else:
            done["t"] = time.perf_counter()
        prev = self._harvest()
        self._inflight = (out, diag, n, t0, watcher, done, step_no)
        return prev

    def drain(self):
        """Flush the pending queue and the pipeline: every CTR not yet
        returned (concatenated), or None when nothing is outstanding
        (idempotent)."""
        if not self._pending and self._inflight is None:
            return None
        outs = [o for o in (self.flush(), self._harvest()) if o is not None]
        return np.concatenate(outs) if outs else None

    def _run_batch(self, d, i, m, step_no):
        """Dispatch one batch under fault injection with bounded-retry
        eviction: a ``NodeFailure`` evicts the crashed member and the same
        batch is dispatched again on the survivors.  Between flushes, in
        order: the freshness apply, the scrubber's repair apply, the
        injected bit flips and the audit, then the reshard's cutover once
        every moved row is banked."""
        for attempt in range(self.max_retries + 1):
            try:
                fr, sc = self.freshness, self.scrub
                if fr is not None:
                    # the apply window sits BETWEEN flushes: rows harvested
                    # earlier commit (or roll back) before this batch goes
                    fr.apply(self, step_no)
                if sc is not None:
                    # repairs share the window, after the deltas (a delta
                    # that already overwrote a corruption wins); injected
                    # flips land before the audit, which must find them
                    sc.apply(self, step_no)
                    if self.faults is not None:
                        for (pos, t, r, b, tgt) in \
                                self.faults.bitflips(step_no):
                            self._inject_bitflip(pos, t, r, b, tgt, step_no)
                    for g in sc.audit(self, step_no):
                        fs = self._flip_log.pop(g, None)
                        if fs is not None:
                            self.stats.detection_lag_flushes = max(
                                self.stats.detection_lag_flushes,
                                step_no - fs)
                # the cutover sits between flushes too
                resh = self.reshard
                if resh is not None and resh.try_commit(self, step_no):
                    self._finish_cutover(resh)
                if self.faults is not None:
                    self.faults.on_flush(step_no, self._group(),
                                         exclude=self.degraded_members)
                fd, fi, fm = self._fit_batch(d, i, m)
                dense, idx, mask = self._upload(fd, fi, fm)
                riders = {}
                if fr is not None:
                    dw = fr.next_wire(self, step_no)
                    riders["deltas"] = dict(zip(DELTA_KEYS, self._upload(
                        *(dw[k] for k in DELTA_KEYS))))
                mig_live = self.reshard is not None and self.reshard.active
                if mig_live:
                    mw = self.reshard.next_wire(self, step_no)
                    riders["migration"] = dict(zip(MIG_KEYS, self._upload(
                        *(mw[k] for k in MIG_KEYS))))
                if sc is not None:
                    rw = sc.next_wire(self, step_no)
                    riders["repair"] = dict(zip(REP_KEYS, self._upload(
                        *(rw[k] for k in REP_KEYS))))
                    riders["quarantine"], riders["wire_flip"] = \
                        self._upload(sc.quarantine_phys(self),
                                     self._wire_flip_arg(step_no))
                    riders["wire_check"] = True
                    riders["audit_words"] = sc.audit_words
                out, diag, full = self._dispatch(dense, idx, mask, **riders)
                held_wbad = None
                if sc is not None:
                    # the wire flags bank one flush unread and are read at
                    # the END of the next flush (_note_wire may evict, and
                    # the accounting below must see this batch's geometry)
                    held_wbad, self._held_wbad = self._held_wbad, full.wbad
                    sc.bank_audit(full.audit)
                    sc.ingest(full.staged_rep, self, step_no)
                if mig_live:
                    self.reshard.ingest(full.staged_mig, self, step_no)
                if fr is not None:
                    fr.ingest(full.staged, self, step_no)
                    self.stats.rows_stale_served += \
                        fr.count_stale_served(self, idx, mask)
                    self.stats.rows_applied = fr.rows_applied
                    self.stats.delta_rejects = fr.delta_rejects
                    self.stats.apply_rollbacks = fr.rollbacks
                    self.stats.versions_behind = fr.ledger.versions_behind
                if sc is not None:
                    self.stats.blocks_scrubbed = sc.blocks_scrubbed
                    self.stats.detections = sc.detections
                    self.stats.repaired_rows = sc.repaired_rows
                    self.stats.quarantined_served += \
                        sc.count_quarantined_served(self, idx, mask)
                self._observe_load(fm, step_no)
                if held_wbad is not None:
                    self._note_wire(held_wbad, step_no)
                return out, diag
            except NodeFailure as e:
                if attempt >= self.max_retries:
                    raise
                if self.retry_backoff_s:
                    time.sleep(self.retry_backoff_s * (2 ** attempt))
                self.evict(e.surviving_ranks)
                self.stats.replays += 1
        raise AssertionError("unreachable")

    def _fit_batch(self, d, i, m):
        """Re-fit the sparse tensors to the group's table padding:
        t_pad = padded_tables(cfg, P), which changes with an eviction.
        Padding tables carry mask 0 and are never indexed, so cropping or
        zero-padding them is exact.  A non-identity placement then
        PERMUTES the table axis: physical column p serves original table
        perm[p]."""
        _, t_pad, _, _ = self._exchange_geometry()
        have = i.shape[1]
        if have > t_pad:
            i, m = i[:, :t_pad], m[:, :t_pad]
        elif have < t_pad:
            iz = np.zeros((i.shape[0], t_pad - have, i.shape[2]), i.dtype)
            mz = np.zeros((m.shape[0], t_pad - have, m.shape[2]), m.dtype)
            i = np.concatenate([i, iz], axis=1)
            m = np.concatenate([m, mz], axis=1)
        pm = self._pmap
        if pm is not None and not pm.is_identity:
            perm = pm.perm_array()
            i = np.take(i, perm, axis=1)
            m = np.take(m, perm, axis=1)
        return d, i, m

    # -- silent-corruption self-healing ------------------------------------

    def _wire_flip_arg(self, step_no):
        """The (P_src, P_dst) uint8 XOR hook the forward applies to the
        first payload byte of each fused slot: zeros (the identity) on a
        healthy group; the fault plan's wire corruptions set one byte,
        which the segment checksum catches (every byte weighs)."""
        p, _, _, _ = self._exchange_geometry()
        flip = np.zeros((p, p), np.uint8)
        if self.faults is not None:
            for (src, dst) in self.faults.wire_corruptions(step_no):
                if src < p and dst < p:
                    flip[src, dst] = 1
        return flip

    def _note_wire(self, wb, step_no):
        """Process one BANKED flush's wire flags ((P_dst, mb, P_src)):
        ledger the rejects and walk persistently corrupt SOURCES up the
        straggler ladder (a streak >= confirm_after degrades the member,
        >= 2x evicts it).  A rejected segment was zeroed at consume and
        the riders re-ship, so no request is lost to it.  Every member
        reads the same gathered flags and takes the same steps."""
        p, _, _, _ = self._exchange_geometry()
        arr = wb.cpu().numpy().reshape(-1)
        if arr.size % p:
            return                       # geometry changed under the bank
        per_src = arr.reshape(-1, p).sum(axis=0)
        self.stats.wire_rejects += int(per_src.sum())
        for q in range(p):
            if per_src[q]:
                streak = self._wire_streak.get(q, 0) + 1
                self._wire_streak[q] = streak
                if streak >= 2 * self.confirm_after:
                    self._wire_streak.pop(q, None)
                    self.evict_member(q)
                    return               # ranks renumbered: stop here
                if streak >= self.confirm_after and \
                        q not in self.degraded_members:
                    self.degrade(tuple(set(self.degraded_members) | {q}))
            else:
                self._wire_streak.pop(q, None)

    def _inject_bitflip(self, member, table, row, bit, target, step_no):
        """Flip ONE bit of a resident table row (``target='table'``) or of
        its hot-cache copy (``'cache'``) in the memory of the member at
        group position ``member``, IN PLACE: the fault plan's hook the
        scrubber must catch.  ``table``/``row`` are ORIGINAL-space; the
        live placement gives the physical slot.  Silent corruption hits
        one process, so only that member's copy changes; every member logs
        the flip (the detection lag is agreed, as the detection is) and,
        for a cache flip, swaps in a new cache object, as the reference's
        functional update does, so all drop the same stale slot audit."""
        pm = self._pmap
        phys_t = int(pm.inv_array()[table]) if pm is not None \
            and not pm.is_identity else int(table)
        group = self._group()
        mine = int(member) == (dist.get_rank(group) if group is not None
                               else 0)
        byte, bi = divmod(int(bit), 8)
        b = None
        if target == "cache":
            c = self.cache
            if c is None:
                return
            slot = int(c.slot_of[phys_t, row])
            if slot < 0:
                return                   # row not cached: nothing to flip
            if mine:
                b = c.hot_rows[phys_t, slot].view(torch.uint8)
            self.cache = hc_mod.HotCache(hot_ids=c.hot_ids,
                                         hot_rows=c.hot_rows,
                                         slot_of=c.slot_of)
        elif mine:
            b = self.params["tables"][phys_t, row].view(torch.uint8)
        if b is not None:
            k = byte % b.numel()
            b[k] = b[k] ^ (1 << bi)
        r_all = int(self.params["tables"].shape[1])
        self._flip_log[int(table) * r_all + int(row)] = step_no

    # -- skew-aware placement: telemetry, policy, online resharding --------

    def _observe_load(self, fm, step_no):
        """Per-table and per-member load telemetry from the flushed
        batch's live bags: the placement cost model's input and the
        ``ServeStats`` imbalance mirror.  ``fm`` is the FITTED (permuted)
        host mask, so physical-column counts map back to ORIGINAL table
        space before they feed the EWMA: observations survive cutovers."""
        p, t_pad, _, _ = self._exchange_geometry()
        live = (fm > 0).sum(axis=(0, 2)).astype(np.float64)
        pm = self._pmap
        if pm is not None and not pm.is_identity:
            orig = np.empty_like(live)
            orig[pm.perm_array()] = live
        else:
            orig = live
        if self.load_model is None or self.load_model.n_tables != t_pad:
            self.load_model = plc_mod.TableLoadModel(t_pad)
        wire = a2a_mod.canon_wire(self.wire_dtype)
        row_b = self.cfg.embed_dim * a2a_mod.WIRE_ITEMSIZE[wire] \
            + a2a_mod.WIRE_SCALE_BYTES[wire]
        self.load_model.observe(orig, row_bytes=row_b)
        # per-member pooled rows (physical slot ranges ARE the members)
        mrows = live.reshape(p, -1).sum(axis=1)
        if self._member_ewma is None or len(self._member_ewma) != p:
            self._member_ewma = mrows.copy()
        else:
            self._member_ewma = 0.75 * self._member_ewma + 0.25 * mrows
        st = self.stats
        st.member_rows = [float(x) for x in self._member_ewma]
        st.member_bytes = [
            float(a2a_mod.dispatch_stats(
                np.asarray([c]), int(np.ceil(max(float(c), 1.0))),
                row_b).useful_bytes)
            for c in self._member_ewma]
        st.imbalance_ratio = plc_mod.imbalance(self._member_ewma)
        if self.faults is not None:
            base = self.monitor.percentile(0.5) or 1e-3
            lats = np.asarray(sorted(
                self.faults.latencies(step_no, base).values()), np.float64)
            st.flush_time_ratio = float(lats.max() / lats.mean()) \
                if lats.size and lats.mean() > 0 else 1.0
        else:
            # lockstep members give no per-member clock: the exchange
            # load ratio is the best flush-time estimate available
            st.flush_time_ratio = st.imbalance_ratio

    def _table_rows(self, t_pad):
        """Real (unpadded) per-original-table row counts over the padded
        stack: what a migration of each table ships."""
        rows = np.zeros(t_pad, np.int64)
        sizes = np.asarray(self.cfg.table_sizes, np.int64)[:t_pad]
        rows[:sizes.shape[0]] = sizes
        return rows

    def maybe_rebalance(self, *, force=False):
        """The background rebalance policy, once per harvested batch:
        start an online reshard when per-member imbalance stayed over
        ``rebalance_threshold`` for ``rebalance_patience`` flushes, or at
        once after an eviction re-leveled the geometry.  Pauses while a
        frontend's ladder is off FULL.  Returns the started
        :class:`ReshardExecutor`, or None (always at P < 2)."""
        if self.plan_pipeline or (not self.rebalance and not force):
            return None
        if self.reshard is not None:
            return None
        lm = self.load_model
        if lm is None or not lm.ready:
            return None
        if getattr(self.stats, "level", 0) > 0:   # LEVEL_FULL only
            return None
        p, t_pad, _, _ = self._exchange_geometry()
        if p < 2:
            return None
        ml = plc_mod.member_loads(lm.loads, self.pmap, p)
        imb = plc_mod.imbalance(ml)
        if not (force or self._rebalance_pending):
            if imb < self.rebalance_threshold:
                self._imb_streak = 0
                return None
            self._imb_streak += 1
            if self._imb_streak < self.rebalance_patience:
                return None
        plan = plc_mod.plan_migration(
            self.pmap, lm.loads, p, table_rows=self._table_rows(t_pad))
        self._imb_streak = 0
        self._rebalance_pending = False
        if plan.is_noop:
            return None
        return self.start_reshard(plan)

    def start_reshard(self, plan, *, slice_cap=None):
        """Begin a crash-safe online reshard onto ``plan``: the moved rows
        ride the exchange in ``slice_cap``-row installments while serving
        continues bit-exact on the old layout; a later flush cuts over
        once every row is banked and verified, and any crash before rolls
        back through :meth:`evict`."""
        if self.plan_pipeline:
            raise ValueError(
                "online resharding migrates rows through the synchronous "
                "flush path; plan_pipeline's deferred harvest would tear "
                "the cutover boundary — rebalance without plan_pipeline")
        if self.reshard is not None:
            raise ValueError("a reshard is already in flight")
        if self.params["tables"].shape[0] != self._exchange_geometry()[1]:
            raise ValueError("a reshard rebuilds the whole (T_pad, R, s) "
                             "stack; the engine holds one member's shard")
        self._reshard_epoch += 1
        ex = ReshardExecutor(plan, epoch=self._reshard_epoch,
                             slice_cap=slice_cap or self.mig_slice_cap)
        ex.start(self)
        self.reshard = ex
        return ex

    def _finish_cutover(self, resh):
        """After the commit the layout changed: every layout-conditioned
        estimator restarts (the autotuner's live-count window and the
        monitor's latency window describe skew that no longer exists; a
        frontend's flush estimate resets on ``layout_version``)."""
        self.stats.reshards += 1
        self.stats.migrated_rows += resh.plan.moved_rows
        self.reshard = None
        self.layout_version += 1
        self.cap_tuner.reset()
        self.monitor.reset()
        self._staged_plan = None
        self._imb_streak = 0

    # -- chaos: deadline policy, degraded serving, eviction ----------------

    def _after_flush(self, step_no, elapsed):
        """Deadline policy.  Members that ``detect_stragglers`` flags for
        ``confirm_after`` CONSECUTIVE breaching flushes are sustained
        stragglers, which no bound masks: degrade or evict them per
        ``on_deadline``.  Any other breach is transient: raise the bound
        toward :meth:`recommend_bound`."""
        if self.deadline_s is None:
            return
        if elapsed <= self.deadline_s:
            self._streak.clear()
            return
        self.stats.deadline_breaches += 1
        if self.on_deadline == "block":
            return
        confirmed = self._confirmed_stragglers(step_no, elapsed)
        if not confirmed:
            rec = self.recommend_bound()
            k = min(rec.bound, max(self.microbatches - 1, 0))
            if k > self.bound:
                self.set_bound(k)
            return
        if self.on_deadline == "degrade":
            self.degrade(tuple(set(self.degraded_members) | set(confirmed)))
        else:
            worst = max(confirmed, key=lambda h: self._streak.get(h, 0))
            self.evict_member(worst)

    def _confirmed_stragglers(self, step_no, elapsed):
        """Per-member latency telemetry (synthesized by the injector) ->
        ``detect_stragglers`` -> streaks; the members confirmed."""
        if self.faults is None:
            return []
        base = self.monitor.percentile(0.5) or max(elapsed, 1e-6)
        flagged = detect_stragglers(self.faults.latencies(step_no, base))
        for h in flagged:
            self._streak[h] = self._streak.get(h, 0) + 1
        for h in list(self._streak):
            if h not in flagged:
                del self._streak[h]
        return [h for h in flagged
                if self._streak[h] >= self.confirm_after]

    def set_bound(self, bound: int):
        """Adopt a new BLS bound from the next flush on."""
        self.bound = int(bound)

    def degrade(self, members):
        """Serve around the given group ranks: their chunks are masked on
        receipt and their tables' bags fall back per
        ``degraded_fallback``; the fault injector stops waiting on them.
        Pass () to serve exactly again."""
        self.degraded_members = tuple(sorted({int(x) for x in members}))

    def evict_member(self, pos: int):
        """Evict the member at group rank ``pos``: :meth:`evict` rebuilds
        the group on the others, and the fault injector retires it."""
        group = self._group()
        if group is None:
            raise ValueError("evict_member needs a model group")
        keep = [r for j, r in enumerate(elastic.group_ranks(group))
                if j != pos]
        if not keep:
            raise ValueError("cannot evict the last member")
        if self.faults is not None and pos < len(self.faults.live):
            orig = self.faults.live[pos]
            self.faults.fired.add(orig)
            self.faults.live.remove(orig)
        self.evict(keep)

    def evict(self, survivors):
        """Recover onto the global ranks ``survivors``: a new model group
        over them becomes the engine's own, the table stack and the cache
        are refit to ``padded_tables(cfg, P')``, and the degraded state,
        the streaks, the autotuner and the monitor start afresh.  Every
        process of the default group must call this (the group's creation
        is collective); one outside ``survivors`` raises ``Evicted`` and
        serves no more.  The wall time goes to ``ServeStats.recovery_s``.
        The engine must hold the whole (T_pad, R, s) stack: from its own
        shard it could not rebuild the lost member's tables.

        A reshard in flight is aborted (rollback is the absence of its
        commit), recovery CANONICALIZES the placement to the identity
        layout, the cache is cold-invalidated if a reshard was in flight
        (a crash between the commit's two swaps leaves tables and cache in
        different orders), and a rebalance on the shrunken group becomes
        mandatory."""
        if not survivors:
            raise ValueError("evict: no surviving members")
        t_rec = time.perf_counter()
        resh, self.reshard = self.reshard, None
        if resh is not None:
            resh.abort()
            self.stats.reshard_aborts += 1
        survivors = sorted(int(r) for r in survivors)
        p_new = len(survivors)
        if self.batch_size % (self.microbatches * p_new):
            raise ValueError(
                f"batch_size {self.batch_size} does not divide the post-"
                f"eviction geometry (microbatches {self.microbatches} x "
                f"members {p_new})")
        _, t_pad_old, _, _ = self._exchange_geometry()
        tables = self.params["tables"]
        if tables.shape[0] != t_pad_old:
            raise ValueError(
                f"evict: the engine holds {tables.shape[0]} of "
                f"{t_pad_old} tables, its own shard; the lost member's "
                f"tables cannot be recovered from it — serve with the "
                f"whole (T_pad, R, s) stack to recover by eviction")
        group = elastic.make_group_from(survivors)
        if dist.get_rank() not in survivors:
            self._evicted = True
            raise Evicted(f"rank {dist.get_rank()} was evicted from the "
                          f"model group")
        t_pad = dlrm_mod.padded_tables(self.cfg, p_new)
        # undo the live permutation FIRST: the crop assumes original
        # order, and under a placement a real table can sit in a high slot
        pm = self._pmap
        inv = None if pm is None or pm.is_identity else \
            torch.from_numpy(pm.inv_array().astype(np.int64)).to(
                tables.device)

        def canon(a):
            return a[inv] if inv is not None else a

        self.params = dict(self.params,
                           tables=_fit_tables(canon(tables), t_pad))
        c = self.cache
        if c is not None:
            if resh is not None:
                # mid-cutover the cache's order is untrustworthy: cold
                # start it, every slot a miss, warmed back by serving
                c = hc_mod.cold(c)
            else:
                c = hc_mod.HotCache(
                    hot_ids=None if c.hot_ids is None else canon(c.hot_ids),
                    hot_rows=canon(c.hot_rows), slot_of=canon(c.slot_of))
            self.cache = hc_mod.HotCache(
                hot_ids=None if c.hot_ids is None
                else _fit_tables(c.hot_ids, t_pad,
                                 fill=-1 if resh is not None else 0),
                hot_rows=_fit_tables(c.hot_rows, t_pad),
                # -1 = miss: resurrected padding tables stay cold
                slot_of=_fit_tables(c.slot_of, t_pad, fill=-1))
        self.group = group
        self.degraded_members = ()     # ranks renumbered: start clean
        self._streak.clear()
        self._staged_plan = None
        # the identity boot layout; every layout-conditioned estimator
        # recalibrates and a rebalance on the new geometry is mandatory
        self._pmap = None
        self.layout_version += 1
        self.load_model = None
        self._member_ewma = None
        self._imb_streak = 0
        self._rebalance_pending = True
        self.cap_tuner.reset()
        self.monitor.reset()
        if self.freshness is not None:
            # uncommitted delta rows queue again; their owners follow the
            # new geometry at the next ship
            self.freshness.on_evict(self)
        if self.scrub is not None:
            # in-flight repairs queue again against the refit mirror; the
            # banked wire flags describe the old geometry
            self.scrub.on_evict(self)
            self._held_wbad = None
            self._wire_streak.clear()
        self.stats.evictions += 1
        self.stats.recovery_s += time.perf_counter() - t_rec

    # -- ragged-exchange cap autotuning ------------------------------------

    def _exchange_geometry(self):
        """(P, t_pad, bs, dense_rows): bs is the per-(member, microbatch)
        batch slice and dense_rows = bs·t_loc what the exchange moves per
        destination."""
        group = self._group()
        p = dist.get_world_size(group) if group is not None else 1
        t_pad = dlrm_mod.padded_tables(self.cfg, p)
        bs = max(1, self.batch_size // (self.microbatches * p))
        return p, t_pad, bs, bs * (t_pad // p)

    def retune_cap(self):
        """Under ``exchange='auto'``: adopt the autotuner's cap: growth
        (drops seen, or the live tail drifted up) at once, a shrink only
        past 25%.  Each adoption counts in ``stats.retunes`` and serves
        from the next flush.  Under a forced exchange this only reads a
        peeked recommendation.  Returns the recommendation, or None before
        any observation."""
        if not len(self.cap_tuner):
            return None
        _, _, _, dense_rows = self._exchange_geometry()
        cur = self.ragged_cap or dense_rows
        rec = self.cap_tuner.recommend(dense_rows=dense_rows,
                                       current_cap=self.ragged_cap or None,
                                       peek=self.exchange != "auto")
        if self.exchange != "auto":
            return rec
        grow = rec.cap > cur
        shrink = rec.cap * 4 <= cur * 3
        if grow or shrink:
            self.ragged_cap = rec.cap
            self.stats.retunes += 1
            self._staged_plan = None   # the exchange may now be ragged
        return rec

    def slot_bytes(self) -> int:
        """Bytes ONE BLS ring slot buffers: the fused (P, slot_bytes) uint8
        buffer of the exchange the engine resolves to (dense or ragged, at
        its codec, with the ``xdelta`` rows under ``freshness``), the
        buffered bottom-MLP activations and, with a cache, the (bs, t_pad,
        s) pooled hits.  The ``xmig`` rows count while a reshard ships,
        the ``xrep`` rows and the ``wcs`` word with a scrubber."""
        p, t_pad, bs, dense_rows = self._exchange_geometry()
        s = self.cfg.embed_dim
        emb_dtype = self.params["tables"].dtype
        use_cache = self.cache is not None and self.cache.cache_rows > 0
        use_ragged, cap = dlrm_mod.resolve_exchange(
            self.exchange, use_cache=use_cache, cap=self.ragged_cap,
            dense_rows=dense_rows)
        delta_bytes = mig_bytes = rep_bytes = 0
        if self.freshness is not None:
            delta_bytes = a2a_mod.delta_wire_layout(
                p, self.freshness.slice_cap, s, emb_dtype).slot_bytes
        if self.reshard is not None and self.reshard.active:
            mig_bytes = a2a_mod.mig_wire_layout(
                p, self.reshard.slice_cap, s, emb_dtype).slot_bytes
        if self.scrub is not None:
            rep_bytes = a2a_mod.rep_wire_layout(
                p, self.scrub.slice_cap, s, emb_dtype).slot_bytes
        layout = a2a_mod.exchange_wire_layout(
            ragged=use_ragged, n_dest=p, cap=cap, bs=bs, t_loc=t_pad // p,
            embed_dim=s, wire_dtype=self.wire_dtype, emb_dtype=emb_dtype,
            delta_bytes=delta_bytes, mig_bytes=mig_bytes,
            rep_bytes=rep_bytes, wire_check=self.scrub is not None)
        recv = torch.empty((p, layout.slot_bytes), dtype=torch.uint8,
                           device="meta")
        side = [torch.empty((bs, s), dtype=L.dtype_of(self.cfg.dtype),
                            device="meta")]
        if use_cache:
            side.append(torch.empty((bs, t_pad, s), dtype=emb_dtype,
                                    device="meta"))
        return bls_mod.ring_slot_bytes(recv, side)

    def recommend_bound(self, memory_budget: int = 64 << 20):
        """Memory-budget -> bound recommendation, sized by
        :meth:`slot_bytes`."""
        return self.monitor.recommend_bound(slot_bytes=self.slot_bytes(),
                                            memory_budget=memory_budget)


class LMEngine:
    """Batched greedy decoding for the LM families the port runs: the dense,
    MoE and VLM families prefill the prompts into a cache of ``max_len``
    positions (a VLM its text prompts only: the reference's engine passes
    no patches), the recurrent one (rwkv6), the hybrid one (zamba2) and the
    encoder-decoder one (whisper, with zero cross K/V, as the reference's
    engine runs it) consume them token by token through ``decode_step``,
    as the reference does; then one serve step per token, each step's
    latency observed by the straggler monitor."""

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 256,
                 device="cuda"):
        api.check_ported(cfg)
        self.device = resolve_device(device)
        leaf = params["embed"]["table"]
        if leaf.device != self.device:
            raise ValueError(f"parameters are on {leaf.device}, the engine "
                             f"serves on {self.device}")
        self.params, self.cfg, self.max_len = params, cfg, max_len
        self._serve = steps_mod.make_serve_step(cfg)
        self.monitor = StragglerMonitor()

    def generate(self, prompts: np.ndarray, n_tokens: int) -> np.ndarray:
        """prompts: (B, P) int32 -> (B, n_tokens) greedy continuation.  As
        in the reference, the first serve step feeds the prompt's last token
        again, at position P.  A step's latency ends when its tokens reach
        the host."""
        dev = self.device
        b, p = prompts.shape
        with torch.no_grad():
            if self.cfg.family in ("dense", "moe", "vlm"):
                _, cache = T.prefill(self.params, self.cfg,
                                     torch.from_numpy(prompts).to(dev),
                                     pad_to=self.max_len)
            else:
                cache = api.make_cache(self.cfg, b, self.max_len, device=dev)
                toks = torch.from_numpy(prompts).to(dev)
                for t in range(p):
                    _, cache = api.decode_step(self.params, self.cfg,
                                               toks[:, t:t + 1], cache)
        tok = torch.from_numpy(np.ascontiguousarray(prompts[:, -1:])).to(dev)
        outs = []
        for _ in range(n_tokens):
            t0 = time.perf_counter()
            tok, cache = self._serve(self.params, tok, cache)
            host = tok.cpu().numpy()
            self.monitor.observe(time.perf_counter() - t0)
            outs.append(host)
        return np.concatenate(outs, axis=1)
